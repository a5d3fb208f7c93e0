"""ONNX op emitters; importing this package fills the registry."""

from . import quantized, standard  # noqa: F401
