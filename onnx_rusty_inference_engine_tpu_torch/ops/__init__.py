"""ONNX op emitters; importing this package fills the registry."""

from . import fused, quantized, standard  # noqa: F401
