"""Model builders: ONNX ModelProtos synthesized offline with seeded weights."""

from .squeezenet import build_squeezenet  # noqa: F401
