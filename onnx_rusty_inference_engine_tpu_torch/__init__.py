"""ONNX inference in PyTorch on an NVIDIA H100: the port of
`onnx_rusty_inference_engine_tpu` (JAX on a TPU).

ONNX bytes are parsed and imported into the same graph IR as the JAX
package's, run node by node on one device, and quantized to INT8 with the
same transform; int8 convolutions run on a hand-written Hopper kernel
(ops/kernels/qconv_int8.py, csrc/qconv_int8.cu). This package imports no
JAX and nothing of the JAX package.
"""

from . import onnx_io
from .engine import Engine, InferenceResult, lower
from .graph import Graph, import_model, import_onnx
from .models import build_squeezenet
from .quant import QuantConfig, calibrate, quantize_graph

__all__ = [
    "onnx_io",
    "Graph",
    "import_model",
    "import_onnx",
    "Engine",
    "InferenceResult",
    "lower",
    "quantize_graph",
    "calibrate",
    "QuantConfig",
    "build_squeezenet",
]
