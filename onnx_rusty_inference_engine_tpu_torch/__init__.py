"""ONNX inference in PyTorch on an NVIDIA H100: the port of
`onnx_rusty_inference_engine_tpu` (JAX on a TPU).

ONNX bytes are parsed and imported into the same graph IR as the JAX
package's, run node by node on one device (each input signature captured
as one CUDA graph on the card), and quantized to INT8 or INT4 with the same
transforms; the int8 and int4 products, convolutions (grouped ones
included) and decode attention run on hand-written Hopper kernels
(ops/kernels/, csrc/). Model builders for SqueezeNet, ResNet-50,
MobileNetV2, ViT, BERT, GPT-2 and Llama (models/), servers (serve.py,
serving/, http_serve.py), `onnx_make_inference` (api.py) and a CLI
(`python -m onnx_rusty_inference_engine_tpu_torch.cli`) sit on top. This
package imports no JAX and nothing of the JAX package.
"""

from . import onnx_io
from .api import onnx_make_inference
from .engine import Engine, InferenceResult, lower
from .graph import Graph, import_model, import_onnx
from .models import (build_mobilenetv2, build_resnet50, build_squeezenet,
                     build_vit)
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
    "onnx_make_inference",
    "build_squeezenet",
    "build_resnet50",
    "build_mobilenetv2",
    "build_vit",
]
