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
package imports no JAX and nothing of the JAX package. Its names are
imported on first use, so that a loaded artifact (export_aot.py) imports
only the modules it runs.
"""

import importlib

# name -> the submodule that defines it; imported on first access (PEP 562),
# so that a process that imports only some submodules (a loaded artifact,
# export_aot.py, which must not import the ONNX codec, the graph or the op
# registry) does not import the rest
_LAZY = {
    "onnx_io": None,
    "onnx_make_inference": "api",
    "Engine": "engine",
    "InferenceResult": "engine",
    "lower": "engine",
    "Graph": "graph",
    "import_model": "graph",
    "import_onnx": "graph",
    "build_mobilenetv2": "models",
    "build_resnet50": "models",
    "build_squeezenet": "models",
    "build_vit": "models",
    "QuantConfig": "quant",
    "calibrate": "quant",
    "quantize_graph": "quant",
}

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


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_LAZY[name] or name}", __name__)
    value = module if _LAZY[name] is None else getattr(module, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
