"""Model zoo: resolve a model name to an on-disk .onnx path.

The port's copy of onnx_rusty_inference_engine_tpu/models/zoo.py for the
families the port has. Models the repository does not ship are synthesized
on first use with seeded weights and cached under `assets/torch/` (git
ignores `assets/`), a directory of the port's own, so the two packages never
share a file. The zoo reads nothing outside this checkout: `mnist` and
`matmul_2d` are files the repository does not ship yet, so they raise
FileNotFoundError until they are in it. Every other name of the JAX zoo is
synthesized here, byte for byte as the JAX builder makes it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from .. import onnx_io

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_ASSETS = os.path.join(_REPO, "assets", "torch")

# models whose files the repository does not ship yet
NOT_SHIPPED = {"mnist": "mnist-8.onnx", "matmul_2d": "model.onnx"}
# families of the JAX zoo that the port has no builder for: none is left
NOT_PORTED = ()


def _synth(name: str, build: Callable) -> str:
    os.makedirs(_ASSETS, exist_ok=True)
    path = os.path.join(_ASSETS, f"{name}.onnx")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        onnx_io.save_model(tmp, build())
        os.replace(tmp, path)  # a concurrent reader never sees half a file
    return path


def _squeezenet_path() -> str:
    from .squeezenet import build_squeezenet

    return _synth("squeezenet1.0-8.synth", build_squeezenet)


def _resnet50_path() -> str:
    from .resnet import build_resnet50

    return _synth("resnet50.synth", build_resnet50)


def _mobilenetv2_path() -> str:
    from .mobilenet import build_mobilenetv2

    return _synth("mobilenetv2.synth", build_mobilenetv2)


def _bert_path() -> str:
    from .bert import TINY, build_bert

    return _synth("bert-tiny.synth",
                  lambda: build_bert(TINY, batch=1, seq_len=16))


def _vit_path() -> str:
    from .vit import TINY, build_vit

    return _synth("vit-tiny.synth", lambda: build_vit(TINY))


def _unet_path() -> str:
    from .unet import TINY, build_unet

    return _synth("unet-tiny.synth", lambda: build_unet(TINY))


def _audio_path() -> str:
    from .audio import TINY, build_audio_encoder

    return _synth("audio-encoder-tiny.synth",
                  lambda: build_audio_encoder(TINY, batch=1,
                                              n_samples=1024))


def _detection_path() -> str:
    from .detection import TINY, build_detection

    return _synth("detection-ssd.synth",
                  lambda: build_detection(TINY, batch=1))


def _llama_path() -> str:
    from .llama import TINY, build_llama

    return _synth("llama-tiny.synth",
                  lambda: build_llama(TINY, batch=1, seq_len=16,
                                      with_presents=False))


def _gpt2_path() -> str:
    from .gpt2 import SMALL, build_gpt2

    return _synth("gpt2-prefill.synth",
                  lambda: build_gpt2(SMALL, batch=1, seq_len=64,
                                     with_presents=False))


def _t5_encoder_path() -> str:
    from .t5 import TINY, build_t5_encoder

    return _synth("t5-tiny-encoder.synth",
                  lambda: build_t5_encoder(TINY, batch=1, src_len=16))


def _moe_path() -> str:
    from .moe import TINY, build_moe

    return _synth("moe-tiny.synth",
                  lambda: build_moe(TINY, batch=1, seq_len=16))


def _asr_encoder_path() -> str:
    from .asr import TINY, build_asr_encoder

    return _synth("asr-encoder.synth",
                  lambda: build_asr_encoder(TINY, batch=1, n_samples=512))


def _not_shipped(name: str) -> Callable[[], str]:
    def path() -> str:
        raise FileNotFoundError(
            f"model {name!r} ({NOT_SHIPPED[name]}) is not in the repository; "
            f"it is available once its file is committed")
    return path


MODELS: Dict[str, Callable[[], str]] = {
    **{name: _not_shipped(name) for name in NOT_SHIPPED},
    "squeezenet": _squeezenet_path,
    "resnet50": _resnet50_path,
    "mobilenetv2": _mobilenetv2_path,
    "bert": _bert_path,
    "vit": _vit_path,
    "unet": _unet_path,
    "audio_encoder": _audio_path,
    "detection": _detection_path,
    "llama": _llama_path,
    "gpt2": _gpt2_path,
    "t5_encoder": _t5_encoder_path,
    "moe": _moe_path,
    "asr_encoder": _asr_encoder_path,
}


def get_model_path(name: str) -> str:
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name]()
