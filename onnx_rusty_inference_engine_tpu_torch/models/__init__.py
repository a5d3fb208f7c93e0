"""Model builders: ONNX ModelProtos synthesized offline with seeded weights
(SqueezeNet, ResNet-50, MobileNetV2, ViT, UNet, the audio encoder, the
SSD detection head, BERT, GPT-2, Llama), the zoo that
names them (`get_model_path`), and the decoder-family registry that
generate.Generator and serving.DecodeServer build their graphs through."""

from .squeezenet import build_squeezenet  # noqa: F401
from .resnet import build_resnet50  # noqa: F401
from .mobilenet import build_mobilenetv2  # noqa: F401
from .vit import ViTConfig, build_vit  # noqa: F401
from .unet import UNetConfig, build_unet  # noqa: F401
from .audio import AudioEncoderConfig, build_audio_encoder  # noqa: F401
from .detection import DetectionConfig, build_detection  # noqa: F401
from .gpt2 import GPT2Config, build_gpt2, build_gpt2_decode  # noqa: F401
from .bert import BertConfig, build_bert  # noqa: F401
from .llama import LlamaConfig, build_llama, build_llama_decode  # noqa: F401
from ._builder import host_memo  # noqa: F401
from .zoo import MODELS, get_model_path  # noqa: F401

_CUSTOM_DECODERS: dict = {}


def register_decoder_family(name: str, build_prefill, build_decode,
                            int8_kv_ok: bool = False) -> None:
    """Plug an external decoder family into the drivers (Generator,
    DecodeServer). Builders must follow the decoder_family contract below;
    `custom_decoder.onnx_decoder_family` creates them from ONNX files (with
    optional tensor renaming)."""
    if name in ("gpt2", "llama", "moe"):
        raise ValueError(f"cannot override built-in family {name!r}")
    _CUSTOM_DECODERS[name] = (build_prefill, build_decode, bool(int8_kv_ok))


def decoder_family(name: str):
    """(build_prefill, build_decode, supports_int8_kv) for a decoder family.

    Every family shares the driver contract: prefill(input_ids [B,T]) ->
    logits + presents; decode(input_ids [B,1], pos [B], past_*) -> logits +
    presents with per-slot positions (continuous-batching-ready). moe is
    not ported yet (ROADMAP 1.8)."""
    if name in _CUSTOM_DECODERS:
        return _CUSTOM_DECODERS[name]
    if name == "gpt2":
        return build_gpt2, build_gpt2_decode, True
    if name == "llama":
        return build_llama, build_llama_decode, True
    if name == "moe":
        raise NotImplementedError(
            "decoder family 'moe' is not ported yet (ROADMAP 1.8); the port "
            "has gpt2 and llama")
    raise KeyError(f"unknown decoder family {name!r}; have gpt2, llama, "
                   f"moe{''.join(', ' + k for k in _CUSTOM_DECODERS)}")
