"""Model builders: ONNX ModelProtos synthesized offline with seeded weights
(SqueezeNet, ResNet-50, MobileNetV2, ViT, UNet, the audio encoder, the
SSD detection head, BERT, GPT-2, Llama, the MoE decoder, T5 and the
Whisper-style ASR model), the zoo that names them (`get_model_path`), the
decoder-family registry that generate.Generator and serving.DecodeServer
build their graphs through, and the seq2seq-family registry of
generate.Seq2SeqGenerator."""

import dataclasses as _dc

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
from .moe import MoEConfig, build_moe, build_moe_decode  # noqa: F401
from .t5 import T5Config, build_t5_decode, build_t5_encoder  # noqa: F401
from .asr import ASRConfig, build_asr_decode, build_asr_encoder  # noqa: F401
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
    presents with per-slot positions (continuous-batching-ready)."""
    if name in _CUSTOM_DECODERS:
        return _CUSTOM_DECODERS[name]
    if name == "gpt2":
        return build_gpt2, build_gpt2_decode, True
    if name == "llama":
        return build_llama, build_llama_decode, True
    if name == "moe":
        return build_moe, build_moe_decode, True
    raise KeyError(f"unknown decoder family {name!r}; have gpt2, llama, "
                   f"moe{''.join(', ' + k for k in _CUSTOM_DECODERS)}")


@_dc.dataclass(frozen=True)
class Seq2SeqSpec:
    """Encoder-decoder family descriptor consumed by
    generate.Seq2SeqGenerator:

    - build_encoder(cfg, batch=, src_len=, seed=) -> ModelProto emitting
      enc_out + cross_key_i/cross_value_i;
    - build_decode(cfg, batch=, max_len=, src_len=S, seed=, kv_dtype=)
      with the per-slot `pos [B]` fixed-cache contract;
    - enc_input: the encoder's source input name;
    - prompt_dtype: dtype of one request's source (int64 tokens / f32
      waveform); sources are right-padded with zeros to src_len;
    - enc_len(cfg, src_len): cross-attention length S the decode graph
      sees (identity for token models; frontend frame count for audio);
    - n_layers(cfg): decoder layer count (cache tensors per layer);
    - src_mask: True when both graphs take a `src_len [B]` input that
      masks source padding out of (cross-)attention.
    """

    name: str
    build_encoder: object
    build_decode: object
    enc_input: str
    prompt_dtype: object
    enc_len: object
    n_layers: object
    src_mask: bool


def seq2seq_family(name: str) -> Seq2SeqSpec:
    import numpy as _np

    if name == "t5":
        return Seq2SeqSpec(
            name="t5", build_encoder=build_t5_encoder,
            build_decode=build_t5_decode, enc_input="src_ids",
            prompt_dtype=_np.int64, enc_len=lambda cfg, s: s,
            n_layers=lambda cfg: cfg.n_layer, src_mask=True)
    if name == "asr":
        from .asr import enc_frames

        def build_enc(cfg, *, batch, src_len, seed, **kw):
            return build_asr_encoder(cfg, batch=batch, n_samples=src_len,
                                     seed=seed, **kw)

        return Seq2SeqSpec(
            name="asr", build_encoder=build_enc,
            build_decode=build_asr_decode, enc_input="audio",
            prompt_dtype=_np.float32, enc_len=enc_frames,
            n_layers=lambda cfg: cfg.n_dec_layer, src_mask=False)
    raise KeyError(f"unknown seq2seq family {name!r}; have t5, asr")
