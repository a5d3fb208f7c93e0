"""Model builders: ONNX ModelProtos synthesized offline with seeded weights."""

from .squeezenet import build_squeezenet  # noqa: F401
from .gpt2 import GPT2Config, build_gpt2, build_gpt2_decode  # noqa: F401
from .bert import BertConfig, build_bert  # noqa: F401


def decoder_family(name: str):
    """(build_prefill, build_decode, supports_int8_kv) for a decoder family:
    prefill(input_ids [B,T]) -> logits + presents; decode(input_ids [B,1],
    pos [B], past_*) -> logits + presents with per-slot positions. Only
    gpt2 is ported; llama, moe and custom families are ROADMAP 1.8."""
    if name == "gpt2":
        return build_gpt2, build_gpt2_decode, True
    raise NotImplementedError(
        f"decoder family {name!r} is not ported yet (ROADMAP 1.8); the port "
        f"has gpt2")
