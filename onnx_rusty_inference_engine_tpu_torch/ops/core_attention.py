"""Core-domain (ai.onnx) Attention and RotaryEmbedding, opset 23 ->
PyTorch.

The port's counterpart of
onnx_rusty_inference_engine_tpu/ops/core_attention.py. The core Attention
takes separate Q / K / V (3-D with q_num_heads / kv_num_heads, or 4-D),
grouped-query head counts, past_key / past_value with present_* outputs,
a boolean or additive mask, is_causal (upper-left aligned), a tanh
softcap and the staged qk_matmul_output (qk_matmul_output_mode 0-3). The
core RotaryEmbedding has its caches at inputs 1 and 2 and position_ids
optional at input 3, and takes a partial rotary dim.

Bare nodes (exporters often leave the domain out) go to the contrib
forms where they are that: a contrib Attention has the num_heads
attribute; a contrib RotaryEmbedding has integer position_ids at input 1.
"""

from __future__ import annotations

import math

import torch

from ..graph import Node
from ..utils.fp32 import matmul_fp32_exact
from .contrib_transformers import _heads, _merge, _rope_rotate
from .contrib_transformers import attention as ms_attention
from .contrib_transformers import rotary_embedding as ms_rope
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import repeat_each

# -1e9 and not -inf: a fully masked row stays free of NaN
_NEG = -1e9


@register("Attention")
def attention_core(ctx: LoweringContext, node: Node, ins):
    if node.attr("num_heads") is not None:
        return ms_attention(ctx, node, ins)
    q, k, v = ins[0], ins[1], ins[2]
    attn_mask = ins[3] if len(ins) > 3 else None
    past_k = ins[4] if len(ins) > 4 else None
    past_v = ins[5] if len(ins) > 5 else None
    mode = int(node.attr("qk_matmul_output_mode", 0))
    softcap = float(node.attr("softcap", 0.0))
    scale = node.attr("scale")
    three_d = q.dim() == 3
    if three_d:
        Hq = int(node.attr("q_num_heads", 0))
        Hkv = int(node.attr("kv_num_heads", 0))
        if not Hq or not Hkv:
            raise UnsupportedOpError(
                "Attention: q_num_heads/kv_num_heads attributes are "
                "required for 3-D inputs")
        q, k, v = _heads(q, Hq), _heads(k, Hkv), _heads(v, Hkv)
    else:
        Hq, Hkv = q.shape[1], k.shape[1]
    if past_k is not None:
        k = torch.cat([past_k, k], dim=2)
    if past_v is not None:
        v = torch.cat([past_v, v], dim=2)
    present_k, present_v = k, v
    if Hq % Hkv:
        raise UnsupportedOpError(
            f"Attention: q_num_heads {Hq} not a multiple of kv_num_heads "
            f"{Hkv}")
    rep = Hq // Hkv
    if rep > 1:  # each kv head serves a contiguous group of q heads
        k = repeat_each(k, rep, 1)
        v = repeat_each(v, rep, 1)
    L, S = q.shape[2], k.shape[2]
    s = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with matmul_fp32_exact():
        qk = torch.einsum("bhld,bhsd->bhls", q, k) * s
    staged = {0: qk}
    bias = torch.zeros((L, S), dtype=qk.dtype, device=qk.device)
    if int(node.attr("is_causal", 0)):
        keep = torch.ones((L, S), dtype=torch.bool, device=qk.device).tril()
        bias = torch.where(keep, bias, torch.full_like(bias, _NEG))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            zero = torch.zeros((), dtype=qk.dtype, device=qk.device)
            bias = bias + torch.where(attn_mask, zero,
                                      torch.full_like(zero, _NEG))
        else:
            bias = bias + attn_mask
    qk = qk + bias
    staged[1] = qk
    if softcap > 0.0:
        qk = softcap * torch.tanh(qk / softcap)
    staged[2] = qk
    probs = torch.softmax(qk, dim=-1)
    staged[3] = probs
    with matmul_fp32_exact():
        y = torch.einsum("bhls,bhsd->bhld", probs, v)
    if three_d:
        y = _merge(y)
    # outputs by slot: [Y, present_key, present_value, qk_output]
    return (y, present_k, present_v, staged[mode])[: len(node.outputs)]


@register("RotaryEmbedding")
def rotary_embedding_core(ctx: LoweringContext, node: Node, ins):
    """X [B, S, hidden] (num_heads given) or [B, H, S, hd]; caches
    [max_pos, r / 2] indexed by position_ids (input 3), or without them
    per position [B, S, r / 2]; rotary_embedding_dim r rotates the first
    r head dims (0: all)."""
    if len(ins) > 1 and ins[1] is not None and not (
            ins[1].is_floating_point() or ins[1].is_complex()):
        return ms_rope(ctx, node, ins)
    x, cos_cache, sin_cache = ins[0], ins[1], ins[2]
    pos_ids = ins[3] if len(ins) > 3 else None
    three_d = x.dim() == 3
    if three_d:
        H = int(node.attr("num_heads", 0))
        if not H:
            raise UnsupportedOpError(
                "RotaryEmbedding: num_heads attribute is required for 3-D "
                "input")
        xh = _heads(x, H)
    else:
        xh = x
    rot = int(node.attr("rotary_embedding_dim", 0)) or xh.shape[-1]
    half = rot // 2
    if pos_ids is not None:
        pid = pos_ids.to(torch.int64)
        if pid.dim() == 1:  # [S], the same for every row
            pid = pid[None]
        cos, sin = cos_cache[pid], sin_cache[pid]
    else:
        cos, sin = cos_cache, sin_cache
    out = _rope_rotate(xh, cos[..., :half][:, None], sin[..., :half][:, None],
                       rot, int(node.attr("interleaved", 0)))
    return (_merge(out) if three_d else out,)
