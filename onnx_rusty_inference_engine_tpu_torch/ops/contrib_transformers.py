"""ORT transformer contrib ops (domain com.microsoft) -> PyTorch.

The port's counterpart of
onnx_rusty_inference_engine_tpu/ops/contrib_transformers.py: onnxruntime's
transformer optimizer rewrites exported BERT / GPT / Llama graphs into
these fused nodes, and each maps back onto plain tensor ops with the JAX
emitter's arithmetic (scores through einsum, masks as a -1e9 additive
bias, softmax over the keys). Products run in full fp32 (TF32 off).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..graph import Node
from ..utils.fp32 import matmul_fp32_exact
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import repeat_each

_NEG = -1e9


@register("BiasGelu", domain="com.microsoft")
def bias_gelu(ctx, node, ins):
    x, b = ins
    return (F.gelu(x + b),)


@register("FastGelu", domain="com.microsoft")
def fast_gelu(ctx, node, ins):
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:
        x = x + ins[1]
    return (F.gelu(x, approximate="tanh"),)


def _moments(h: torch.Tensor):
    mean = h.mean(dim=-1, keepdim=True)
    return mean, torch.square(h - mean).mean(dim=-1, keepdim=True)


@register("SkipLayerNormalization", domain="com.microsoft")
def skip_layer_normalization(ctx, node, ins):
    """LayerNorm of x + skip (+ bias). Outputs by slot: [ln, mean,
    inv_std, input_skip_bias_sum]; ORT's fused form often names only the
    first and the last."""
    x, skip, gamma = ins[0], ins[1], ins[2]
    beta = ins[3] if len(ins) > 3 and ins[3] is not None else None
    bias = ins[4] if len(ins) > 4 and ins[4] is not None else None
    eps = float(node.attr("epsilon", 1e-12))
    h = x + skip
    if bias is not None:
        h = h + bias
    mean, var = _moments(h)
    inv = torch.rsqrt(var + eps)
    out = (h - mean) * inv * gamma
    if beta is not None:
        out = out + beta
    return (out, mean.squeeze(-1), inv.squeeze(-1), h)[: len(node.outputs)]


@register("EmbedLayerNormalization", domain="com.microsoft")
def embed_layer_normalization(ctx, node, ins):
    """Word + position (+ segment) embeddings, LayerNorm'd. Outputs by
    slot: [ln, mask_index (the mask's row sums, else S), embedding_sum]."""
    ids, seg_ids, word_emb, pos_emb = ins[:4]
    seg_emb = ins[4] if len(ins) > 4 and ins[4] is not None else None
    gamma, beta = ins[5], ins[6]
    mask = ins[7] if len(ins) > 7 and ins[7] is not None else None
    pos_ids = ins[8] if len(ins) > 8 and ins[8] is not None else None
    eps = float(node.attr("epsilon", 1e-12))
    B, S = ids.shape
    e = F.embedding(ids.to(torch.int64), word_emb)
    if pos_ids is not None:
        # [B, S], or the broadcastable [1, S] / [S]
        p = pos_ids if pos_ids.dim() == 2 else pos_ids[None]
        e = e + F.embedding(p.to(torch.int64), pos_emb)
    else:
        e = e + pos_emb[:S][None]
    if seg_emb is not None and seg_ids is not None:
        e = e + F.embedding(seg_ids.to(torch.int64), seg_emb)
    mean, var = _moments(e)
    out = (e - mean) * torch.rsqrt(var + eps) * gamma + beta
    if mask is not None:
        mask_index = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    else:
        mask_index = torch.full((B,), S, dtype=torch.int32, device=e.device)
    return (out, mask_index, e)[: max(len(node.outputs), 2)]


def _mask_bias(mask_index, B, S_kv, device):
    """ORT mask_index forms -> an additive bias [B, 1, 1, S_kv]: right-
    padding lengths [B], or a 1/0 key mask [B, S_kv]."""
    if mask_index is None:
        return None
    m = mask_index
    if m.dim() == 1 and m.shape[0] == B:
        valid = torch.arange(S_kv, device=device)[None, :] < m[:, None]
    elif m.dim() == 2 and tuple(m.shape) == (B, S_kv):
        valid = m.to(torch.bool)
    else:
        raise UnsupportedOpError(
            f"Attention: unsupported mask_index shape {tuple(m.shape)}")
    return _bias(valid)[:, None, None, :]


def _bias(valid: torch.Tensor) -> torch.Tensor:
    """0 where valid, -1e9 elsewhere, float32."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, _NEG))


def _sdpa(q, k, v, bias, unidirectional, scale=None):
    """q / k / v [B, H, S, hd] -> [B, H, S_q, hd], the JAX emitter's
    order: scores * scale + bias, a causal -1e9 (bottom-right aligned),
    softmax, times v."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with matmul_fp32_exact():
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) * s
        if bias is not None:
            att = att + bias
        if unidirectional:
            S_q, S_kv = att.shape[-2], att.shape[-1]
            causal = torch.ones((S_q, S_kv), dtype=torch.bool,
                                device=att.device).tril(S_kv - S_q)
            att = torch.where(causal, att, torch.full_like(att, _NEG))
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1),
                            v)


def _heads(t, H):
    """[B, S, H * d] -> [B, H, S, d]."""
    B, S, D = t.shape
    return t.reshape(B, S, H, D // H).transpose(1, 2)


def _merge(t):
    """[B, H, S, d] -> [B, S, H * d]."""
    B, H, S, d = t.shape
    return t.transpose(1, 2).reshape(B, S, H * d)


@register("Attention", domain="com.microsoft")
def attention(ctx: LoweringContext, node: Node, ins):
    """com.microsoft.Attention: packed-QKV self-attention (no past)."""
    x, w = ins[0], ins[1]
    bias = ins[2] if len(ins) > 2 and ins[2] is not None else None
    mask_index = ins[3] if len(ins) > 3 and ins[3] is not None else None
    if len(ins) > 4 and ins[4] is not None:
        raise UnsupportedOpError("Attention: past-state input not supported")
    attn_bias = ins[5] if len(ins) > 5 and ins[5] is not None else None
    if len(ins) > 6 and ins[6] is not None:
        raise UnsupportedOpError(
            "Attention: past_sequence_length input not supported")
    H = int(node.attr("num_heads"))
    scale = node.attr("scale")
    B, S, _ = x.shape
    sizes = node.attr("qkv_hidden_sizes")
    if sizes is not None:
        dq, dk, dv = (int(v) for v in sizes)
    else:
        dq = dk = dv = w.shape[1] // 3
    with matmul_fp32_exact():
        qkv = x @ w
    if bias is not None:
        qkv = qkv + bias
    q, k, v = qkv[..., :dq], qkv[..., dq:dq + dk], qkv[..., dq + dk:]
    mb = _mask_bias(mask_index, B, S, x.device)
    if attn_bias is not None:  # relative position bias [B|1, H|1, S, S]
        mb = attn_bias if mb is None else mb + attn_bias
    out = _sdpa(_heads(q, H), _heads(k, H), _heads(v, H), mb,
                int(node.attr("unidirectional", 0)),
                float(scale) if scale is not None else None)
    return (_merge(out),)


@register("MultiHeadAttention", domain="com.microsoft")
def multi_head_attention(ctx: LoweringContext, node: Node, ins):
    """com.microsoft.MultiHeadAttention: separate Q / K / V (no past)."""
    q, k, v = ins[0], ins[1], ins[2]
    bias = ins[3] if len(ins) > 3 and ins[3] is not None else None
    kpm = ins[4] if len(ins) > 4 and ins[4] is not None else None
    attn_bias = ins[5] if len(ins) > 5 and ins[5] is not None else None
    if any(i is not None for i in ins[6:8]):
        raise UnsupportedOpError(
            "MultiHeadAttention: past-state inputs not supported")
    H = int(node.attr("num_heads"))
    scale = node.attr("scale")
    B, D = q.shape[0], q.shape[-1]
    if bias is not None:
        dk = k.shape[-1]
        q = q + bias[:D]
        k = k + bias[D:D + dk]
        v = v + bias[D + dk:]
    mb = _mask_bias(kpm, B, k.shape[1], q.device)
    if attn_bias is not None:
        mb = attn_bias if mb is None else mb + attn_bias
    out = _sdpa(_heads(q, H), _heads(k, H), _heads(v, H), mb,
                int(node.attr("unidirectional", 0)),
                float(scale) if scale is not None else None)
    return (_merge(out),)


def _rope_rotate(xh, cos, sin, rot, interleaved):
    """Rotate the first `rot` head dims of xh [B, H, S, hd] by cos / sin
    [B|1, 1, S, rot / 2]; the dims past `rot` pass through. Shared by the
    com.microsoft and the core (opset 23) RotaryEmbedding."""
    half = rot // 2
    xr, xp = xh[..., :rot], xh[..., rot:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
    return torch.cat([rotated, xp], dim=-1) if xp.shape[-1] else rotated


@register("RotaryEmbedding", domain="com.microsoft")
def rotary_embedding(ctx: LoweringContext, node: Node, ins):
    """com.microsoft.RotaryEmbedding: x [B, S, D] (or [B, H, S, hd]),
    position_ids [B, S] / [1, S], or [B, 1] / [1] as each sequence's
    first position; cos / sin caches [max_pos, rot / 2]; interleaved 0
    (half rotation) or 1 (adjacent pairs)."""
    x, pos_ids, cos_cache, sin_cache = ins[:4]
    interleaved = int(node.attr("interleaved", 0))
    n_heads = int(node.attr("num_heads", 0))
    rot = 2 * cos_cache.shape[-1]
    three_d = x.dim() == 3
    if three_d:
        B, S, D = x.shape
        if n_heads:
            H = n_heads
        elif D % rot:
            raise UnsupportedOpError(
                "RotaryEmbedding: num_heads required when hidden is not a "
                "multiple of the rotary dim")
        else:
            H = D // rot
        xh = _heads(x, H)
    else:
        xh = x
        S = xh.shape[2]
    pid = pos_ids.reshape(pos_ids.shape[0], -1).to(torch.int64)
    if pid.shape[-1] == 1 and S > 1:
        pid = pid + torch.arange(S, device=pid.device)[None]
    out = _rope_rotate(xh, cos_cache[pid][:, None], sin_cache[pid][:, None],
                       rot, interleaved)
    return (_merge(out) if three_d else out,)


@register("GroupQueryAttention", domain="com.microsoft")
def group_query_attention(ctx: LoweringContext, node: Node, ins):
    """com.microsoft.GroupQueryAttention, the no-past form: GQA, causal,
    with the optional fused rotary (cos / sin caches at inputs 7 and 8,
    over the whole head dim) and seqlens_k (each row's valid key count
    less one). softcap and a local window are refused."""
    q, k, v = ins[0], ins[1], ins[2]
    if any(i is not None for i in ins[3:5]):
        raise UnsupportedOpError(
            "GroupQueryAttention: past-state inputs not supported")
    seqlens_k = ins[5] if len(ins) > 5 and ins[5] is not None else None
    cos_cache = ins[7] if len(ins) > 7 and ins[7] is not None else None
    sin_cache = ins[8] if len(ins) > 8 and ins[8] is not None else None
    H = int(node.attr("num_heads"))
    Hkv = int(node.attr("kv_num_heads", H))
    scale = node.attr("scale")
    if scale is not None and float(scale) == 0.0:
        scale = None  # ORT: 0 (the serialized default) is 1/sqrt(hd)
    if float(node.attr("softcap", 0.0)) != 0.0:
        raise UnsupportedOpError("GroupQueryAttention: softcap not supported")
    if int(node.attr("local_window_size", -1)) not in (-1, 0):
        raise UnsupportedOpError(
            "GroupQueryAttention: local_window_size (sliding window) "
            "not supported")
    B, S, D = q.shape
    hd = D // H
    qh, kh, vh = _heads(q, H), _heads(k, Hkv), _heads(v, Hkv)
    if cos_cache is not None:
        if 2 * cos_cache.shape[-1] != hd:
            raise UnsupportedOpError(
                "GroupQueryAttention: partial rotary dims not supported "
                f"(cache covers {2 * cos_cache.shape[-1]} of head_dim {hd})")
        c, s = cos_cache[:S], sin_cache[:S]
        if int(node.attr("rotary_interleaved", 0)):
            cos = repeat_each(c, 2, -1)[None, None]
            sin = repeat_each(s, 2, -1)[None, None]

            def rope(t):
                r = torch.stack([-t[..., 1::2], t[..., 0::2]],
                                dim=-1).reshape(t.shape)
                return t * cos + r * sin
        else:
            cos = torch.cat([c, c], -1)[None, None]
            sin = torch.cat([s, s], -1)[None, None]

            def rope(t):
                r = torch.cat([-t[..., hd // 2:], t[..., :hd // 2]], -1)
                return t * cos + r * sin

        qh, kh = rope(qh), rope(kh)
    rep = H // Hkv
    if rep > 1:
        kh = repeat_each(kh, rep, 1)
        vh = repeat_each(vh, rep, 1)
    mb = None
    if seqlens_k is not None:
        valid = (torch.arange(S, device=q.device)[None, :]
                 <= seqlens_k.reshape(B, 1))
        mb = _bias(valid)[:, None, None, :]
    out = _sdpa(qh, kh, vh, mb, unidirectional=1,
                scale=float(scale) if scale is not None else None)
    return (_merge(out),)


@register("FusedMatMul", domain="com.microsoft")
def fused_matmul(ctx, node, ins):
    """alpha * op(A) @ op(B), with transA / transB (transBatch* refused);
    the result in A's dtype."""
    a, b = ins
    if int(node.attr("transBatchA", 0)) or int(node.attr("transBatchB", 0)):
        raise UnsupportedOpError("FusedMatMul: transBatchA/B not supported")
    if int(node.attr("transA", 0)):
        a = a.transpose(-1, -2)
    if int(node.attr("transB", 0)):
        b = b.transpose(-1, -2)
    with matmul_fp32_exact():
        out = torch.matmul(a, b)
    return ((float(node.attr("alpha", 1.0)) * out).to(a.dtype),)
