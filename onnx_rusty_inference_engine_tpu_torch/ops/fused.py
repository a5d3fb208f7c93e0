"""Framework-native fused ops (domain com.oriet).

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/fused.py:
ops the repository's builders emit where a whole subgraph has one kernel.
"""

from __future__ import annotations

import os

import torch

from ..graph import Node
from .kernels.decode_attn import (decode_attention_int8,
                                  decode_attention_int8_mxu)
from .registry import LoweringContext, register


@register("FusedDecodeAttention", domain="com.oriet")
def fused_decode_attention(ctx: LoweringContext, node: Node, ins):
    """Single-token attention over an INT8 KV cache, GQA-aware.

    Inputs: q [B,H,1,hd] float; k8, v8 [B,Hkv,L,hd] int8 (the updated
    cache); k_scale, v_scale [Hkv] per-head dequant scales; bias
    [B,1,1,L] additive mask. Attr: scale (default 1/sqrt(hd)).
    Output: ctx [B,H,1,hd] -- what MatMul(softmax(...), v) gives in the
    unfused graph.

    The scales fold as in the JAX emitter: q * k_scale[h] * scale goes in,
    the kernel's output is multiplied by v_scale[h]. One kernel per call
    (ops/kernels/decode_attn.py), the same function on both devices: the
    kernel on the card, its plain version on the CPU. ORIET_ATTN_I8 set
    selects the int8 x int8 form, as it does on the TPU.
    """
    q, k8, v8, sk, sv, bias = ins[:6]
    B, H, one, hd = q.shape
    _, Hkv, L, _ = k8.shape
    rep = H // Hkv
    scale = float(node.attr("scale", 1.0 / float(hd) ** 0.5))

    sk_h = sk.repeat_interleave(rep) if rep > 1 else sk      # [H]
    sv_h = sv.repeat_interleave(rep) if rep > 1 else sv

    attend = (decode_attention_int8_mxu if os.environ.get("ORIET_ATTN_I8")
              else decode_attention_int8)
    q2 = q * (sk_h * scale)[None, :, None, None]
    out = attend(q2.reshape(B * H, one, hd).to(torch.float32).contiguous(),
                 k8.reshape(B * Hkv, L, hd).contiguous(),
                 v8.reshape(B * Hkv, L, hd).contiguous(),
                 bias.reshape(B, 1, L).to(torch.float32).contiguous(),
                 n_q_heads=H)
    ctx_out = out.reshape(B, H, one, hd) * sv_h[None, :, None, None]
    return (ctx_out.to(q.dtype),)
