"""Shared in-graph INT4 nibble pack/unpack for KV caches: the port's copy
of onnx_rusty_inference_engine_tpu/models/q4.py.

p = (q0+8) + 16*q1 with q in [-8, 7] spans exactly [-128, 127]; unpack
inverts with q1 = floor((p+128)/16) - 8, q0 = p - 16*q1 - 8. All
arithmetic runs in f32 (small ints are exact), with no sub-byte dtypes,
so the graphs equal the JAX package's node for node and the pack and
unpack give the same bits on the card as on the CPU. One definition serves the gpt2 and
llama (GQA: heads = n_kv_head) decode builders; quant.pack_int4_kv packs
a prefill's K/V into the same layout."""

from __future__ import annotations

import numpy as np


def q4_helpers(b, *, heads: int, hd: int, batch: int, max_len: int):
    """Install the q4 constants on GraphBuilder `b` and return
    (pack, unpack, scale_shape): pack(t, s4, tag) takes [B,heads,T,hd]
    f32 -> [B,heads,T,hd/2] int8; unpack(t8, s4, tag) inverts over the
    full cache [B,heads,max_len,hd/2] -> dequantized f32; scale_shape is
    the [1,heads,1,1] reshape target for the per-head scale input."""
    q4_lo = b.init("q4_lo", np.float32(-8.0))
    q4_hi = b.init("q4_hi", np.float32(7.0))
    q4_16 = b.init("q4_16", np.float32(16.0))
    q4_8 = b.init("q4_8", np.float32(8.0))
    q4_128 = b.init("q4_128", np.float32(128.0))
    q4_s0 = b.init("q4_s0", np.array([0], np.int64))
    q4_s1 = b.init("q4_s1", np.array([1], np.int64))
    q4_send = b.init("q4_send", np.array([hd], np.int64))
    q4_ax3 = b.init("q4_ax3", np.array([3], np.int64))
    q4_step2 = b.init("q4_step2", np.array([2], np.int64))
    q4_ax4 = b.init("q4_ax4", np.array([4], np.int64))
    q4_sshape = b.init("q4_sshape",
                       np.array([1, heads, 1, 1], np.int64))
    q4_full = b.init("q4_full",
                     np.array([batch, heads, max_len, hd], np.int64))

    def pack(t: str, s4: str, tag: str) -> str:
        """[B,heads,T,hd] f32 -> [B,heads,T,hd/2] int8 (2 nibbles/byte)."""
        (d,) = b.node("Div", [t, s4], [f"{tag}_q4d"])
        (r,) = b.node("Round", [d], [f"{tag}_q4r"])
        (c,) = b.node("Clip", [r, q4_lo, q4_hi], [f"{tag}_q4c"])
        (q0,) = b.node("Slice", [c, q4_s0, q4_send, q4_ax3, q4_step2],
                       [f"{tag}_q4q0"])
        (q1,) = b.node("Slice", [c, q4_s1, q4_send, q4_ax3, q4_step2],
                       [f"{tag}_q4q1"])
        (q0b,) = b.node("Add", [q0, q4_8], [f"{tag}_q4q0b"])
        (m,) = b.node("Mul", [q1, q4_16], [f"{tag}_q4m"])
        (pp,) = b.node("Add", [q0b, m], [f"{tag}_q4p"])
        (p8,) = b.node("Cast", [pp], [f"{tag}_q4p8"], to=3)
        return p8

    def unpack(t8: str, s4: str, tag: str) -> str:
        """[B,heads,L,hd/2] int8 -> dequantized [B,heads,L,hd] f32."""
        (pf,) = b.node("Cast", [t8], [f"{tag}_q4pf"], to=1)
        (t1,) = b.node("Add", [pf, q4_128], [f"{tag}_q4t1"])
        (t2,) = b.node("Div", [t1, q4_16], [f"{tag}_q4t2"])
        (q1p,) = b.node("Floor", [t2], [f"{tag}_q4q1p"])
        (q1,) = b.node("Sub", [q1p, q4_8], [f"{tag}_q4uq1"])
        (m,) = b.node("Mul", [q1, q4_16], [f"{tag}_q4um"])
        (q0b,) = b.node("Sub", [pf, m], [f"{tag}_q4uq0b"])
        (q0,) = b.node("Sub", [q0b, q4_8], [f"{tag}_q4uq0"])
        (u0,) = b.node("Unsqueeze", [q0, q4_ax4], [f"{tag}_q4u0"])
        (u1,) = b.node("Unsqueeze", [q1, q4_ax4], [f"{tag}_q4u1"])
        (cat,) = b.node("Concat", [u0, u1], [f"{tag}_q4cat"], axis=4)
        (fl,) = b.node("Reshape", [cat, q4_full], [f"{tag}_q4fl"])
        (dq,) = b.node("Mul", [fl, s4], [f"{tag}_q4dq"])
        return dq

    return pack, unpack, q4_sshape
