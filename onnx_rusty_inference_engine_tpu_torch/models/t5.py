"""T5-style encoder-decoder builders (the seq2seq generation family): the
port's copy of onnx_rusty_inference_engine_tpu/models/t5.py.

A bidirectional encoder, a causal decoder with a fixed-size self-attention
KV cache (per-slot `pos [B]`, the same continuous-batching contract as the
decoder-only families), and per-layer cross-attention K/V projected once
from the encoder output: encoding and the cross-KV projection are one
graph that runs once per request; the decode step is another that runs per
token and only reads the cross cache.

T5 specifics (lineage: t5-small):
- RMSNorm (SimplifiedLayerNormalization) everywhere, pre-norm residuals
- no attention scaling by 1/sqrt(hd); no biases on any linear
- a shared token embedding; the decoder output rescaled by d_model**-0.5
  before the tied lm head
- a bucketed relative-position bias added to the self-attention scores of
  every layer from a shared learned table (bidirectional buckets in the
  encoder, causal buckets in the decoder); cross-attention carries none

The position bias is baked at build time: bucket indices depend only on
(query pos, key pos), so the encoder holds the dense [1, H, S, S] bias as
a constant, and the decode graph holds [max_len, H, L] and Gathers its
rows at the run-time `pos`. Both graphs take `src_len [B]`, which masks
source padding out of (cross-)attention. Inside `_builder.host_memo()` the
encoder and decode builds of one config and seed share one weight draw.
The same config and seed give the JAX package's ONNX bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder, memo


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    n_layer: int = 6          # encoder AND decoder layer count
    n_head: int = 8
    d_ff: int = 2048
    rel_buckets: int = 32
    rel_max_dist: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


TINY = T5Config(vocab_size=128, d_model=32, n_layer=2, n_head=4, d_ff=64,
                rel_buckets=8, rel_max_dist=16)


def _rel_bucket(rel: np.ndarray, bidirectional: bool, num_buckets: int,
                max_dist: int) -> np.ndarray:
    """T5 relative-position bucketing (rel = memory_pos - query_pos)."""
    ret = np.zeros_like(rel)
    n = num_buckets
    if bidirectional:
        n //= 2
        ret = ret + (rel > 0).astype(rel.dtype) * n
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_dist / max_exact) * (n - max_exact)).astype(rel.dtype)
    large = np.minimum(large, n - 1)
    return (ret + np.where(is_small, rel, large)).astype(np.int64)


def _t5_weights(cfg: T5Config, seed: int) -> Dict[str, np.ndarray]:
    """Every parameter, generated in ONE fixed rng order so the encoder
    and decode builders share identical weights (inside host_memo, the
    dict drawn first for the same config and seed)."""
    return memo(("t5", dataclasses.astuple(cfg), seed),
                lambda: _draw_t5_weights(cfg, seed))


def _draw_t5_weights(cfg: T5Config, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    D, H, hd, F = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.d_ff
    w: Dict[str, np.ndarray] = {}

    def lin(name, din, dout):
        w[name] = (rng.standard_normal((din, dout)) * din ** -0.5
                   ).astype(np.float32)

    w["emb"] = (rng.standard_normal((cfg.vocab_size, D)) * 1.0
                ).astype(np.float32)
    w["enc_rel_bias"] = (rng.standard_normal((cfg.rel_buckets, H)) * 0.1
                         ).astype(np.float32)
    w["dec_rel_bias"] = (rng.standard_normal((cfg.rel_buckets, H)) * 0.1
                         ).astype(np.float32)
    for i in range(cfg.n_layer):
        w[f"enc{i}_ln1"] = np.ones(D, np.float32)
        for p in ("q", "k", "v", "o"):
            lin(f"enc{i}_{p}", D, D)
        w[f"enc{i}_ln2"] = np.ones(D, np.float32)
        lin(f"enc{i}_wi", D, F)
        lin(f"enc{i}_wo", F, D)
    w["enc_norm"] = np.ones(D, np.float32)
    for i in range(cfg.n_layer):
        w[f"dec{i}_ln1"] = np.ones(D, np.float32)
        for p in ("q", "k", "v", "o"):
            lin(f"dec{i}_sa_{p}", D, D)
        w[f"dec{i}_ln2"] = np.ones(D, np.float32)
        for p in ("q", "k", "v", "o"):
            lin(f"dec{i}_ca_{p}", D, D)
        w[f"dec{i}_ln3"] = np.ones(D, np.float32)
        lin(f"dec{i}_wi", D, F)
        lin(f"dec{i}_wo", F, D)
    w["dec_norm"] = np.ones(D, np.float32)
    return w


def _rms(b: GraphBuilder, x: str, wname: str, tag: str) -> str:
    (y,) = b.node("SimplifiedLayerNormalization", [x, wname], [f"{tag}_y"],
                  axis=-1, epsilon=1e-6)
    return y


def _mm(b: GraphBuilder, x: str, wname: str, tag: str) -> str:
    (y,) = b.node("MatMul", [x, wname], [f"{tag}_y"])
    return y


def _heads(b: GraphBuilder, t: str, tag: str, shape_name: str) -> str:
    (r,) = b.node("Reshape", [t, shape_name], [f"{tag}_r"])
    (tr,) = b.node("Transpose", [r], [f"{tag}_t"], perm=[0, 2, 1, 3])
    return tr


def build_t5_encoder(
    cfg: T5Config = TINY,
    *,
    batch: int = 1,
    src_len: int = 16,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    """Encoder + cross-KV prep: src_ids [B,S] -> enc_out [B,S,D] plus
    per-decoder-layer cross_key_i / cross_value_i [B,H,S,hd] (projected
    here, with the decoder's cross-attention weights, so the decode step
    never touches the encoder output again)."""
    w = _t5_weights(cfg, seed)
    b = GraphBuilder("t5_encoder", opset=opset, seed=seed)
    B, S = batch, src_len
    D, H, hd = cfg.d_model, cfg.n_head, cfg.head_dim

    ids = b.input("src_ids", [B, S], dtype=np.int64)
    # per-row true source length: pad positions (>= src_len) are masked out
    # of every self-attention, so the encoder output does not depend on how
    # far the caller padded
    slen = b.input("src_len", [B], dtype=np.int64)
    for name, arr in w.items():
        if name.startswith(("enc", "emb")) or name.startswith("dec") and (
                "_ca_k" in name or "_ca_v" in name):
            b.init(name, arr)

    (x,) = b.node("Gather", ["emb", ids], ["src_emb"], axis=0)

    # dense static relative-position bias [1, H, S, S]
    rel = np.arange(S)[None, :] - np.arange(S)[:, None]  # mem - query
    buckets = _rel_bucket(rel, True, cfg.rel_buckets, cfg.rel_max_dist)
    bias = w["enc_rel_bias"][buckets]                    # [S, S, H]
    bias = bias.transpose(2, 0, 1)[None]                 # [1, H, S, S]
    b.init("enc_pos_bias_table", bias.astype(np.float32))

    # additive source-validity bias [B, 1, 1, S] folded into the pos bias
    b.init("src_arange", np.arange(S, dtype=np.int64))
    (sl2,) = b.node("Reshape", [slen, b.init(
        "shape_B_1s", np.array([B, 1], np.int64))], ["src_len2"])
    (src_ok,) = b.node("Less", ["src_arange", sl2], ["src_ok"])  # [B, S]
    b.init("zero_fe", np.float32(0.0))
    b.init("neg_inf_e", np.float32(-1e9))
    (pad_bias,) = b.node("Where", ["src_ok", "zero_fe", "neg_inf_e"],
                         ["src_pad_bias"])
    (pad_bias4,) = b.node("Reshape", [pad_bias, b.init(
        "shape_B_1_1_S", np.array([B, 1, 1, S], np.int64))],
        ["src_pad_bias4"])
    (enc_bias,) = b.node("Add", ["enc_pos_bias_table", pad_bias4],
                         ["enc_pos_bias"])               # [B, H, S, S]

    shape_split = b.init("e_shape_bshd", np.array([B, S, H, hd], np.int64))
    shape_merge = b.init("e_shape_bsd", np.array([B, S, D], np.int64))

    for i in range(cfg.n_layer):
        xn = _rms(b, x, f"enc{i}_ln1", f"enc{i}_ln1n")
        qh = _heads(b, _mm(b, xn, f"enc{i}_q", f"enc{i}_qp"),
                    f"enc{i}_qh", "e_shape_bshd")
        kh = _heads(b, _mm(b, xn, f"enc{i}_k", f"enc{i}_kp"),
                    f"enc{i}_kh", "e_shape_bshd")
        vh = _heads(b, _mm(b, xn, f"enc{i}_v", f"enc{i}_vp"),
                    f"enc{i}_vh", "e_shape_bshd")
        (kt,) = b.node("Transpose", [kh], [f"enc{i}_kT"], perm=[0, 1, 3, 2])
        (s,) = b.node("MatMul", [qh, kt], [f"enc{i}_scores"])  # no scaling
        (s,) = b.node("Add", [s, "enc_pos_bias"], [f"enc{i}_biased"])
        (p,) = b.node("Softmax", [s], [f"enc{i}_probs"], axis=-1)
        (c,) = b.node("MatMul", [p, vh], [f"enc{i}_ctx"])
        (c,) = b.node("Transpose", [c], [f"enc{i}_ctx_t"], perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, "e_shape_bsd"], [f"enc{i}_ctx_m"])
        o = _mm(b, c, f"enc{i}_o", f"enc{i}_op")
        (x,) = b.node("Add", [x, o], [f"enc{i}_res1"])
        hn = _rms(b, x, f"enc{i}_ln2", f"enc{i}_ln2n")
        h = _mm(b, hn, f"enc{i}_wi", f"enc{i}_ff1")
        (h,) = b.node("Relu", [h], [f"enc{i}_relu"])
        h = _mm(b, h, f"enc{i}_wo", f"enc{i}_ff2")
        (x,) = b.node("Add", [x, h], [f"enc{i}_res2"])

    x = _rms(b, x, "enc_norm", "enc_final")
    (enc_out,) = b.node("Identity", [x], ["enc_out"])
    b.output(enc_out, [B, S, D])

    # cross K/V per decoder layer, projected from the final encoder state
    for i in range(cfg.n_layer):
        ck = _heads(b, _mm(b, enc_out, f"dec{i}_ca_k", f"x{i}_ck"),
                    f"x{i}_ckh", "e_shape_bshd")
        cv = _heads(b, _mm(b, enc_out, f"dec{i}_ca_v", f"x{i}_cv"),
                    f"x{i}_cvh", "e_shape_bshd")
        b.node("Identity", [ck], [f"cross_key_{i}"])
        b.node("Identity", [cv], [f"cross_value_{i}"])
        b.output(f"cross_key_{i}", [B, H, S, hd])
        b.output(f"cross_value_{i}", [B, H, S, hd])
    return b.model()


def build_t5_decode(
    cfg: T5Config = TINY,
    *,
    batch: int = 1,
    max_len: int = 32,
    src_len: int = 16,
    opset: int = 17,
    seed: int = 0,
    kv_dtype: str = "float32",
) -> onnx_io.ModelProto:
    """Single-token decode step: fixed self-attn KV cache (per-slot pos
    [B], int8-capable exactly like gpt2/llama) + static cross K/V from
    build_t5_encoder."""
    w = _t5_weights(cfg, seed)
    b = GraphBuilder("t5_decode", opset=opset, seed=seed)
    B, T, L, S = batch, 1, max_len, src_len
    D, H, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    int8_kv = np.dtype(kv_dtype) == np.int8
    cache_np = np.int8 if int8_kv else np.float32

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    # per-slot true source length: cross-attention masks encoder positions
    # >= src_len (pads), mirroring the encoder-side mask
    slen = b.input("src_len", [B], dtype=np.int64)
    pasts = [(b.input(f"past_key_{i}", [B, H, L, hd], dtype=cache_np),
              b.input(f"past_value_{i}", [B, H, L, hd], dtype=cache_np))
             for i in range(cfg.n_layer)]
    crosses = [(b.input(f"cross_key_{i}", [B, H, S, hd]),
                b.input(f"cross_value_{i}", [B, H, S, hd]))
               for i in range(cfg.n_layer)]
    kv_scales = [(b.input(f"kv_scale_key_{i}", [H]),
                  b.input(f"kv_scale_value_{i}", [H]))
                 for i in range(cfg.n_layer)] if int8_kv else None
    zp8 = b.init("kv_zp8", np.int8(0)) if int8_kv else None

    for name, arr in w.items():
        if name == "emb" or name.startswith("dec"):
            if "_ca_k" in name or "_ca_v" in name:
                continue  # cross K/V already projected by the encoder
            b.init(name, arr)

    (x,) = b.node("Gather", ["emb", ids], ["tok_emb"], axis=0)

    # cache bookkeeping (same scheme as gpt2 decode)
    arange = b.init("cache_positions", np.arange(L, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])
    (is_now4,) = b.node("Reshape", [is_now, b.init(
        "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
    (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
    (attn_bias4,) = b.node("Reshape", [attn_bias, b.init(
        "shape_B_1_1_L", np.array([B, 1, 1, L], np.int64))], ["attn_bias4"])

    # decoder self-attn position bias, precomputed dense [max_len, H, L]
    # then Gathered per slot at runtime `pos` -> [B, H, L]
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]   # mem - query
    buckets = _rel_bucket(rel, False, cfg.rel_buckets, cfg.rel_max_dist)
    table = w["dec_rel_bias"][buckets]                    # [L, L, H]
    table = table.transpose(0, 2, 1)                      # [Lq, H, Lk]
    b.init("dec_pos_table", table.astype(np.float32))
    (pb,) = b.node("Gather", ["dec_pos_table", pos], ["pos_bias_g"], axis=0)
    (pb,) = b.node("Reshape", [pb, b.init(
        "shape_B_H_1_L", np.array([B, H, 1, L], np.int64))], ["pos_bias4"])
    (bias_all,) = b.node("Add", [pb, attn_bias4], ["self_bias"])

    # cross-attention source-validity bias [B, 1, 1, S]
    b.init("src_arange", np.arange(S, dtype=np.int64))
    (sl2,) = b.node("Reshape", [slen, b.init(
        "shape_B_1s", np.array([B, 1], np.int64))], ["src_len2"])
    (src_ok,) = b.node("Less", ["src_arange", sl2], ["src_ok"])
    (xbias,) = b.node("Where", ["src_ok", zero, neg], ["src_pad_bias"])
    (xbias4,) = b.node("Reshape", [xbias, b.init(
        "shape_B_1_1_S", np.array([B, 1, 1, S], np.int64))], ["cross_bias4"])

    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))

    for i in range(cfg.n_layer):
        # -- causal self-attention over the fixed cache ---------------------
        xn = _rms(b, x, f"dec{i}_ln1", f"d{i}_ln1n")
        qh = _heads(b, _mm(b, xn, f"dec{i}_sa_q", f"d{i}_saq"),
                    f"d{i}_qh", "shape_bthd")
        kh = _heads(b, _mm(b, xn, f"dec{i}_sa_k", f"d{i}_sak"),
                    f"d{i}_kh", "shape_bthd")
        vh = _heads(b, _mm(b, xn, f"dec{i}_sa_v", f"d{i}_sav"),
                    f"d{i}_vh", "shape_bthd")
        pk, pv = pasts[i]
        if int8_kv:
            sk, sv = kv_scales[i]
            (kh8,) = b.node("QuantizeLinear", [kh, sk, zp8],
                            [f"d{i}_k_q8"], axis=1)
            (vh8,) = b.node("QuantizeLinear", [vh, sv, zp8],
                            [f"d{i}_v_q8"], axis=1)
            (kc8,) = b.node("Where", [is_now4, kh8, pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, vh8, pv],
                            [f"present_value_{i}"])
            (kc,) = b.node("DequantizeLinear", [kc8, sk, zp8],
                           [f"d{i}_k_dq"], axis=1)
            (vc,) = b.node("DequantizeLinear", [vc8, sv, zp8],
                           [f"d{i}_v_dq"], axis=1)
        else:
            (kc,) = b.node("Where", [is_now4, kh, pk], [f"present_key_{i}"])
            (vc,) = b.node("Where", [is_now4, vh, pv],
                           [f"present_value_{i}"])
        (kt,) = b.node("Transpose", [kc], [f"d{i}_kT"], perm=[0, 1, 3, 2])
        (s,) = b.node("MatMul", [qh, kt], [f"d{i}_scores"])   # no scaling
        (s,) = b.node("Add", [s, "self_bias"], [f"d{i}_masked"])
        (p,) = b.node("Softmax", [s], [f"d{i}_probs"], axis=-1)
        (c,) = b.node("MatMul", [p, vc], [f"d{i}_ctx"])
        (c,) = b.node("Transpose", [c], [f"d{i}_ctx_t"], perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, "shape_btd"], [f"d{i}_ctx_m"])
        o = _mm(b, c, f"dec{i}_sa_o", f"d{i}_sao")
        (x,) = b.node("Add", [x, o], [f"d{i}_res1"])

        # -- cross-attention over the precomputed encoder K/V ---------------
        ck, cv = crosses[i]
        xn = _rms(b, x, f"dec{i}_ln2", f"d{i}_ln2n")
        qh = _heads(b, _mm(b, xn, f"dec{i}_ca_q", f"d{i}_caq"),
                    f"d{i}_cqh", "shape_bthd")
        (ckt,) = b.node("Transpose", [ck], [f"d{i}_ckT"], perm=[0, 1, 3, 2])
        (s,) = b.node("MatMul", [qh, ckt], [f"d{i}_xscores"])
        (s,) = b.node("Add", [s, "cross_bias4"], [f"d{i}_xmasked"])
        (p,) = b.node("Softmax", [s], [f"d{i}_xprobs"], axis=-1)
        (c,) = b.node("MatMul", [p, cv], [f"d{i}_xctx"])
        (c,) = b.node("Transpose", [c], [f"d{i}_xctx_t"],
                      perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, "shape_btd"], [f"d{i}_xctx_m"])
        o = _mm(b, c, f"dec{i}_ca_o", f"d{i}_cao")
        (x,) = b.node("Add", [x, o], [f"d{i}_res2"])

        # -- feed-forward ---------------------------------------------------
        hn = _rms(b, x, f"dec{i}_ln3", f"d{i}_ln3n")
        h = _mm(b, hn, f"dec{i}_wi", f"d{i}_ff1")
        (h,) = b.node("Relu", [h], [f"d{i}_relu"])
        h = _mm(b, h, f"dec{i}_wo", f"d{i}_ff2")
        (x,) = b.node("Add", [x, h], [f"d{i}_res3"])

    x = _rms(b, x, "dec_norm", "dec_final")
    (xs,) = b.node("Mul", [x, b.init("lm_scale",
                                     np.float32(D ** -0.5))], ["x_scaled"])
    emb_t = b.init("emb_T", np.ascontiguousarray(w["emb"].T))
    (logits,) = b.node("MatMul", [xs, emb_t], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    for i in range(cfg.n_layer):
        b.output(f"present_key_{i}", [B, H, L, hd], dtype=cache_np)
        b.output(f"present_value_{i}", [B, H, L, hd], dtype=cache_np)
    return b.model()
