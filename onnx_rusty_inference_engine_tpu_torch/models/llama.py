"""Llama-style decoder ONNX builder: RoPE + GQA + SwiGLU + RMSNorm. The
port's copy of onnx_rusty_inference_engine_tpu/models/llama.py: the same
config and seed give the JAX package's graphs node for node and weight for
weight.

Extends the decoder-family coverage beyond GPT-2 (gpt2.py: learned
positions, MHA, Gelu, LayerNorm) to the modern llama lineage:
- rotary position embeddings applied to q/k via precomputed cos/sin tables
  gathered at the token positions (pure Gather/Mul/Slice/Concat, no custom
  ops),
- grouped-query attention (n_kv_heads < n_heads; KV heads expanded with
  Unsqueeze→Expand→Reshape),
- SwiGLU MLP (silu(x Wg) * (x Wu)) Wd,
- RMSNorm (emitted as the ORT contrib SimplifiedLayerNormalization, which
  real llama ONNX exports use).

build_llama_decode mirrors gpt2.build_gpt2_decode: single-token step over a
FIXED-size KV cache with PER-SLOT positions (pos [B]) — directly servable
by the continuous-batching machinery.

Inside `_builder.host_memo()` every build of one config and seed reuses the
weights the first one drew; the Scan-over-layers decode graph
(scan_layers=True) stacks the same per-layer arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder, memo, stacked


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    max_positions: int = 2048
    dim: int = 4096
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    ffn_mult: int = 4  # hidden = ffn_mult * dim (simplified vs 8/3 rounding)
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_head


TINY = LlamaConfig(vocab_size=128, max_positions=64, dim=32, n_layer=2,
                   n_head=4, n_kv_head=2, ffn_mult=2)


def _rope_tables(cfg: LlamaConfig) -> tuple:
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    t = np.arange(cfg.max_positions)[:, None] * inv[None, :]  # [L, hd/2]
    emb = np.concatenate([t, t], axis=-1)                     # [L, hd]
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _weight_key(cfg: LlamaConfig, seed: int) -> tuple:
    """What a build's weight draws depend on: the widths, depth and seed."""
    return ("llama", cfg.vocab_size, cfg.dim, cfg.n_layer, cfg.n_head,
            cfg.n_kv_head, cfg.ffn_mult, seed)


def _weight(b: GraphBuilder, name: str, shape, scale: float) -> str:
    """A seeded weight drawn from b.rng (inside host_memo, the array drawn
    first for the same build key and name). `b.wkey` is `_weight_key`."""
    return b.init(name, memo(b.wkey + (name,), lambda: (
        b.rng.standard_normal(shape) * scale).astype(np.float32)))


def _rmsnorm(b: GraphBuilder, x: str, name: str, d: int) -> str:
    w = b.init(f"{name}_w", np.ones(d, np.float32))
    (y,) = b.node("SimplifiedLayerNormalization", [x, w], [f"{name}_y"],
                  axis=-1, epsilon=1e-5)
    return y


def _linear(b: GraphBuilder, x: str, name: str, d_in: int, d_out: int) -> str:
    w = _weight(b, f"{name}_w", (d_in, d_out), d_in ** -0.5)
    (y,) = b.node("MatMul", [x, w], [f"{name}_y"])
    return y


def _rotate_half(b: GraphBuilder, x: str, name: str, hd: int) -> str:
    """concat(-x[..., hd/2:], x[..., :hd/2]) on the last axis."""
    half = b.init(f"{name}_half", np.array([hd // 2], np.int64))
    zero = b.init(f"{name}_zero", np.array([0], np.int64))
    end = b.init(f"{name}_end", np.array([hd], np.int64))
    ax = b.init(f"{name}_ax", np.array([-1], np.int64))
    (hi,) = b.node("Slice", [x, half, end, ax], [f"{name}_hi"])
    (lo,) = b.node("Slice", [x, zero, half, ax], [f"{name}_lo"])
    (nhi,) = b.node("Neg", [hi], [f"{name}_nhi"])
    (out,) = b.node("Concat", [nhi, lo], [f"{name}_rot"], axis=-1)
    return out


def _apply_rope(b: GraphBuilder, x: str, cos: str, sin: str, name: str,
                hd: int) -> str:
    """x [B,H,T,hd] * cos [.,1,T,hd] + rotate_half(x) * sin."""
    (xc,) = b.node("Mul", [x, cos], [f"{name}_xc"])
    rot = _rotate_half(b, x, name, hd)
    (xs,) = b.node("Mul", [rot, sin], [f"{name}_xs"])
    (out,) = b.node("Add", [xc, xs], [f"{name}_roped"])
    return out


def _expand_kv(b: GraphBuilder, x: str, name: str, B: int, Hkv: int,
               rep: int, L: int, hd: int) -> str:
    """[B,Hkv,L,hd] -> [B,Hkv*rep,L,hd] (GQA head sharing)."""
    if rep == 1:
        return x
    (u,) = b.node("Unsqueeze", [x, b.init(f"{name}_u_ax",
                                          np.array([2], np.int64))],
                  [f"{name}_u"])
    shape = b.init(f"{name}_eshape",
                   np.array([B, Hkv, rep, L, hd], np.int64))
    (e,) = b.node("Expand", [u, shape], [f"{name}_e"])
    merged = b.init(f"{name}_mshape",
                    np.array([B, Hkv * rep, L, hd], np.int64))
    (out,) = b.node("Reshape", [e, merged], [f"{name}_exp"])
    return out


def _attention_block(b: GraphBuilder, x: str, i: int, cfg: LlamaConfig,
                     B: int, T: int, kcache: str, vcache: str,
                     attn_bias: str, kv_len: int) -> str:
    """Shared by prefill (kcache/vcache = current k/v) and decode.
    RoPE has already been applied to q/k by the callers."""
    D, H, Hkv, hd = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    rep = H // Hkv
    ke = _expand_kv(b, kcache, f"l{i}_kexp", B, Hkv, rep, kv_len, hd)
    ve = _expand_kv(b, vcache, f"l{i}_vexp", B, Hkv, rep, kv_len, hd)
    (kt,) = b.node("Transpose", [ke], [f"l{i}_kT"], perm=[0, 1, 3, 2])
    (att,) = b.node("MatMul", [x, kt], [f"l{i}_scores"])
    sc = b.init(f"l{i}_scale", np.float32(1.0 / np.sqrt(hd)))
    (att,) = b.node("Mul", [att, sc], [f"l{i}_scaled"])
    (att,) = b.node("Add", [att, attn_bias], [f"l{i}_masked"])
    (att,) = b.node("Softmax", [att], [f"l{i}_probs"], axis=-1)
    (ctxt,) = b.node("MatMul", [att, ve], [f"l{i}_ctx"])
    (ctxt,) = b.node("Transpose", [ctxt], [f"l{i}_ctx_t"], perm=[0, 2, 1, 3])
    (ctxt,) = b.node("Reshape", [ctxt, b.init(
        f"l{i}_merge", np.array([B, T, D], np.int64))], [f"l{i}_ctx_m"])
    return ctxt


def build_llama(
    cfg: LlamaConfig = TINY,
    *,
    batch: int = 1,
    seq_len: int = 16,
    with_presents: bool = True,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    """Prefill graph: input_ids [B,T] -> logits [B,T,V] (+ presents
    [B,Hkv,T,hd])."""
    b = GraphBuilder("llama", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T = batch, seq_len
    D, H, Hkv, hd = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    emb = _weight(b, "tok_embeddings", (cfg.vocab_size, D), 0.02)
    (x,) = b.node("Gather", [emb, ids], ["h0"], axis=0)

    cos_t, sin_t = _rope_tables(cfg)
    pos = b.init("positions", np.arange(T, dtype=np.int64))
    (cos,) = b.node("Gather", [b.init("rope_cos", cos_t), pos], ["cos_g"],
                    axis=0)  # [T, hd] -> broadcast as [1,1,T,hd]
    (cos,) = b.node("Reshape", [cos, b.init(
        "cs_shape", np.array([1, 1, T, hd], np.int64))], ["cos4"])
    (sin,) = b.node("Gather", [b.init("rope_sin", sin_t), pos], ["sin_g"],
                    axis=0)
    (sin,) = b.node("Reshape", [sin, b.init("cs_shape2", np.array(
        [1, 1, T, hd], np.int64))], ["sin4"])

    mask = np.where(np.arange(T)[None, :] <= np.arange(T)[:, None],
                    0.0, -1e9).astype(np.float32).reshape(1, 1, T, T)
    bias = b.init("causal_mask", mask)

    qshape = b.init("q_shape", np.array([B, T, H, hd], np.int64))
    kvshape = b.init("kv_shape", np.array([B, T, Hkv, hd], np.int64))

    for i in range(cfg.n_layer):
        xn = _rmsnorm(b, x, f"l{i}_attn_norm", D)
        q = _linear(b, xn, f"l{i}_wq", D, H * hd)
        k = _linear(b, xn, f"l{i}_wk", D, Hkv * hd)
        v = _linear(b, xn, f"l{i}_wv", D, Hkv * hd)

        def _heads(t, tag, shape):
            (r,) = b.node("Reshape", [t, shape], [f"l{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"l{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh = _heads(q, "q", qshape)
        kh = _heads(k, "k", kvshape)
        vh = _heads(v, "v", kvshape)
        qh = _apply_rope(b, qh, cos, sin, f"l{i}_qrope", hd)
        kh = _apply_rope(b, kh, cos, sin, f"l{i}_krope", hd)
        if with_presents:
            b.node("Identity", [kh], [f"present_key_{i}"])
            b.node("Identity", [vh], [f"present_value_{i}"])

        ctxt = _attention_block(b, qh, i, cfg, B, T, kh, vh, bias, T)
        o = _linear(b, ctxt, f"l{i}_wo", D, D)
        (x,) = b.node("Add", [x, o], [f"l{i}_res1"])

        hn = _rmsnorm(b, x, f"l{i}_ffn_norm", D)
        gate = _linear(b, hn, f"l{i}_wg", D, cfg.ffn_mult * D)
        (gact,) = b.node("Sigmoid", [gate], [f"l{i}_gsig"])
        (gact,) = b.node("Mul", [gate, gact], [f"l{i}_silu"])  # SiLU
        up = _linear(b, hn, f"l{i}_wu", D, cfg.ffn_mult * D)
        (h,) = b.node("Mul", [gact, up], [f"l{i}_swiglu"])
        h = _linear(b, h, f"l{i}_wd", cfg.ffn_mult * D, D)
        (x,) = b.node("Add", [x, h], [f"l{i}_res2"])

    x = _rmsnorm(b, x, "norm_f", D)
    lm = _weight(b, "lm_head", (D, cfg.vocab_size), 0.02)
    (logits,) = b.node("MatMul", [x, lm], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    if with_presents:
        for i in range(cfg.n_layer):
            b.output(f"present_key_{i}", [B, Hkv, T, hd])
            b.output(f"present_value_{i}", [B, Hkv, T, hd])
    return b.model()


def build_llama_decode(
    cfg: LlamaConfig = TINY,
    *,
    batch: int = 1,
    max_len: int = 64,
    opset: int = 17,
    seed: int = 0,
    kv_dtype: str = "float32",
    scan_layers: bool = False,
    fused_attention: bool = False,
    chunk: int = 1,
) -> onnx_io.ModelProto:
    """Single-token decode over a fixed GQA KV cache; pos [B] per slot
    (continuous-batching-ready, like gpt2.build_gpt2_decode).

    chunk=k processes k tokens per call over the same fixed cache (the
    speculative-decoding verify step / chunked prefill — see
    gpt2.build_gpt2_decode).

    fused_attention=True (requires kv_dtype="int8"): each layer's GQA
    attention becomes one com.oriet FusedDecodeAttention kernel reading the
    int8 cache directly — no Expand-materialized heads, no dequantized fp32
    cache in device memory (ops/fused.py).

    kv_dtype="int8" carries the QDQ inside the graph exactly like the GPT-2
    decode graph (per-head scale inputs kv_scale_{key,value}_{i} [Hkv]).
    kv_dtype="int4" nibble-packs the GQA cache ([B,Hkv,L,hd/2] int8, two
    4-bit values per byte — half the int8 cache's bytes) with the
    same pack/unpack arithmetic as gpt2 (quant.pack_int4_kv inverts it).

    scan_layers=True emits the scan-over-layers form with stacked weights
    and a stacked cache interface (see gpt2.build_gpt2_decode)."""
    int4_kv = kv_dtype == "int4"
    int8_kv = (not int4_kv) and np.dtype(kv_dtype) == np.int8
    if int4_kv and (fused_attention or scan_layers):
        raise ValueError("int4 KV supports the plain decode graph only")
    if int4_kv and cfg.head_dim % 2:
        raise ValueError("int4 KV packs hd pairs: head_dim must be even")
    if fused_attention and not int8_kv:
        raise ValueError("fused_attention requires kv_dtype='int8'")
    if fused_attention and chunk != 1:
        raise ValueError("fused_attention supports chunk=1 only")
    if scan_layers:
        if fused_attention or chunk != 1:
            raise ValueError(
                "scan_layers is incompatible with fused_attention/chunk")
        return _build_llama_decode_scan(cfg, batch=batch, max_len=max_len,
                                        opset=opset, seed=seed,
                                        kv_dtype=kv_dtype)
    b = GraphBuilder("llama_decode", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T = batch, chunk
    D, H, Hkv, hd = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    L = max_len
    cache_np = np.int8 if (int8_kv or int4_kv) else np.float32
    cache_hd = hd // 2 if int4_kv else hd

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    pasts = [(b.input(f"past_key_{i}", [B, Hkv, L, cache_hd],
                      dtype=cache_np),
              b.input(f"past_value_{i}", [B, Hkv, L, cache_hd],
                      dtype=cache_np))
             for i in range(cfg.n_layer)]
    kv_scales = [(b.input(f"kv_scale_key_{i}", [Hkv]),
                  b.input(f"kv_scale_value_{i}", [Hkv]))
                 for i in range(cfg.n_layer)] if (int8_kv or int4_kv) \
        else None
    zp8 = b.init("kv_zp8", np.int8(0)) if int8_kv else None

    emb = _weight(b, "tok_embeddings", (cfg.vocab_size, D), 0.02)
    (x,) = b.node("Gather", [emb, ids], ["h0"], axis=0)

    arange = b.init("cache_positions", np.arange(L, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    cos_t, sin_t = _rope_tables(cfg)
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    if T == 1:
        (cos,) = b.node("Gather", [b.init("rope_cos", cos_t), pos],
                        ["cos_g"], axis=0)  # [B, hd]
        (cos,) = b.node("Reshape", [cos, b.init(
            "cs_shape", np.array([B, 1, 1, hd], np.int64))], ["cos4"])
        (sin,) = b.node("Gather", [b.init("rope_sin", sin_t), pos],
                        ["sin_g"], axis=0)
        (sin,) = b.node("Reshape", [sin, b.init("cs_shape2", np.array(
            [B, 1, 1, hd], np.int64))], ["sin4"])
        (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])
        (is_now4,) = b.node("Reshape", [is_now, b.init(
            "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
        (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
        (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
        (attn_bias4,) = b.node("Reshape", [attn_bias, b.init(
            "shape_B_1_1_L", np.array([B, 1, 1, L], np.int64))],
            ["attn_bias4"])
        gather_idx = None
    else:
        # chunk decode: token j at per-slot position pos+j (rope gathered
        # per token; window-scatter + per-query causal bias as in gpt2)
        tsteps = b.init("chunk_steps", np.arange(T, dtype=np.int64))
        (positions,) = b.node("Add", [pos2d, tsteps], ["positions"])  # [B,T]
        (cos,) = b.node("Gather", [b.init("rope_cos", cos_t), "positions"],
                        ["cos_g"], axis=0)            # [B, T, hd]
        (cos,) = b.node("Reshape", [cos, b.init(
            "cs_shape", np.array([B, 1, T, hd], np.int64))], ["cos4"])
        (sin,) = b.node("Gather", [b.init("rope_sin", sin_t), "positions"],
                        ["sin_g"], axis=0)
        (sin,) = b.node("Reshape", [sin, b.init("cs_shape2", np.array(
            [B, 1, T, hd], np.int64))], ["sin4"])
        (in_lo,) = b.node("GreaterOrEqual", [arange, pos2d], ["win_lo"])
        hi = b.init("chunk_hi", np.int64(T))
        (pos_hi,) = b.node("Add", [pos2d, hi], ["pos_hi"])
        (in_hi,) = b.node("Less", [arange, pos_hi], ["win_hi"])
        (in_win,) = b.node("And", [in_lo, in_hi], ["in_win"])
        (is_now4,) = b.node("Reshape", [in_win, b.init(
            "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
        # one-hot scatter matmul (see the gpt2 builder)
        (rel,) = b.node("Sub", [arange, pos2d], ["slot_rel"])
        (rel3,) = b.node("Reshape", [rel, b.init(
            "shape_B_L_1", np.array([B, L, 1], np.int64))], ["rel3"])
        steps_k = b.init("scatter_steps", np.arange(T, dtype=np.int64
                                                    ).reshape(1, 1, T))
        (oh,) = b.node("Equal", [rel3, steps_k], ["scatter_oh"])
        (ohf,) = b.node("Cast", [oh], ["scatter_ohf"], to=1)
        (oh4,) = b.node("Reshape", [ohf, b.init(
            "shape_B_1_L_T", np.array([B, 1, L, T], np.int64))],
            ["scatter_oh4"])
        tsteps3 = b.init("chunk_steps3", np.arange(T, dtype=np.int64
                                                   ).reshape(1, T, 1))
        (pos3,) = b.node("Reshape", [pos, b.init(
            "shape_B_1_1", np.array([B, 1, 1], np.int64))], ["pos3"])
        (qpos,) = b.node("Add", [pos3, tsteps3], ["qpos"])
        (validt,) = b.node("LessOrEqual", [arange, qpos], ["validt"])
        (attn_bias_t,) = b.node("Where", [validt, zero, neg], ["attn_bt"])
        (attn_bias4,) = b.node("Reshape", [attn_bias_t, b.init(
            "shape_B_1_T_L", np.array([B, 1, T, L], np.int64))],
            ["attn_bias4"])

    qshape = b.init("q_shape", np.array([B, T, H, hd], np.int64))
    kvshape = b.init("kv_shape", np.array([B, T, Hkv, hd], np.int64))
    merge_shape = b.init("ctx_merge_shape", np.array([B, T, D], np.int64))

    if int4_kv:
        from .q4 import q4_helpers

        _q4_pack, _q4_unpack, q4_sshape = q4_helpers(
            b, heads=Hkv, hd=hd, batch=B, max_len=L)

    for i in range(cfg.n_layer):
        xn = _rmsnorm(b, x, f"l{i}_attn_norm", D)
        q = _linear(b, xn, f"l{i}_wq", D, H * hd)
        k = _linear(b, xn, f"l{i}_wk", D, Hkv * hd)
        v = _linear(b, xn, f"l{i}_wv", D, Hkv * hd)

        def _heads(t, tag, shape):
            (r,) = b.node("Reshape", [t, shape], [f"l{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"l{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh = _apply_rope(b, _heads(q, "q", qshape), cos, sin,
                         f"l{i}_qrope", hd)
        kh = _apply_rope(b, _heads(k, "k", kvshape), cos, sin,
                         f"l{i}_krope", hd)
        vh = _heads(v, "v", kvshape)

        def _spread(t, tag):
            """[B,Hkv,T,hd] -> [B,Hkv,L,hd] one-hot scatter matmul."""
            if T == 1:
                return t
            src = t
            if cache_np == np.int8:
                (src,) = b.node("Cast", [t], [f"l{i}_{tag}_f"], to=1)
            (sp,) = b.node("MatMul", ["scatter_oh4", src],
                           [f"l{i}_{tag}_spread_f"])
            if cache_np == np.int8:
                (sp,) = b.node("Cast", [sp], [f"l{i}_{tag}_spread"], to=3)
            return sp

        pk, pv = pasts[i]
        if int8_kv:
            sk, sv = kv_scales[i]
            (kh8,) = b.node("QuantizeLinear", [kh, sk, zp8],
                            [f"l{i}_k_q8"], axis=1)
            (vh8,) = b.node("QuantizeLinear", [vh, sv, zp8],
                            [f"l{i}_v_q8"], axis=1)
            (kc8,) = b.node("Where", [is_now4, _spread(kh8, "k8"), pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, _spread(vh8, "v8"), pv],
                            [f"present_value_{i}"])
            if not fused_attention:
                (kc,) = b.node("DequantizeLinear", [kc8, sk, zp8],
                               [f"l{i}_k_dq"], axis=1)
                (vc,) = b.node("DequantizeLinear", [vc8, sv, zp8],
                               [f"l{i}_v_dq"], axis=1)
        elif int4_kv:
            # quantize + nibble-pack the new GQA k/v, update the packed
            # int8 cache, unpack + dequantize for the attention
            sk, sv = kv_scales[i]
            (sk4,) = b.node("Reshape", [sk, q4_sshape], [f"l{i}_sk4"])
            (sv4,) = b.node("Reshape", [sv, q4_sshape], [f"l{i}_sv4"])
            kq = _q4_pack(kh, sk4, f"l{i}_k")
            vq = _q4_pack(vh, sv4, f"l{i}_v")
            (kc8,) = b.node("Where", [is_now4, _spread(kq, "k8"), pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, _spread(vq, "v8"), pv],
                            [f"present_value_{i}"])
            kc = _q4_unpack(kc8, sk4, f"l{i}_k")
            vc = _q4_unpack(vc8, sv4, f"l{i}_v")
        else:
            (kc,) = b.node("Where", [is_now4, _spread(kh, "k"), pk],
                           [f"present_key_{i}"])
            (vc,) = b.node("Where", [is_now4, _spread(vh, "v"), pv],
                           [f"present_value_{i}"])

        if int8_kv and fused_attention:
            # GQA attention = ONE kernel over the int8 cache; query heads
            # share kv rows in the kernel — no Expand copy
            (ctx4,) = b.node("FusedDecodeAttention",
                             [qh, kc8, vc8, sk, sv, attn_bias4],
                             [f"l{i}_ctx4"], domain="com.oriet",
                             scale=float(1.0 / np.sqrt(hd)))
            (ctx_t,) = b.node("Transpose", [ctx4], [f"l{i}_ctx_tr"],
                              perm=[0, 2, 1, 3])
            (ctxt,) = b.node("Reshape", [ctx_t, merge_shape],
                             [f"l{i}_ctx_m"])
        else:
            ctxt = _attention_block(b, qh, i, cfg, B, T, kc, vc,
                                    attn_bias4, L)
        o = _linear(b, ctxt, f"l{i}_wo", D, D)
        (x,) = b.node("Add", [x, o], [f"l{i}_res1"])

        hn = _rmsnorm(b, x, f"l{i}_ffn_norm", D)
        gate = _linear(b, hn, f"l{i}_wg", D, cfg.ffn_mult * D)
        (gact,) = b.node("Sigmoid", [gate], [f"l{i}_gsig"])
        (gact,) = b.node("Mul", [gate, gact], [f"l{i}_silu"])
        up = _linear(b, hn, f"l{i}_wu", D, cfg.ffn_mult * D)
        (h,) = b.node("Mul", [gact, up], [f"l{i}_swiglu"])
        h = _linear(b, h, f"l{i}_wd", cfg.ffn_mult * D, D)
        (x,) = b.node("Add", [x, h], [f"l{i}_res2"])

    x = _rmsnorm(b, x, "norm_f", D)
    lm = _weight(b, "lm_head", (D, cfg.vocab_size), 0.02)
    (logits,) = b.node("MatMul", [x, lm], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    for i in range(cfg.n_layer):
        b.output(f"present_key_{i}", [B, Hkv, L, cache_hd], dtype=cache_np)
        b.output(f"present_value_{i}", [B, Hkv, L, cache_hd],
                 dtype=cache_np)
    return b.model()



def _build_llama_decode_scan(
    cfg: LlamaConfig,
    *,
    batch: int,
    max_len: int,
    opset: int,
    seed: int,
    kv_dtype: str,
) -> onnx_io.ModelProto:
    """Scan-over-layers llama decode (see gpt2._build_gpt2_decode_scan): the
    JAX package's `_build_llama_decode_scan`, node for node.

    Same seeded rng order as the per-layer builder (emb, then per layer
    wq/wk/wv/wo/wg/wu/wd, then lm_head), under the per-layer builder's
    names inside host_memo, so both forms share weights.
    Cache interface: past_key/past_value [n_layer,B,Hkv,max_len,hd],
    kv_scale_key/kv_scale_value [n_layer,Hkv] for int8.
    """
    b = GraphBuilder("llama_decode_scan", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T, ML = batch, 1, max_len
    D, H, Hkv, hd = cfg.dim, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    NL, FF = cfg.n_layer, cfg.ffn_mult * cfg.dim
    rep = H // Hkv
    int8_kv = np.dtype(kv_dtype) == np.int8
    cache_np = np.int8 if int8_kv else np.float32

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    b.input("past_key", [NL, B, Hkv, ML, hd], dtype=cache_np)
    b.input("past_value", [NL, B, Hkv, ML, hd], dtype=cache_np)
    if int8_kv:
        b.input("kv_scale_key", [NL, Hkv])
        b.input("kv_scale_value", [NL, Hkv])

    emb = _weight(b, "tok_embeddings", (cfg.vocab_size, D), 0.02)

    shapes = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
              "wo": (D, D), "wg": (D, FF), "wu": (D, FF), "wd": (FF, D)}
    per = {k: [] for k in shapes}
    for i in range(NL):
        for k, shape in shapes.items():
            per[k].append(b.g.initializers.pop(
                _weight(b, f"l{i}_{k}_w", shape, shape[0] ** -0.5)))
    stacks = {k: stacked(b.wkey + (f"stack_{k}",), v)
              for k, v in per.items()}
    stacks["attn_norm_w"] = np.ones((NL, D), np.float32)
    stacks["ffn_norm_w"] = np.ones((NL, D), np.float32)
    for name, arr in stacks.items():
        b.init(f"stack_{name}", arr)

    (x0,) = b.node("Gather", [emb, ids], ["h0"], axis=0)

    cos_t, sin_t = _rope_tables(cfg)
    (cos,) = b.node("Gather", [b.init("rope_cos", cos_t), pos], ["cos_g"],
                    axis=0)
    b.node("Reshape", [cos, b.init(
        "cs_shape", np.array([B, 1, 1, hd], np.int64))], ["cos4"])
    (sin,) = b.node("Gather", [b.init("rope_sin", sin_t), pos], ["sin_g"],
                    axis=0)
    b.node("Reshape", [sin, b.init("cs_shape2", np.array(
        [B, 1, 1, hd], np.int64))], ["sin4"])

    arange = b.init("cache_positions", np.arange(ML, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])
    b.node("Reshape", [is_now, b.init(
        "shape_B_1_L_1", np.array([B, 1, ML, 1], np.int64))], ["is_now4"])
    (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
    b.node("Reshape", [attn_bias, b.init(
        "shape_B_1_1_L", np.array([B, 1, 1, ML], np.int64))], ["attn_bias4"])

    # ---- Scan body: one llama layer ---------------------------------------
    bb = GraphBuilder("llama_layer", opset=opset)
    x_in = bb.input("x_in", [B, T, D])
    w = {name: bb.input(f"l_{name}", list(arr.shape[1:]))
         for name, arr in stacks.items()}
    pk = bb.input("l_past_k", [B, Hkv, ML, hd], dtype=cache_np)
    pv = bb.input("l_past_v", [B, Hkv, ML, hd], dtype=cache_np)
    if int8_kv:
        sk = bb.input("l_sk", [Hkv])
        sv = bb.input("l_sv", [Hkv])
        zp8 = bb.init("kv_zp8", np.int8(0))

    qshape = bb.init("q_shape", np.array([B, T, H, hd], np.int64))
    kvshape = bb.init("kv_shape", np.array([B, T, Hkv, hd], np.int64))
    sc = bb.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    merge = bb.init("merge_shape", np.array([B, T, D], np.int64))

    def _norm(x, wname, tag):
        (y,) = bb.node("SimplifiedLayerNormalization", [x, w[wname]],
                       [f"{tag}_y"], axis=-1, epsilon=1e-5)
        return y

    def _mm(x, wname, tag):
        (y,) = bb.node("MatMul", [x, w[wname]], [f"{tag}_y"])
        return y

    def _heads(t, tag, shape):
        (r,) = bb.node("Reshape", [t, shape], [f"{tag}_r"])
        (tr,) = bb.node("Transpose", [r], [f"{tag}_t"], perm=[0, 2, 1, 3])
        return tr

    def _rope(x, tag):
        half = bb.init(f"{tag}_half", np.array([hd // 2], np.int64))
        zero_i = bb.init(f"{tag}_zero", np.array([0], np.int64))
        end = bb.init(f"{tag}_end", np.array([hd], np.int64))
        ax = bb.init(f"{tag}_ax", np.array([-1], np.int64))
        (hi,) = bb.node("Slice", [x, half, end, ax], [f"{tag}_hi"])
        (lo,) = bb.node("Slice", [x, zero_i, half, ax], [f"{tag}_lo"])
        (nhi,) = bb.node("Neg", [hi], [f"{tag}_nhi"])
        (rot,) = bb.node("Concat", [nhi, lo], [f"{tag}_rot"], axis=-1)
        (xc,) = bb.node("Mul", [x, "cos4"], [f"{tag}_xc"])
        (xs,) = bb.node("Mul", [rot, "sin4"], [f"{tag}_xs"])
        (out,) = bb.node("Add", [xc, xs], [f"{tag}_roped"])
        return out

    def _expand(x, tag):
        if rep == 1:
            return x
        (u,) = bb.node("Unsqueeze", [x, bb.init(
            f"{tag}_u_ax", np.array([2], np.int64))], [f"{tag}_u"])
        eshape = bb.init(f"{tag}_eshape",
                         np.array([B, Hkv, rep, ML, hd], np.int64))
        (e,) = bb.node("Expand", [u, eshape], [f"{tag}_e"])
        mshape = bb.init(f"{tag}_mshape",
                         np.array([B, Hkv * rep, ML, hd], np.int64))
        (out,) = bb.node("Reshape", [e, mshape], [f"{tag}_exp"])
        return out

    xn = _norm(x_in, "attn_norm_w", "attn_norm")
    qh = _rope(_heads(_mm(xn, "wq", "q"), "qh", qshape), "qrope")
    kh = _rope(_heads(_mm(xn, "wk", "k"), "kh", kvshape), "krope")
    vh = _heads(_mm(xn, "wv", "v"), "vh", kvshape)

    if int8_kv:
        (kh8,) = bb.node("QuantizeLinear", [kh, sk, zp8], ["k_q8"], axis=1)
        (vh8,) = bb.node("QuantizeLinear", [vh, sv, zp8], ["v_q8"], axis=1)
        (kc8,) = bb.node("Where", ["is_now4", kh8, pk], ["present_k"])
        (vc8,) = bb.node("Where", ["is_now4", vh8, pv], ["present_v"])
        (kc,) = bb.node("DequantizeLinear", [kc8, sk, zp8], ["k_dq"], axis=1)
        (vc,) = bb.node("DequantizeLinear", [vc8, sv, zp8], ["v_dq"], axis=1)
    else:
        (kc,) = bb.node("Where", ["is_now4", kh, pk], ["present_k"])
        (vc,) = bb.node("Where", ["is_now4", vh, pv], ["present_v"])

    ke = _expand(kc, "kexp")
    ve = _expand(vc, "vexp")
    (kt,) = bb.node("Transpose", [ke], ["kT"], perm=[0, 1, 3, 2])
    (att,) = bb.node("MatMul", [qh, kt], ["scores"])
    (att,) = bb.node("Mul", [att, sc], ["scaled"])
    (att,) = bb.node("Add", [att, "attn_bias4"], ["masked"])
    (att,) = bb.node("Softmax", [att], ["probs"], axis=-1)
    (ctxt,) = bb.node("MatMul", [att, ve], ["ctx"])
    (ctxt,) = bb.node("Transpose", [ctxt], ["ctx_t"], perm=[0, 2, 1, 3])
    (ctxt,) = bb.node("Reshape", [ctxt, merge], ["ctx_m"])
    o = _mm(ctxt, "wo", "o")
    (x1,) = bb.node("Add", [x_in, o], ["res1"])

    hn = _norm(x1, "ffn_norm_w", "ffn_norm")
    gate = _mm(hn, "wg", "gate")
    (gact,) = bb.node("Sigmoid", [gate], ["gsig"])
    (gact,) = bb.node("Mul", [gate, gact], ["silu"])
    up = _mm(hn, "wu", "up")
    (h,) = bb.node("Mul", [gact, up], ["swiglu"])
    h = _mm(h, "wd", "down")
    (x2,) = bb.node("Add", [x1, h], ["res2"])

    bb.output(x2, [B, T, D])
    bb.output("present_k", [B, Hkv, ML, hd], dtype=cache_np)
    bb.output("present_v", [B, Hkv, ML, hd], dtype=cache_np)

    scan_ins = ([f"stack_{name}" for name in stacks]
                + ["past_key", "past_value"]
                + (["kv_scale_key", "kv_scale_value"] if int8_kv else []))
    (xf, _, _) = b.node(
        "Scan", [x0] + scan_ins,
        ["x_final", "present_key", "present_value"],
        body=bb.g, num_scan_inputs=len(scan_ins))

    xn = _rmsnorm(b, xf, "norm_f", D)
    lm = _weight(b, "lm_head", (D, cfg.vocab_size), 0.02)
    (logits,) = b.node("MatMul", [xn, lm], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    b.output("present_key", [NL, B, Hkv, ML, hd], dtype=cache_np)
    b.output("present_value", [NL, B, Hkv, ML, hd], dtype=cache_np)
    return b.model()
