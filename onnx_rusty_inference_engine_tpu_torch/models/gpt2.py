"""GPT-2 ONNX decoder builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/gpt2.py.

Emits the standard GPT-2 ONNX-export graph shape: Gather token+position
embeddings, per-block LayerNormalization -> fused-QKV MatMul -> Split ->
scaled-dot-product attention with additive causal mask -> projection ->
Gelu MLP, final LayerNorm, tied lm_head MatMul. Optionally takes
`past_key_i` / `past_value_i` inputs and emits `present_*` outputs
([B, n_head, P(+T), head_dim]) -- the decode-step graph. All shapes are
static (P and T fixed per graph). The same seed gives the JAX package's
graph node for node and weight for weight.

kv_dtype="int4" builds the nibble-packed KV cache (models/q4.py).
Inside `_builder.host_memo()` every build of one config and seed reuses the
weights (and the tied lm_head's transpose) the first one drew; the
Scan-over-layers decode graph (scan_layers=True) stacks the same per-layer
arrays, so both decode forms share their weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder, memo, stacked


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


TINY = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=4)
SMALL = GPT2Config()


def _weight_key(cfg: GPT2Config, seed: int) -> tuple:
    """What a build's weight draws depend on: the widths, depth and seed."""
    return ("gpt2", cfg.vocab_size, cfg.n_positions, cfg.n_embd,
            cfg.n_layer, cfg.n_head, seed)


def _weight(b: GraphBuilder, name: str, shape, scale: float) -> str:
    """A seeded weight drawn from b.rng (inside host_memo, the array drawn
    first for the same build key and name). `b.wkey` is `_weight_key`."""
    return b.init(name, memo(b.wkey + (name,), lambda: (
        b.rng.standard_normal(shape) * scale).astype(np.float32)))


def _lm_head(b: GraphBuilder) -> str:
    """The tied lm_head: wte transposed (inside host_memo, made once)."""
    return b.init("wte_T", memo(b.wkey + ("wte_T",), lambda: (
        np.ascontiguousarray(b.g.initializers["wte"].T))))


def _linear(b: GraphBuilder, x: str, name: str, d_in: int, d_out: int) -> str:
    w = _weight(b, f"{name}_w", (d_in, d_out), 0.02)
    bias = b.zeros(f"{name}_b", (d_out,))
    (y,) = b.node("MatMul", [x, w], [f"{name}_mm"])
    (y,) = b.node("Add", [y, bias], [f"{name}_y"])
    return y


def _layernorm(b: GraphBuilder, x: str, name: str, d: int) -> str:
    g = b.init(f"{name}_g", np.ones(d, np.float32))
    bb = b.zeros(f"{name}_b", (d,))
    (y,) = b.node("LayerNormalization", [x, g, bb], [f"{name}_y"],
                  axis=-1, epsilon=1e-5)
    return y


def build_gpt2(
    cfg: GPT2Config = TINY,
    *,
    batch: int = 1,
    seq_len: int = 16,
    past_len: int = 0,
    with_presents: bool = True,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    b = GraphBuilder("gpt2", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T, P = batch, seq_len, past_len
    D, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pasts = []
    for i in range(cfg.n_layer):
        if P > 0:
            pk = b.input(f"past_key_{i}", [B, H, P, hd])
            pv = b.input(f"past_value_{i}", [B, H, P, hd])
            pasts.append((pk, pv))
        else:
            pasts.append((None, None))

    wte = _weight(b, "wte", (cfg.vocab_size, D), 0.02)
    wpe = _weight(b, "wpe", (cfg.n_positions, D), 0.01)
    pos = b.init("positions", np.arange(P, P + T, dtype=np.int64))

    (tok,) = b.node("Gather", [wte, ids], ["tok_emb"], axis=0)
    (pe,) = b.node("Gather", [wpe, pos], ["pos_emb"], axis=0)
    (x,) = b.node("Add", [tok, pe], ["h0"])

    # additive causal mask over the concatenated [P+T] key axis
    total = P + T
    mask = np.zeros((1, 1, T, total), np.float32)
    q_idx = np.arange(T)[:, None] + P
    k_idx = np.arange(total)[None, :]
    mask[0, 0] = np.where(k_idx <= q_idx, 0.0, -1e9).astype(np.float32)
    mask_name = b.init("causal_mask", mask)
    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))

    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))

    for i in range(cfg.n_layer):
        ln1 = _layernorm(b, x, f"blk{i}_ln1", D)
        qkv = _linear(b, ln1, f"blk{i}_attn_qkv", D, 3 * D)
        q, k, v = b.node("Split", [qkv], [f"blk{i}_q", f"blk{i}_k", f"blk{i}_v"],
                         axis=-1, split=[D, D, D])

        def _heads(t: str, tag: str) -> str:
            (r,) = b.node("Reshape", [t, shape_split], [f"blk{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"blk{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")
        pk, pv = pasts[i]
        if pk is not None:
            (kh,) = b.node("Concat", [pk, kh], [f"blk{i}_k_cat"], axis=2)
            (vh,) = b.node("Concat", [pv, vh], [f"blk{i}_v_cat"], axis=2)
        if with_presents:
            b.node("Identity", [kh], [f"present_key_{i}"])
            b.node("Identity", [vh], [f"present_value_{i}"])

        (kt,) = b.node("Transpose", [kh], [f"blk{i}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"blk{i}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"blk{i}_scaled"])
        (att,) = b.node("Add", [att, mask_name], [f"blk{i}_masked"])
        (att,) = b.node("Softmax", [att], [f"blk{i}_probs"], axis=-1)
        (ctxt,) = b.node("MatMul", [att, vh], [f"blk{i}_ctx"])
        (ctxt,) = b.node("Transpose", [ctxt], [f"blk{i}_ctx_t"], perm=[0, 2, 1, 3])
        (ctxt,) = b.node("Reshape", [ctxt, shape_merge], [f"blk{i}_ctx_m"])
        proj = _linear(b, ctxt, f"blk{i}_attn_proj", D, D)
        (x,) = b.node("Add", [x, proj], [f"blk{i}_res1"])

        ln2 = _layernorm(b, x, f"blk{i}_ln2", D)
        h = _linear(b, ln2, f"blk{i}_mlp_fc", D, 4 * D)
        (h,) = b.node("Gelu", [h], [f"blk{i}_gelu"], approximate="tanh")
        h = _linear(b, h, f"blk{i}_mlp_proj", 4 * D, D)
        (x,) = b.node("Add", [x, h], [f"blk{i}_res2"])

    x = _layernorm(b, x, "ln_f", D)
    wte_t = _lm_head(b)
    (logits,) = b.node("MatMul", [x, wte_t], ["logits"])

    b.output(logits, [B, T, cfg.vocab_size])
    if with_presents:
        for i in range(cfg.n_layer):
            b.output(f"present_key_{i}", [B, H, total, hd])
            b.output(f"present_value_{i}", [B, H, total, hd])
    return b.model()


def build_gpt2_decode(
    cfg: GPT2Config = TINY,
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
    """Single-token decode step with a FIXED-size KV cache (static shapes:
    the same graph for every step of the generation loop).

    fused_attention=True (requires kv_dtype="int8") replaces each layer's
    attention chain with one com.oriet FusedDecodeAttention node -- one
    kernel reading the int8 cache directly (ops/fused.py).

    chunk=k processes k tokens per call over the same fixed cache
    (input_ids [B,k]; token j sits at per-slot position pos+j; causal
    within the chunk): the verify step of speculative decoding and the
    building block for chunked prefill. Writes all k cache rows; rows
    past the accepted prefix are harmless — the validity mask ignores
    slots beyond the current position until they're overwritten.

    Inputs: input_ids [B,1] int64, pos [B] int64 (PER-SLOT current
    positions — each batch row may be at a different generation offset),
    past_key_i / past_value_i [B,H,max_len,hd].
    Outputs: logits [B,1,vocab], updated present_key_i / present_value_i
    [B,H,max_len,hd] (in-place-style update at `pos` via a one-hot Where —
    pure ONNX ops, no dynamic shapes).

    kv_dtype="int8" emits the INT8 KV cache (BASELINE.json config #5):
    pasts/presents are int8 *inside the graph* (QuantizeLinear on the new
    k/v, int8-domain Where update, DequantizeLinear feeding attention), so
    the cache is stored and read at a quarter of fp32's bytes. Per-head
    scales arrive
    as runtime inputs `kv_scale_{key,value}_{i}` [H] (calibrated from the
    prefill by generate.Generator).

    Weights are seeded identically to build_gpt2(), so prefill and decode
    graphs share parameters.

    kv_dtype="int4" nibble-packs the cache: TWO 4-bit values in one int8
    byte along hd (p = (q0+8) + 16*q1, q in [-8, 7]), so pasts/presents are
    [B,H,max_len,hd/2] int8 -- half the int8 cache's bytes. The new k/v
    are quantized and packed in the graph, the cache updated in the packed
    domain, and the whole cache unpacked and dequantized for the attention
    (models/q4.py); quant.pack_int4_kv packs a prefill into the same form.

    scan_layers=True emits the layer stack as ONE ONNX Scan node over
    STACKED per-layer weights (`_build_gpt2_decode_scan`): the cache
    interface becomes stacked, inputs past_key/past_value
    [n_layer,B,H,max_len,hd] (+ kv_scale_key/kv_scale_value [n_layer,H] for
    int8), outputs present_key/present_value with the same shapes. It
    takes neither fused_attention nor chunk nor the int4 KV cache, as in
    JAX (ValueError).
    """
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
        return _build_gpt2_decode_scan(cfg, batch=batch, max_len=max_len,
                                       opset=opset, seed=seed,
                                       kv_dtype=kv_dtype)
    b = GraphBuilder("gpt2_decode", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T = batch, chunk
    D, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim

    # per-slot positions: each batch row decodes at its own cache offset —
    # the graph shape continuous batching needs (serve_llm.DecodeServer
    # admits new sequences into free slots while others are mid-generation)
    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    cache_np = np.int8 if (int8_kv or int4_kv) else np.float32
    cache_hd = hd // 2 if int4_kv else hd
    pasts = [(b.input(f"past_key_{i}", [B, H, max_len, cache_hd],
                      dtype=cache_np),
              b.input(f"past_value_{i}", [B, H, max_len, cache_hd],
                      dtype=cache_np))
             for i in range(cfg.n_layer)]
    kv_scales = [(b.input(f"kv_scale_key_{i}", [H]),
                  b.input(f"kv_scale_value_{i}", [H]))
                 for i in range(cfg.n_layer)] if (int8_kv or int4_kv) \
        else None
    zp8 = b.init("kv_zp8", np.int8(0)) if int8_kv else None

    wte = _weight(b, "wte", (cfg.vocab_size, D), 0.02)
    wpe = _weight(b, "wpe", (cfg.n_positions, D), 0.01)

    (tok,) = b.node("Gather", [wte, ids], ["tok_emb"], axis=0)  # [B,T,D]
    arange = b.init("cache_positions", np.arange(max_len, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    if T == 1:
        (pe,) = b.node("Gather", [wpe, pos], ["pos_emb"], axis=0)  # [B,D]
        (pe,) = b.node("Reshape", [pe, b.init(
            "shape_B_1_D", np.array([B, 1, D], np.int64))], ["pos_emb3"])
    else:
        # chunk decode: token j sits at per-slot position pos + j
        tsteps = b.init("chunk_steps", np.arange(T, dtype=np.int64))
        (positions,) = b.node("Add", [pos2d, tsteps], ["positions"])  # [B,T]
        (pe,) = b.node("Gather", [wpe, positions], ["pos_emb3"], axis=0)
    (x,) = b.node("Add", [tok, pe], ["h0"])
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    if T == 1:
        (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])  # [B, L]
        (is_now4,) = b.node("Reshape", [is_now, b.init(
            "shape_B_1_L_1", np.array([B, 1, max_len, 1], np.int64))],
            ["is_now4"])
        (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
        (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
        (attn_bias4,) = b.node("Reshape", [attn_bias, b.init(
            "shape_B_1_1_L", np.array([B, 1, 1, max_len], np.int64))],
            ["attn_bias4"])
        gather_idx = None
    else:
        # window mask: cache slot l receives new token j = l - pos when
        # 0 <= j < T. GatherElements picks that token out of the chunk.
        (in_lo,) = b.node("GreaterOrEqual", [arange, pos2d], ["win_lo"])
        hi = b.init("chunk_hi", np.int64(T))
        (pos_hi,) = b.node("Add", [pos2d, hi], ["pos_hi"])
        (in_hi,) = b.node("Less", [arange, pos_hi], ["win_hi"])
        (in_win,) = b.node("And", [in_lo, in_hi], ["in_win"])  # [B, L]
        (is_now4,) = b.node("Reshape", [in_win, b.init(
            "shape_B_1_L_1", np.array([B, 1, max_len, 1], np.int64))],
            ["is_now4"])
        # scatter matrix: onehot[b, l, j] = (l - pos_b == j). The chunk
        # write becomes a [B,1,L,T] x [B,H,T,hd] batched MATMUL, not a
        # gather (GatherElements with [B,H,L,hd] int64
        # indices lowered catastrophically on the TPU)
        (rel,) = b.node("Sub", [arange, pos2d], ["slot_rel"])   # [B, L]
        (rel3,) = b.node("Reshape", [rel, b.init(
            "shape_B_L_1", np.array([B, max_len, 1], np.int64))], ["rel3"])
        steps_k = b.init("scatter_steps", np.arange(T, dtype=np.int64
                                                    ).reshape(1, 1, T))
        (oh,) = b.node("Equal", [rel3, steps_k], ["scatter_oh"])
        (ohf,) = b.node("Cast", [oh], ["scatter_ohf"], to=1)    # f32
        (oh4,) = b.node("Reshape", [ohf, b.init(
            "shape_B_1_L_T", np.array([B, 1, max_len, T], np.int64))],
            ["scatter_oh4"])
        # per-query-position causal bias [B, 1, T, L]: key l valid for
        # query j when l <= pos + j
        tsteps3 = b.init("chunk_steps3", np.arange(T, dtype=np.int64
                                                   ).reshape(1, T, 1))
        (pos3,) = b.node("Reshape", [pos, b.init(
            "shape_B_1_1", np.array([B, 1, 1], np.int64))], ["pos3"])
        (qpos,) = b.node("Add", [pos3, tsteps3], ["qpos"])       # [B,T,1]
        (validt,) = b.node("LessOrEqual", [arange, qpos], ["validt"])
        (attn_bias_t,) = b.node("Where", [validt, zero, neg], ["attn_bt"])
        (attn_bias4,) = b.node("Reshape", [attn_bias_t, b.init(
            "shape_B_1_T_L", np.array([B, 1, T, max_len], np.int64))],
            ["attn_bias4"])

    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))

    if int4_kv:
        from .q4 import q4_helpers

        _q4_pack, _q4_unpack, q4_sshape = q4_helpers(
            b, heads=H, hd=hd, batch=B, max_len=max_len)

    for i in range(cfg.n_layer):
        ln1 = _layernorm(b, x, f"blk{i}_ln1", D)
        qkv = _linear(b, ln1, f"blk{i}_attn_qkv", D, 3 * D)
        q, k, v = b.node("Split", [qkv], [f"blk{i}_q", f"blk{i}_k", f"blk{i}_v"],
                         axis=-1, split=[D, D, D])

        def _heads(t: str, tag: str) -> str:
            (r,) = b.node("Reshape", [t, shape_split], [f"blk{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"blk{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr  # [B,H,1,hd]

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")

        def _spread(t: str, tag: str) -> str:
            """[B,H,T,hd] -> [B,H,L,hd] via the one-hot scatter matmul;
            exact for int8 payloads (|v| <= 127 in f32), cast back."""
            if T == 1:
                return t
            src = t
            if cache_np == np.int8:
                (src,) = b.node("Cast", [t], [f"blk{i}_{tag}_f"], to=1)
            (sp,) = b.node("MatMul", ["scatter_oh4", src],
                           [f"blk{i}_{tag}_spread_f"])
            if cache_np == np.int8:
                (sp,) = b.node("Cast", [sp], [f"blk{i}_{tag}_spread"],
                               to=3)  # int8
            return sp

        pk, pv = pasts[i]
        if int8_kv:
            # quantize the new k/v per head, update the cache in the int8
            # domain, dequantize for the attention contractions
            sk, sv = kv_scales[i]
            (kh8,) = b.node("QuantizeLinear", [kh, sk, zp8],
                            [f"blk{i}_k_q8"], axis=1)
            (vh8,) = b.node("QuantizeLinear", [vh, sv, zp8],
                            [f"blk{i}_v_q8"], axis=1)
            (kc8,) = b.node("Where", [is_now4, _spread(kh8, "k8"), pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, _spread(vh8, "v8"), pv],
                            [f"present_value_{i}"])
            if not fused_attention:
                (kc,) = b.node("DequantizeLinear", [kc8, sk, zp8],
                               [f"blk{i}_k_dq"], axis=1)
                (vc,) = b.node("DequantizeLinear", [vc8, sv, zp8],
                               [f"blk{i}_v_dq"], axis=1)
        elif int4_kv:
            # quantize + nibble-pack the new k/v, update the cache in the
            # packed int8 domain, unpack + dequantize for the attention
            sk, sv = kv_scales[i]
            (sk4,) = b.node("Reshape", [sk, q4_sshape], [f"blk{i}_sk4"])
            (sv4,) = b.node("Reshape", [sv, q4_sshape], [f"blk{i}_sv4"])
            kq = _q4_pack(kh, sk4, f"blk{i}_k")
            vq = _q4_pack(vh, sv4, f"blk{i}_v")
            (kc8,) = b.node("Where", [is_now4, _spread(kq, "k8"), pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, _spread(vq, "v8"), pv],
                            [f"present_value_{i}"])
            kc = _q4_unpack(kc8, sk4, f"blk{i}_k")
            vc = _q4_unpack(vc8, sv4, f"blk{i}_v")
        else:
            # scatter new k/v into the fixed cache at `pos`
            (kc,) = b.node("Where", [is_now4, _spread(kh, "k"), pk],
                           [f"present_key_{i}"])
            (vc,) = b.node("Where", [is_now4, _spread(vh, "v"), pv],
                           [f"present_value_{i}"])

        if int8_kv and fused_attention:
            # whole attention = ONE kernel over the int8 cache
            # (ops/fused.py FusedDecodeAttention; never materializes the
            # dequantized cache in HBM)
            (ctxt,) = b.node("FusedDecodeAttention",
                             [qh, kc8, vc8, sk, sv, attn_bias4],
                             [f"blk{i}_ctx"], domain="com.oriet",
                             scale=float(1.0 / np.sqrt(hd)))
        else:
            (kt,) = b.node("Transpose", [kc], [f"blk{i}_kT"],
                           perm=[0, 1, 3, 2])
            (att,) = b.node("MatMul", [qh, kt], [f"blk{i}_scores"])
            (att,) = b.node("Mul", [att, scale], [f"blk{i}_scaled"])
            (att,) = b.node("Add", [att, attn_bias4], [f"blk{i}_masked"])
            (att,) = b.node("Softmax", [att], [f"blk{i}_probs"], axis=-1)
            (ctxt,) = b.node("MatMul", [att, vc], [f"blk{i}_ctx"])
        (ctxt,) = b.node("Transpose", [ctxt], [f"blk{i}_ctx_t"], perm=[0, 2, 1, 3])
        (ctxt,) = b.node("Reshape", [ctxt, shape_merge], [f"blk{i}_ctx_m"])
        proj = _linear(b, ctxt, f"blk{i}_attn_proj", D, D)
        (x,) = b.node("Add", [x, proj], [f"blk{i}_res1"])

        ln2 = _layernorm(b, x, f"blk{i}_ln2", D)
        h = _linear(b, ln2, f"blk{i}_mlp_fc", D, 4 * D)
        (h,) = b.node("Gelu", [h], [f"blk{i}_gelu"], approximate="tanh")
        h = _linear(b, h, f"blk{i}_mlp_proj", 4 * D, D)
        (x,) = b.node("Add", [x, h], [f"blk{i}_res2"])

    x = _layernorm(b, x, "ln_f", D)
    wte_t = _lm_head(b)
    (logits,) = b.node("MatMul", [x, wte_t], ["logits"])

    b.output(logits, [B, T, cfg.vocab_size])
    for i in range(cfg.n_layer):
        b.output(f"present_key_{i}", [B, H, max_len, cache_hd],
                 dtype=cache_np)
        b.output(f"present_value_{i}", [B, H, max_len, cache_hd],
                 dtype=cache_np)
    return b.model()


def _build_gpt2_decode_scan(
    cfg: GPT2Config,
    *,
    batch: int,
    max_len: int,
    opset: int,
    seed: int,
    kv_dtype: str,
) -> onnx_io.ModelProto:
    """Scan-over-layers decode graph (see build_gpt2_decode's docstring):
    the JAX package's `_build_gpt2_decode_scan`, node for node.

    Weights are drawn from the SAME seeded rng in the SAME order as the
    per-layer builder (wte, wpe, then per layer qkv/proj/fc/mproj), under
    the per-layer builder's names inside host_memo, so the per-layer and
    scan-form graphs are parameter-identical and the prefill graph
    (build_gpt2, same seed) still pairs with either.
    """
    b = GraphBuilder("gpt2_decode_scan", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T, ML = batch, 1, max_len
    D, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim
    NL = cfg.n_layer
    int8_kv = np.dtype(kv_dtype) == np.int8
    cache_np = np.int8 if int8_kv else np.float32

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    b.input("past_key", [NL, B, H, ML, hd], dtype=cache_np)
    b.input("past_value", [NL, B, H, ML, hd], dtype=cache_np)
    if int8_kv:
        b.input("kv_scale_key", [NL, H])
        b.input("kv_scale_value", [NL, H])

    wte = _weight(b, "wte", (cfg.vocab_size, D), 0.02)
    _weight(b, "wpe", (cfg.n_positions, D), 0.01)

    # stacked per-layer weights, rng order matching the per-layer builder
    shapes = {"qkv_w": ("attn_qkv", (D, 3 * D)),
              "proj_w": ("attn_proj", (D, D)),
              "fc_w": ("mlp_fc", (D, 4 * D)),
              "mproj_w": ("mlp_proj", (4 * D, D))}
    per = {k: [] for k in shapes}
    for i in range(NL):
        for k, (name, shape) in shapes.items():
            per[k].append(b.g.initializers.pop(
                _weight(b, f"blk{i}_{name}_w", shape, 0.02)))
    stacks = {
        "ln1_g": np.ones((NL, D), np.float32),
        "ln1_b": np.zeros((NL, D), np.float32),
        "qkv_w": per["qkv_w"],
        "qkv_b": np.zeros((NL, 3 * D), np.float32),
        "proj_w": per["proj_w"],
        "proj_b": np.zeros((NL, D), np.float32),
        "ln2_g": np.ones((NL, D), np.float32),
        "ln2_b": np.zeros((NL, D), np.float32),
        "fc_w": per["fc_w"],
        "fc_b": np.zeros((NL, 4 * D), np.float32),
        "mproj_w": per["mproj_w"],
        "mproj_b": np.zeros((NL, D), np.float32),
    }
    for name, arr in stacks.items():
        if isinstance(arr, list):
            arr = stacks[name] = stacked(b.wkey + (f"stack_{name}",), arr)
        b.init(f"stack_{name}", arr)

    # embeddings + per-slot position bookkeeping (shared across layers,
    # captured by the Scan body from the outer scope)
    (tok,) = b.node("Gather", [wte, ids], ["tok_emb"], axis=0)
    (pe,) = b.node("Gather", ["wpe", pos], ["pos_emb"], axis=0)
    (pe,) = b.node("Reshape", [pe, b.init(
        "shape_B_1_D", np.array([B, 1, D], np.int64))], ["pos_emb3"])
    (x0,) = b.node("Add", [tok, pe], ["h0"])

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

    # ---- Scan body: one transformer layer ---------------------------------
    bb = GraphBuilder("gpt2_layer", opset=opset)
    x_in = bb.input("x_in", [B, T, D])                    # state
    w = {name: bb.input(f"l_{name}", list(arr.shape[1:]))
         for name, arr in stacks.items()}                 # scan-input slices
    pk = bb.input("l_past_k", [B, H, ML, hd], dtype=cache_np)
    pv = bb.input("l_past_v", [B, H, ML, hd], dtype=cache_np)
    if int8_kv:
        sk = bb.input("l_sk", [H])
        sv = bb.input("l_sv", [H])
        zp8 = bb.init("kv_zp8", np.int8(0))

    scale = bb.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = bb.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = bb.init("shape_btd", np.array([B, T, D], np.int64))

    def _lin(x, wname, bname, tag):
        (y,) = bb.node("MatMul", [x, w[wname]], [f"{tag}_mm"])
        (y,) = bb.node("Add", [y, w[bname]], [f"{tag}_y"])
        return y

    def _ln(x, g, bias, tag):
        (y,) = bb.node("LayerNormalization", [x, w[g], w[bias]], [f"{tag}_y"],
                       axis=-1, epsilon=1e-5)
        return y

    ln1 = _ln(x_in, "ln1_g", "ln1_b", "ln1")
    qkv = _lin(ln1, "qkv_w", "qkv_b", "attn_qkv")
    q, k, v = bb.node("Split", [qkv], ["q", "k", "v"], axis=-1,
                      split=[D, D, D])

    def _heads(t, tag):
        (r,) = bb.node("Reshape", [t, shape_split], [f"{tag}_r"])
        (tr,) = bb.node("Transpose", [r], [f"{tag}_t"], perm=[0, 2, 1, 3])
        return tr

    qh, kh, vh = _heads(q, "qh"), _heads(k, "kh"), _heads(v, "vh")
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

    (kt,) = bb.node("Transpose", [kc], ["kT"], perm=[0, 1, 3, 2])
    (att,) = bb.node("MatMul", [qh, kt], ["scores"])
    (att,) = bb.node("Mul", [att, scale], ["scaled"])
    (att,) = bb.node("Add", [att, "attn_bias4"], ["masked"])
    (att,) = bb.node("Softmax", [att], ["probs"], axis=-1)
    (ctxt,) = bb.node("MatMul", [att, vc], ["ctx"])
    (ctxt,) = bb.node("Transpose", [ctxt], ["ctx_t"], perm=[0, 2, 1, 3])
    (ctxt,) = bb.node("Reshape", [ctxt, shape_merge], ["ctx_m"])
    proj = _lin(ctxt, "proj_w", "proj_b", "attn_proj")
    (x1,) = bb.node("Add", [x_in, proj], ["res1"])

    ln2 = _ln(x1, "ln2_g", "ln2_b", "ln2")
    h = _lin(ln2, "fc_w", "fc_b", "mlp_fc")
    (h,) = bb.node("Gelu", [h], ["gelu"], approximate="tanh")
    h = _lin(h, "mproj_w", "mproj_b", "mlp_proj")
    (x2,) = bb.node("Add", [x1, h], ["res2"])

    bb.output(x2, [B, T, D])                              # state out
    bb.output("present_k", [B, H, ML, hd], dtype=cache_np)  # scan outputs
    bb.output("present_v", [B, H, ML, hd], dtype=cache_np)

    # ---- the Scan node -----------------------------------------------------
    scan_ins = ([f"stack_{name}" for name in stacks]
                + ["past_key", "past_value"]
                + (["kv_scale_key", "kv_scale_value"] if int8_kv else []))
    (xf, _, _) = b.node(
        "Scan", [x0] + scan_ins,
        ["x_final", "present_key", "present_value"],
        body=bb.g, num_scan_inputs=len(scan_ins))

    xn = _layernorm(b, xf, "ln_f", D)
    wte_t = _lm_head(b)
    (logits,) = b.node("MatMul", [xn, wte_t], ["logits"])

    b.output(logits, [B, T, cfg.vocab_size])
    b.output("present_key", [NL, B, H, ML, hd], dtype=cache_np)
    b.output("present_value", [NL, B, H, ML, hd], dtype=cache_np)
    return b.model()
