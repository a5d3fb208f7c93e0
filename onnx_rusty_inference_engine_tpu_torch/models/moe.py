"""Mixture-of-Experts decoder (switch-style top-1 routing): the port's copy
of onnx_rusty_inference_engine_tpu/models/moe.py.

Routing with static shapes: the router's top-1 choice becomes a OneHot
matrix, and expert dispatch and combine are elementwise masks around one
batched MatMul over the stacked expert weights [E, D, F]:

    oh[n, e]    = OneHot(argmax(router(x)))          # [N, E]
    xe[e, n, :] = oh[n, e] * x[n, :]                 # a mask, not a gather
    h[e]        = relu(xe[e] @ W1[e]) @ W2[e]        # one batched MatMul
    y[n]        = sum_e oh[n, e] * gate[n] * h[e, n]

Every token visits every expert with a zero row unless routed there
(dense dispatch, capacity = all tokens): the work scales with E, and no
data-dependent shape appears. The stacked [E, N, D] @ [E, D, F] product is
3-D, so quant.quantize_weights_int4 leaves it floating; it runs as a
batched fp32-exact MatMul (utils/fp32.py), as every emitter product does.
ArgMax picks the first of equal maxima, as the JAX package's does.

Inside `_builder.host_memo()` every build of one config and seed reuses
the weights the first one drew (the prefill and decode graphs draw the
same weights in the same order). The same config and seed give the JAX
package's ONNX bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder
from .gpt2 import _layernorm, _lm_head, _linear, _weight


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 256
    n_positions: int = 64
    n_embd: int = 64
    n_layer: int = 2
    n_head: int = 4
    n_expert: int = 4
    d_ff: int = 128

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


TINY = MoEConfig()


def _weight_key(cfg: MoEConfig, seed: int) -> tuple:
    """What a build's weight draws depend on: the widths, depth and seed."""
    return ("moe", cfg.vocab_size, cfg.n_positions, cfg.n_embd,
            cfg.n_layer, cfg.n_head, cfg.n_expert, cfg.d_ff, seed)


def build_moe(
    cfg: MoEConfig = TINY,
    *,
    batch: int = 1,
    seq_len: int = 16,
    opset: int = 17,
    seed: int = 0,
    with_presents: bool = False,
) -> onnx_io.ModelProto:
    """Causal MoE decoder forward: input_ids [B,T] -> logits [B,T,V];
    also emits router_probs_{i} [B*T, E] per layer for load inspection.
    with_presents=True additionally emits present_key_i/present_value_i
    [B,H,T,hd] — the prefill interface the Generator/DecodeServer
    seed their decode cache from (same contract as gpt2)."""
    b = GraphBuilder("moe", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T = batch, seq_len
    D, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim
    E, F = cfg.n_expert, cfg.d_ff
    N = B * T

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    wte = _weight(b, "wte", (cfg.vocab_size, D), 0.02)
    wpe = _weight(b, "wpe", (cfg.n_positions, D), 0.01)
    pos = b.init("positions", np.arange(T, dtype=np.int64))
    (tok,) = b.node("Gather", [wte, ids], ["tok_emb"], axis=0)
    (pe,) = b.node("Gather", [wpe, pos], ["pos_emb"], axis=0)
    (x,) = b.node("Add", [tok, pe], ["h0"])

    mask = np.where(np.arange(T)[None, :] <= np.arange(T)[:, None],
                    0.0, -1e9).astype(np.float32).reshape(1, 1, T, T)
    b.init("causal_mask", mask)
    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))
    shape_nd = b.init("shape_nd", np.array([N, D], np.int64))
    shape_n1d = b.init("shape_n1d", np.array([N, 1, D], np.int64))
    shape_ne1 = b.init("shape_ne1", np.array([N, E, 1], np.int64))
    b.init("oh_depth", np.int64(E))
    b.init("oh_vals", np.array([0.0, 1.0], np.float32))
    b.init("sum_axes", np.array([1], np.int64))  # ReduceSum-13 input form

    for i in range(cfg.n_layer):
        # -- standard causal self-attention ---------------------------------
        ln1 = _layernorm(b, x, f"blk{i}_ln1", D)
        qkv = _linear(b, ln1, f"blk{i}_attn_qkv", D, 3 * D)
        q, k, v = b.node("Split", [qkv],
                         [f"blk{i}_q", f"blk{i}_k", f"blk{i}_v"],
                         axis=-1, split=[D, D, D])

        def _heads(t, tag):
            (r,) = b.node("Reshape", [t, shape_split], [f"blk{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"blk{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")
        if with_presents:
            b.node("Identity", [kh], [f"present_key_{i}"])
            b.node("Identity", [vh], [f"present_value_{i}"])
        (kt,) = b.node("Transpose", [kh], [f"blk{i}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"blk{i}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"blk{i}_scaled"])
        (att,) = b.node("Add", [att, "causal_mask"], [f"blk{i}_masked"])
        (att,) = b.node("Softmax", [att], [f"blk{i}_probs"], axis=-1)
        (c,) = b.node("MatMul", [att, vh], [f"blk{i}_ctx"])
        (c,) = b.node("Transpose", [c], [f"blk{i}_ctx_t"], perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, shape_merge], [f"blk{i}_ctx_m"])
        proj = _linear(b, c, f"blk{i}_attn_proj", D, D)
        (x,) = b.node("Add", [x, proj], [f"blk{i}_res1"])

        # -- MoE FFN ---------------------------------------------------------
        ln2 = _layernorm(b, x, f"blk{i}_ln2", D)
        (xt,) = b.node("Reshape", [ln2, shape_nd], [f"blk{i}_tokens"])

        wr = _weight(b, f"blk{i}_router_w", (D, E), 0.02)
        (rl,) = b.node("MatMul", [xt, wr], [f"blk{i}_router_logits"])
        (rp,) = b.node("Softmax", [rl], [f"router_probs_{i}"], axis=-1)
        (sel,) = b.node("ArgMax", [rp], [f"blk{i}_sel"], axis=-1,
                        keepdims=0)                         # [N]
        (oh,) = b.node("OneHot", [sel, "oh_depth", "oh_vals"],
                       [f"blk{i}_oh"], axis=-1)             # [N, E] f32
        (gate,) = b.node("ReduceMax", [rp], [f"blk{i}_gate"], axes=[-1],
                         keepdims=1)                        # [N, 1]

        # dispatch: xe[n, e, d] = oh[n, e] * x[n, d] -> transpose [E, N, D]
        (oh3,) = b.node("Reshape", [oh, shape_ne1], [f"blk{i}_oh3"])
        (x3,) = b.node("Reshape", [xt, shape_n1d], [f"blk{i}_x3"])
        (xe,) = b.node("Mul", [oh3, x3], [f"blk{i}_disp"])   # [N, E, D]
        (xe,) = b.node("Transpose", [xe], [f"blk{i}_disp_t"],
                       perm=[1, 0, 2])                       # [E, N, D]

        w1 = _weight(b, f"blk{i}_exp_w1", (E, D, F), D ** -0.5)
        w2 = _weight(b, f"blk{i}_exp_w2", (E, F, D), F ** -0.5)
        (he,) = b.node("MatMul", [xe, w1], [f"blk{i}_exp_h"])  # [E, N, F]
        (he,) = b.node("Relu", [he], [f"blk{i}_exp_act"])
        (ye,) = b.node("MatMul", [he, w2], [f"blk{i}_exp_y"])  # [E, N, D]

        # combine: y[n, d] = sum_e oh[n, e] * ye[e, n, d], then gate
        (ye,) = b.node("Transpose", [ye], [f"blk{i}_exp_y_t"],
                       perm=[1, 0, 2])                       # [N, E, D]
        (yw,) = b.node("Mul", [ye, f"blk{i}_oh3"], [f"blk{i}_exp_sel"])
        (y,) = b.node("ReduceSum", [yw, "sum_axes"], [f"blk{i}_comb"],
                      keepdims=0)                            # [N, D]
        (y,) = b.node("Mul", [y, gate], [f"blk{i}_gated"])
        (y,) = b.node("Reshape", [y, shape_merge], [f"blk{i}_moe_out"])
        (x,) = b.node("Add", [x, y], [f"blk{i}_res2"])

    x = _layernorm(b, x, "ln_f", D)
    wte_t = _lm_head(b)
    (logits,) = b.node("MatMul", [x, wte_t], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    if with_presents:
        for i in range(cfg.n_layer):
            b.output(f"present_key_{i}", [B, H, T, hd])
            b.output(f"present_value_{i}", [B, H, T, hd])
    for i in range(cfg.n_layer):
        b.output(f"router_probs_{i}", [N, cfg.n_expert])
    return b.model()


def moe_param_sharding(mesh, n_parts: int):
    """Expert-parallel sharding rule: stacked expert weights [E, D, F]
    split on the EXPERT axis over "model"; everything else replicated.
    A sharded Engine runs each expert MatMul on its rank's experts and
    gathers the [E, N, F] product along E (parallel/spmd.py, route c)."""
    from ..parallel.sharding import placements, replicated

    def rule(name, arr):
        if "_exp_w" in name and arr.ndim == 3 and arr.shape[0] % n_parts == 0:
            return placements(mesh, {"model": 0})
        return replicated(mesh)

    return rule


def build_moe_decode(
    cfg: MoEConfig = TINY,
    *,
    batch: int = 1,
    max_len: int = 64,
    opset: int = 17,
    seed: int = 0,
    kv_dtype: str = "float32",
    chunk: int = 1,
) -> onnx_io.ModelProto:
    """MoE decode step over a fixed KV cache — same per-slot `pos [B]`
    contract as gpt2.build_gpt2_decode, with the same optional
    kv_dtype="int8" in-graph QDQ cache and chunk=k multi-token window
    (the verify step of speculative decoding / chunked prefill).

    Weights are seeded in the same rng order as build_moe, so prefill and
    decode graphs pair up: the family is registered in
    models.decoder_family("moe") and served by generate.Generator and
    serving.DecodeServer. With T=1 the router picks one expert per
    (batch row, layer) and the dense-mask dispatch degenerates to masking
    E-1 expert outputs to zero rows."""
    assert max_len <= cfg.n_positions, \
        "max_len beyond the position table silently clamps wpe gathers"
    b = GraphBuilder("moe_decode", opset=opset, seed=seed)
    b.wkey = _weight_key(cfg, seed)
    B, T = batch, chunk
    D, H, hd = cfg.n_embd, cfg.n_head, cfg.head_dim
    E, F = cfg.n_expert, cfg.d_ff
    L = max_len
    N = B * T
    int4_kv = kv_dtype == "int4"
    int8_kv = (not int4_kv) and np.dtype(kv_dtype) == np.int8
    if int4_kv and cfg.head_dim % 2:
        raise ValueError("int4 KV packs hd pairs: head_dim must be even")
    cache_np = np.int8 if (int8_kv or int4_kv) else np.float32
    # int4: two nibbles pack into one int8 byte along hd (models/q4.py)
    cache_hd = hd // 2 if int4_kv else hd

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    pasts = [(b.input(f"past_key_{i}", [B, H, L, cache_hd],
                      dtype=cache_np),
              b.input(f"past_value_{i}", [B, H, L, cache_hd],
                      dtype=cache_np))
             for i in range(cfg.n_layer)]
    kv_scales = [(b.input(f"kv_scale_key_{i}", [H]),
                  b.input(f"kv_scale_value_{i}", [H]))
                 for i in range(cfg.n_layer)] if (int8_kv or int4_kv) \
        else None
    zp8 = b.init("kv_zp8", np.int8(0)) if int8_kv else None

    wte = _weight(b, "wte", (cfg.vocab_size, D), 0.02)
    wpe = _weight(b, "wpe", (cfg.n_positions, D), 0.01)
    (tok,) = b.node("Gather", [wte, ids], ["tok_emb"], axis=0)
    arange = b.init("cache_positions", np.arange(L, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    if T == 1:
        (pe,) = b.node("Gather", [wpe, pos], ["pos_emb"], axis=0)
        (pe,) = b.node("Reshape", [pe, b.init(
            "shape_B_1_D", np.array([B, 1, D], np.int64))], ["pos_emb3"])
        (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])
        (is_now4,) = b.node("Reshape", [is_now, b.init(
            "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
        (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
        (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
        (attn_bias4,) = b.node("Reshape", [attn_bias, b.init(
            "shape_B_1_1_L", np.array([B, 1, 1, L], np.int64))],
            ["attn_bias4"])
    else:
        # chunk window: token j of the chunk sits at per-slot pos + j
        # (identical machinery to gpt2.build_gpt2_decode chunk mode: the
        # cache write is a one-hot scatter MATMUL, never a gather)
        tsteps = b.init("chunk_steps", np.arange(T, dtype=np.int64))
        (positions,) = b.node("Add", [pos2d, tsteps], ["positions"])
        (pe,) = b.node("Gather", [wpe, positions], ["pos_emb3"], axis=0)
        (in_lo,) = b.node("GreaterOrEqual", [arange, pos2d], ["win_lo"])
        hi = b.init("chunk_hi", np.int64(T))
        (pos_hi,) = b.node("Add", [pos2d, hi], ["pos_hi"])
        (in_hi,) = b.node("Less", [arange, pos_hi], ["win_hi"])
        (in_win,) = b.node("And", [in_lo, in_hi], ["in_win"])
        (is_now4,) = b.node("Reshape", [in_win, b.init(
            "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
        (rel,) = b.node("Sub", [arange, pos2d], ["slot_rel"])
        (rel3,) = b.node("Reshape", [rel, b.init(
            "shape_B_L_1", np.array([B, L, 1], np.int64))], ["rel3"])
        steps_k = b.init("scatter_steps", np.arange(T, dtype=np.int64
                                                    ).reshape(1, 1, T))
        (oh,) = b.node("Equal", [rel3, steps_k], ["scatter_oh"])
        (ohf,) = b.node("Cast", [oh], ["scatter_ohf"], to=1)
        b.node("Reshape", [ohf, b.init(
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
    (x,) = b.node("Add", [tok, pe], ["h0"])

    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))
    shape_nd = b.init("shape_nd", np.array([N, D], np.int64))
    shape_n1d = b.init("shape_n1d", np.array([N, 1, D], np.int64))
    shape_ne1 = b.init("shape_ne1", np.array([N, E, 1], np.int64))
    b.init("oh_depth", np.int64(E))
    b.init("oh_vals", np.array([0.0, 1.0], np.float32))
    b.init("sum_axes", np.array([1], np.int64))

    if int4_kv:
        from .q4 import q4_helpers

        _q4_pack, _q4_unpack, q4_sshape = q4_helpers(
            b, heads=H, hd=hd, batch=B, max_len=L)

    for i in range(cfg.n_layer):
        ln1 = _layernorm(b, x, f"blk{i}_ln1", D)
        qkv = _linear(b, ln1, f"blk{i}_attn_qkv", D, 3 * D)
        q, k, v = b.node("Split", [qkv],
                         [f"blk{i}_q", f"blk{i}_k", f"blk{i}_v"],
                         axis=-1, split=[D, D, D])

        def _heads(t, tag):
            (r,) = b.node("Reshape", [t, shape_split], [f"blk{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"blk{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")

        def _spread(t, tag):
            """[B,H,T,hd] -> [B,H,L,hd] one-hot scatter matmul (chunk)."""
            if T == 1:
                return t
            src = t
            if cache_np == np.int8:
                (src,) = b.node("Cast", [t], [f"blk{i}_{tag}_f"], to=1)
            (sp,) = b.node("MatMul", ["scatter_oh4", src],
                           [f"blk{i}_{tag}_spread_f"])
            if cache_np == np.int8:
                (sp,) = b.node("Cast", [sp], [f"blk{i}_{tag}_spread"],
                               to=3)
            return sp

        pk, pv = pasts[i]
        if int8_kv:
            sk, sv = kv_scales[i]
            (kh8,) = b.node("QuantizeLinear", [kh, sk, zp8],
                            [f"blk{i}_k_q8"], axis=1)
            (vh8,) = b.node("QuantizeLinear", [vh, sv, zp8],
                            [f"blk{i}_v_q8"], axis=1)
            (kc8,) = b.node("Where", [is_now4, _spread(kh8, "k8"), pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, _spread(vh8, "v8"), pv],
                            [f"present_value_{i}"])
            (kc,) = b.node("DequantizeLinear", [kc8, sk, zp8],
                           [f"blk{i}_k_dq"], axis=1)
            (vc,) = b.node("DequantizeLinear", [vc8, sv, zp8],
                           [f"blk{i}_v_dq"], axis=1)
        elif int4_kv:
            # quantize + nibble-pack the new k/v, update the cache in the
            # packed int8 domain, unpack + dequantize for the attention
            # (identical machinery to gpt2/llama, shared via models/q4.py)
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
            (kc,) = b.node("Where", [is_now4, _spread(kh, "k"), pk],
                           [f"present_key_{i}"])
            (vc,) = b.node("Where", [is_now4, _spread(vh, "v"), pv],
                           [f"present_value_{i}"])
        (kt,) = b.node("Transpose", [kc], [f"blk{i}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"blk{i}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"blk{i}_scaled"])
        (att,) = b.node("Add", [att, attn_bias4], [f"blk{i}_masked"])
        (att,) = b.node("Softmax", [att], [f"blk{i}_probs"], axis=-1)
        (c,) = b.node("MatMul", [att, vc], [f"blk{i}_ctx"])
        (c,) = b.node("Transpose", [c], [f"blk{i}_ctx_t"],
                      perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, shape_merge], [f"blk{i}_ctx_m"])
        proj = _linear(b, c, f"blk{i}_attn_proj", D, D)
        (x,) = b.node("Add", [x, proj], [f"blk{i}_res1"])

        ln2 = _layernorm(b, x, f"blk{i}_ln2", D)
        (xt,) = b.node("Reshape", [ln2, shape_nd], [f"blk{i}_tokens"])
        wr = _weight(b, f"blk{i}_router_w", (D, E), 0.02)
        (rl,) = b.node("MatMul", [xt, wr], [f"blk{i}_router_logits"])
        (rp,) = b.node("Softmax", [rl], [f"blk{i}_router_probs"], axis=-1)
        (sel,) = b.node("ArgMax", [rp], [f"blk{i}_sel"], axis=-1,
                        keepdims=0)
        (oh,) = b.node("OneHot", [sel, "oh_depth", "oh_vals"],
                       [f"blk{i}_oh"], axis=-1)
        (gate,) = b.node("ReduceMax", [rp], [f"blk{i}_gate"], axes=[-1],
                         keepdims=1)
        (oh3,) = b.node("Reshape", [oh, shape_ne1], [f"blk{i}_oh3"])
        (x3,) = b.node("Reshape", [xt, shape_n1d], [f"blk{i}_x3"])
        (xe,) = b.node("Mul", [oh3, x3], [f"blk{i}_disp"])
        (xe,) = b.node("Transpose", [xe], [f"blk{i}_disp_t"],
                       perm=[1, 0, 2])
        w1 = _weight(b, f"blk{i}_exp_w1", (E, D, F), D ** -0.5)
        w2 = _weight(b, f"blk{i}_exp_w2", (E, F, D), F ** -0.5)
        (he,) = b.node("MatMul", [xe, w1], [f"blk{i}_exp_h"])
        (he,) = b.node("Relu", [he], [f"blk{i}_exp_act"])
        (ye,) = b.node("MatMul", [he, w2], [f"blk{i}_exp_y"])
        (ye,) = b.node("Transpose", [ye], [f"blk{i}_exp_y_t"],
                       perm=[1, 0, 2])
        (yw,) = b.node("Mul", [ye, f"blk{i}_oh3"], [f"blk{i}_exp_sel"])
        (y,) = b.node("ReduceSum", [yw, "sum_axes"], [f"blk{i}_comb"],
                      keepdims=0)
        (y,) = b.node("Mul", [y, gate], [f"blk{i}_gated"])
        (y,) = b.node("Reshape", [y, shape_merge], [f"blk{i}_moe_out"])
        (x,) = b.node("Add", [x, y], [f"blk{i}_res2"])

    x = _layernorm(b, x, "ln_f", D)
    wte_t = _lm_head(b)
    (logits,) = b.node("MatMul", [x, wte_t], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    for i in range(cfg.n_layer):
        b.output(f"present_key_{i}", [B, H, L, hd])
        b.output(f"present_value_{i}", [B, H, L, hd])
    return b.model()
