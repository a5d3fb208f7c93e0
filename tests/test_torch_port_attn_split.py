"""The decode-attention kernels' launch plan, on the CPU: the cluster split
(`attn_split`), the dead-row predicate (`attn_live_chunks`) against the
plain versions' own terms, and the plain versions against the JAX Pallas
kernels (interpret mode) at shapes tests/test_torch_port_decode_kernels.py
does not cover. The kernels themselves are held against the plain versions
and against attn_live_chunks on the card (tests/test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.ops.kernels.decode_attn import (
    decode_attention_int8 as j_attn, decode_attention_int8_mxu as j_attn_mxu)
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import decode_attn as da
from onnx_rusty_inference_engine_tpu_torch.ops.standard import (
    matmul_fp32_exact)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# attn_split
# --------------------------------------------------------------------------
# (B, H, Hkv, L, hd) -> C: GPT-2 124M's decode step (max_len 256 and its
# n_positions 1024) at batch 8 and 1, GQA, L below one warp's rows, ragged L
SPLIT_CASES = {
    "gpt2_b8_l256": ((8, 12, 12, 256, 64), 2),
    "gpt2_b8_l1024": ((8, 12, 12, 1024, 64), 2),
    "gpt2_b1_l1024": ((1, 12, 12, 1024, 64), 8),
    "gpt2_b1_l256": ((1, 12, 12, 256, 64), 8),
    "gqa_rep4_hd128": ((8, 32, 8, 1024, 128), 4),
    "gqa_b1_hd128": ((1, 32, 8, 1024, 128), 8),
    "l5": ((1, 4, 2, 5, 64), 1),
    "l7_b1": ((1, 1, 1, 7, 16), 1),
    "ragged_l1000_b1": ((1, 12, 12, 1000, 64), 8),
    "ragged_l77": ((2, 4, 2, 77, 64), 2),
    "ragged_l300_hd256": ((1, 2, 2, 300, 256), 8),
    "b32_covers_the_card": ((32, 12, 12, 1024, 64), 1),
    "long_l32768_rep8": ((1, 64, 8, 32768, 128), 8),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_attn_split(case):
    (B, H, Hkv, L, hd), want = SPLIT_CASES[case]
    C = da.attn_split(B, H, Hkv, L, hd)
    assert C == want
    assert C in (1, 2, 4, 8)
    chunk = -(-L // C)
    assert (C - 1) * chunk < L  # every CTA's chunk is non-empty
    warp_rows = da.NK * 32 // da._lanes_per_row(hd)
    if C > 1:
        assert chunk >= warp_rows
    if C < da.MAX_CLUSTER and B * Hkv * C < da.SMS:
        # doubling C would leave a chunk shorter than one warp's rows
        assert -(-L // (2 * C)) < warp_rows


def test_attn_split_refuses_what_does_not_fit():
    for args in ((8, 12, 5, 256, 64), (0, 12, 12, 256, 64),
                 (8, 12, 12, 0, 64)):
        with pytest.raises(ValueError):
            da.attn_split(*args)


@pytest.mark.parametrize("hd,lanes", [(10, 1), (16, 1), (64, 4), (80, 8),
                                      (128, 8), (256, 16)])
def test_lanes_per_row(hd, lanes):
    assert da._lanes_per_row(hd) == lanes


# --------------------------------------------------------------------------
# attn_live_chunks against the plain versions' terms
# --------------------------------------------------------------------------
def _terms(q, k8, bias, H, mxu):
    """The plain versions' per-row terms, as they compute them: e = exp(s
    - max) (f32 form), or p8 (int8 x int8 form) -> [B, Hkv, rep, L]."""
    B, L, hd = bias.shape[0], bias.shape[-1], q.shape[-1]
    Hkv = k8.shape[0] // B
    rep = H // Hkv
    k = k8.reshape(B, Hkv, L, hd)
    qg = q.reshape(B, Hkv, rep, hd)
    b = bias.reshape(B, 1, 1, L)
    if mxu:
        sq = qg.abs().amax(dim=(2, 3), keepdim=True).clamp_min(1e-9) \
            / torch.tensor(127.0)
        s = da._int_dot(torch.round(qg / sq), k.transpose(-1, -2)) * sq + b
        p = da._softmax(s)
        sp = p.amax(dim=(2, 3), keepdim=True).clamp_min(1e-9) \
            / torch.tensor(127.0)
        return torch.round(p / sp)
    with matmul_fp32_exact():
        s = torch.matmul(qg, k.to(torch.float32).transpose(-1, -2)) + b
    return torch.exp(s - s.amax(dim=-1, keepdim=True))


def _check_sound(q, k8, bias, H, mxu):
    """No row attn_live_chunks calls dead has a non-zero term in the plain
    version; every row at its batch row's largest bias is live. Returns
    the live mask [B, Hkv, L]."""
    B = bias.shape[0]
    Hkv = k8.shape[0] // B
    live = da.attn_live_chunks(q, bias, n_q_heads=H, n_kv_heads=Hkv, mxu=mxu)
    assert live.shape == (B, Hkv, bias.shape[-1]) and live.dtype == torch.bool
    terms = _terms(q, k8, bias, H, mxu)
    dead = ~live[:, :, None, :].expand_as(terms)
    assert bool((terms[dead] == 0).all())
    at_max = (bias.reshape(B, 1, -1) == bias.reshape(B, -1).amax(-1)
              .reshape(B, 1, 1))
    assert bool(live[at_max.expand_as(live)].all())
    return live


def _inputs(B, H, Hkv, L, hd, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B * H, 1, hd)) * q_scale
         / (127 * np.sqrt(hd))).astype(np.float32)
    k8 = rng.integers(-128, 128, (B * Hkv, L, hd)).astype(np.int8)
    return rng, _t(q), _t(k8)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("q_scale", [1.0, 1e2, 1e4, 1e7])
def test_live_rows_per_row_positions(mxu, q_scale):
    """The decode graph's per-slot positions: each batch row valid up to
    its own pos (0 / -1e9), at growing |q|. Where |q| makes the bound
    exceed the gap (1e-9 away), nothing may be skipped."""
    B, H, Hkv, L, hd = 4, 4, 2, 96, 32
    rng, q, k8 = _inputs(B, H, Hkv, L, hd, seed=int(q_scale), q_scale=q_scale)
    pos = np.array([0, 17, 64, L - 1])
    bias = _t(np.where(np.arange(L)[None, :] <= pos[:, None], 0.0, -1e9)
              .astype(np.float32)[:, None, :])
    live = _check_sound(q, k8, bias, H, mxu)
    if q_scale <= 1e4:  # the bound stays far below the mask's 1e9
        want = torch.from_numpy(np.arange(L)[None, :] <= pos[:, None])
        assert torch.equal(live, want[:, None, :].expand_as(live))


@pytest.mark.parametrize("mxu", [False, True])
def test_live_rows_all_masked_batch_row(mxu):
    """A batch row with every bias -1e9: all biases equal, nothing skipped
    there; the other row skips its masked rows."""
    B, H, L, hd = 2, 4, 40, 16
    _, q, k8 = _inputs(B, H, H, L, hd, seed=5)
    bias = np.zeros((B, 1, L), np.float32)
    bias[0] = -1e9
    bias[1, 0, 20:] = -1e9
    live = _check_sound(q, k8, _t(bias), H, mxu)
    assert bool(live[0].all())
    assert int(live[1].sum()) == H * 20


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_live_rows_other_biases(mxu, seed):
    """Biases other than 0 / -1e9: ALiBi-like slopes, steps of -30, -200,
    -1e4 and -3e38, random values, at |q| from small to large."""
    B, H, Hkv, L, hd = 3, 6, 3, 64, 16
    rng, q, k8 = _inputs(B, H, Hkv, L, hd, seed=10 + seed,
                         q_scale=10.0 ** (seed % 4))
    choices = np.array([0.0, -30.0, -200.0, -1e4, -3e38], np.float32)
    bias = np.stack([
        -np.abs(rng.standard_normal()) * 10 * np.arange(L)[::-1],  # ALiBi
        rng.choice(choices, L),
        rng.standard_normal(L) * 10.0 ** rng.integers(0, 6),
    ]).astype(np.float32)[:, None, :]
    _check_sound(q, k8, _t(bias), H, mxu)


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("delta", [-2.0, -0.5, 0.0, 0.5, 2.0, 300.0])
def test_live_rows_at_the_threshold(mxu, delta):
    """Adversarial keys (a dead row's key aligned with q, the max row's key
    against it, both at |k| = 128 where the sign allows) and biases placed
    at the predicate's threshold, +-delta, in ulps of 1e9's f32 spacing."""
    B, H, L, hd = 1, 1, 8, 16
    _, q, _ = _inputs(B, H, H, L, hd, seed=3, q_scale=50.0)
    sign = np.sign(q.numpy().reshape(hd))
    k8 = np.zeros((B * H, L, hd), np.int8)
    k8[0, 0] = np.where(sign > 0, -128, 127)   # the max-bias row: lowest score
    k8[0, 1:] = np.where(sign > 0, 127, -128)  # the others: highest score
    bq = 128.0 * float(np.abs(q.numpy().astype(np.float64)).sum())
    M = -1e9
    thr = M - 2 * bq - 128 - 2.0 ** -22 * (2 * abs(M) + 2 * bq)
    bias = np.full((B, 1, L), M, np.float32)
    bias[0, 0, 1:] = np.float32(thr + delta * 64.0 * np.arange(1, L))
    _check_sound(q, _t(k8), _t(bias), H, mxu)


@pytest.mark.parametrize("mxu", [False, True])
def test_live_rows_skip_the_dead_rows_at_pos_64(mxu):
    """GPT-2's decode step at pos 64 of a 256-row cache: 65 rows live per
    (batch, head); of the two CTA chunks attn_split makes, the second
    loads no row at all."""
    B, H, L, hd = 8, 12, 256, 64
    _, q, k8 = _inputs(B, H, H, L, hd, seed=64)
    bias = _t(np.broadcast_to(np.where(np.arange(L) <= 64, 0.0, -1e9)
                              .astype(np.float32), (B, 1, L)).copy())
    live = _check_sound(q, k8, bias, H, mxu)
    assert int(live.sum()) == B * H * 65
    C = da.attn_split(B, H, H, L, hd)
    assert C == 2
    chunks = live.reshape(B, H, C, L // C)
    assert bool(chunks[:, :, 0, :65].all()) and not bool(chunks[:, :, 1].any())


# --------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------
# (B, H, Hkv, L, hd, valid length per batch row)
JAX_CASES = {"b1_l1024": (1, 4, 4, 1024, 64, (1024,)),
             "per_row_valid": (3, 4, 4, 96, 64, (1, 50, 96)),
             "gqa_hd128": (2, 8, 2, 128, 128, (70, 128))}


def _jax_inputs(B, H, Hkv, L, hd, valid, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B * H, 1, hd)) / (127 * np.sqrt(hd))
         ).astype(np.float32)
    k8 = rng.integers(-127, 127, (B * Hkv, L, hd)).astype(np.int8)
    v8 = rng.integers(-127, 127, (B * Hkv, L, hd)).astype(np.int8)
    ok = np.arange(L)[None, :] < np.array(valid)[:, None]
    bias = np.where(ok, 0.0, -1e9).astype(np.float32)[:, None, :]
    return q, k8, v8, bias


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_attention_plain_matches_pallas_interpret_more_shapes(case):
    """The f32 form at the JAX test's tolerance (rtol 2e-2, atol 0.5): the
    TPU kernel rounds q and p to bf16, the port does not."""
    B, H, Hkv, L, hd, valid = JAX_CASES[case]
    q, k8, v8, bias = _jax_inputs(B, H, Hkv, L, hd, valid, seed=L + hd)
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k8),
                             jnp.asarray(v8), jnp.asarray(bias),
                             n_q_heads=H, interpret=True))
    got = da.decode_attention_int8(_t(q), _t(k8), _t(v8), _t(bias),
                                   n_q_heads=H).numpy()
    assert got.shape == want.shape == (B * H, 1, hd)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.5)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_attention_mxu_plain_matches_pallas_interpret_more_shapes(case):
    """The int8 x int8 form: the same dynamic scales and exact integer
    sums; a rounding tie can move one p8 step, hence 1e-2 of max|ref|."""
    B, H, Hkv, L, hd, valid = JAX_CASES[case]
    q, k8, v8, bias = _jax_inputs(B, H, Hkv, L, hd, valid, seed=L * hd)
    want = np.asarray(j_attn_mxu(jnp.asarray(q), jnp.asarray(k8),
                                 jnp.asarray(v8), jnp.asarray(bias),
                                 n_q_heads=H, interpret=True))
    got = da.decode_attention_int8_mxu(_t(q), _t(k8), _t(v8), _t(bias),
                                       n_q_heads=H).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
