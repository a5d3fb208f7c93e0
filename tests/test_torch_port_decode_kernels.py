"""The plain PyTorch versions of the port's decode-slice kernels held
against the JAX package's Pallas kernels, run in interpret mode on the CPU:
the planar int4 matrix product, the f32 and the int8 x int8 decode
attention, and the nibble unpack probe. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_port_cuda.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.ops.kernels.decode_attn import (
    decode_attention_int8 as j_attn, decode_attention_int8_mxu as j_attn_mxu)
from onnx_rusty_inference_engine_tpu.ops.kernels.qmatmul_int4 import (
    planar_layout as j_planar_layout, qmatmul_int4_planar as j_int4)
from onnx_rusty_inference_engine_tpu.quant import pack_int4_planar
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    decode_attn as t_attn, qmatmul_int4 as t_int4)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# int4: the plain version against the Pallas kernel (interpret)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("K", [256, 768])
@pytest.mark.parametrize("M", [1, 8, 17])
def test_int4_plain_matches_pallas_interpret(M, K):
    """N = 300 is not a multiple of the 256 pre-pad. Tolerance 1e-5
    relative to max|out|: the products (bf16 A x small integers) are exact
    in f32, only the order of the f32 sums differs."""
    N, Nw = 300, 512
    rng = np.random.default_rng(M * K)
    packed, scales = pack_int4_planar(
        rng.standard_normal((K, N)).astype(np.float32), 256)
    packed = np.pad(packed, ((0, Nw - N), (0, 0)))
    scales = np.pad(scales, ((0, 0), (0, Nw - N)))
    a = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(j_int4(jnp.asarray(a), jnp.asarray(packed),
                             jnp.asarray(scales), qblock=256,
                             interpret=True))[:, :N]
    got = t_int4.qmatmul_int4_planar(_t(a), _t(packed), _t(scales),
                                     qblock=256, n=N).numpy()
    assert got.shape == want.shape == (M, N)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("K", [256, 768, 3072, 42, 2 * 130])
def test_planar_layout_matches_jax(K):
    for block in (256, 128, 64):
        assert t_int4.planar_layout(K, block) == j_planar_layout(K, block)


def test_int4_plain_odd_block_sizes():
    """K whose half no power-of-two block divides (bs = 21, 65): the plain
    version equals a dense dequantized product, the form the kernel's
    per-block sums reorder."""
    for K, N in ((42, 33), (130, 7)):
        rng = np.random.default_rng(K)
        w = rng.standard_normal((K, N)).astype(np.float32)
        packed, scales = pack_int4_planar(w, 256)
        nbh, bs = t_int4.planar_layout(K, 256)
        q = np.concatenate([(packed & 0xF).astype(np.float32) - 8,
                            (packed >> 4).astype(np.float32) - 8], axis=1)
        s = np.repeat(scales.reshape(2 * nbh, N).T, bs, axis=1)
        a = rng.standard_normal((5, K)).astype(np.float32)
        ab = _t(a).to(torch.bfloat16).float().numpy()
        want = ab.astype(np.float64) @ (q * s).T.astype(np.float64)
        got = t_int4.qmatmul_int4_planar(_t(a), _t(packed), _t(scales),
                                         qblock=256).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------
def _attn_inputs(B, H, Hkv, L, hd, seed=0):
    rng = np.random.default_rng(seed)
    # q carries the folded k-scale (~1/127) and 1/sqrt(hd): scores O(1)
    q = (rng.standard_normal((B * H, 1, hd)) / (127 * np.sqrt(hd))
         ).astype(np.float32)
    k8 = rng.integers(-127, 127, (B * Hkv, L, hd)).astype(np.int8)
    v8 = rng.integers(-127, 127, (B * Hkv, L, hd)).astype(np.int8)
    valid = np.arange(L)[None, :] <= np.array([[L // 2], [L - 3]])[:B]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, :]
    return q, k8, v8, bias


@pytest.mark.parametrize("Hkv", [4, 2])
def test_attention_plain_matches_pallas_interpret(Hkv):
    """Against the TPU kernel in interpret mode, at the JAX test's own
    tolerance (rtol 2e-2, atol 0.5; tests/test_fused_attn.py): the TPU
    kernel rounds q and p to bf16, the port does not."""
    B, H, L, hd = 2, 4, 40, 64
    q, k8, v8, bias = _attn_inputs(B, H, Hkv, L, hd)
    want = np.asarray(j_attn(jnp.asarray(q), jnp.asarray(k8),
                             jnp.asarray(v8), jnp.asarray(bias),
                             n_q_heads=H, interpret=True))
    got = t_attn.decode_attention_int8(_t(q), _t(k8), _t(v8), _t(bias),
                                       n_q_heads=H).numpy()
    assert got.shape == want.shape == (B * H, 1, hd)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.5)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_attention_plain_matches_f32_reference(Hkv):
    """The JAX emitter's fp32 fallback math (ops/fused.py), per head in
    float64 numpy: within 1e-4."""
    B, H, L, hd = 2, 4, 40, 64
    rep = H // Hkv
    q, k8, v8, bias = _attn_inputs(B, H, Hkv, L, hd, seed=1)
    got = t_attn.decode_attention_int8(_t(q), _t(k8), _t(v8), _t(bias),
                                       n_q_heads=H).numpy()
    qr = q.reshape(B, H, hd).astype(np.float64)
    kr = k8.reshape(B, Hkv, L, hd).astype(np.float64)
    vr = v8.reshape(B, Hkv, L, hd).astype(np.float64)
    for b in range(B):
        for h in range(H):
            s = qr[b, h] @ kr[b, h // rep].T + bias[b, 0]
            p = np.exp(s - s.max())
            p /= p.sum()
            np.testing.assert_allclose(got.reshape(B, H, hd)[b, h],
                                       p @ vr[b, h // rep], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_attention_mxu_plain_matches_pallas_interpret(Hkv):
    """The int8 x int8 form: both quantize q and p with the same dynamic
    scales and sum integers exactly; a rounding tie can move one p8 step,
    hence 1e-2 of max|ref|."""
    B, H, L, hd = 2, 4, 40, 64
    q, k8, v8, bias = _attn_inputs(B, H, Hkv, L, hd, seed=2)
    want = np.asarray(j_attn_mxu(jnp.asarray(q), jnp.asarray(k8),
                                 jnp.asarray(v8), jnp.asarray(bias),
                                 n_q_heads=H, interpret=True))
    got = t_attn.decode_attention_int8_mxu(_t(q), _t(k8), _t(v8), _t(bias),
                                           n_q_heads=H).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_attention_shape_errors():
    q, k8, v8, bias = (_t(x) for x in _attn_inputs(2, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="n_q_heads"):
        t_attn.decode_attention_int8(q, k8, v8, bias, n_q_heads=3)
    with pytest.raises(ValueError, match="kv rows"):
        t_attn.decode_attention_int8_mxu(q, k8[:3], v8[:3], bias,
                                         n_q_heads=4)


# --------------------------------------------------------------------------
# nibble unpack (experiments/cast_probe.py's input and expected values)
# --------------------------------------------------------------------------
def test_nibble_probe_plain_matches_cast_probe():
    p = (np.arange(256 * 256).reshape(256, 256) % 251).astype(np.uint8)
    lo, hi = t_int4.nibble_probe(_t(p))
    np.testing.assert_array_equal(lo.numpy(), (p & 0xF).astype(np.float32) - 8)
    np.testing.assert_array_equal(hi.numpy(), (p >> 4).astype(np.float32) - 8)
    assert lo.dtype == hi.dtype == torch.float32


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device (here `meta`) has neither a plain path
    nor a kernel: the wrappers raise instead of guessing."""
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_int4.qmatmul_int4_planar(meta, torch.empty((8, 2), dtype=torch.uint8),
                                   torch.empty((2, 8)))
    with pytest.raises(ValueError, match="no kernel"):
        t_int4.nibble_probe(torch.empty((4,), dtype=torch.uint8,
                                        device="meta"))
    q = torch.empty((4, 1, 8), device="meta")
    kv = torch.empty((4, 6, 8), dtype=torch.int8, device="meta")
    for fn in (t_attn.decode_attention_int8, t_attn.decode_attention_int8_mxu):
        with pytest.raises(ValueError, match="no kernel"):
            fn(q, kv, kv, torch.empty((1, 1, 6), device="meta"), n_q_heads=4)
