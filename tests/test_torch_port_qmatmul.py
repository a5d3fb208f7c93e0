"""The port's int8 GEMM (ops/kernels/qmatmul_int8.py), its interleaved int4
matrix product (ops/kernels/qmatmul_int4.py::qmatmul_int4_bf16) and the
emitters that reach them (QLinearMatMul, ORT-layout MatMulNBits), held
against the JAX package on the CPU.

On the CPU the wrappers run their plain versions; they are compared with
the JAX Pallas kernels in interpret mode and with the JAX emitters, on the
same inputs from seeded numpy generators. Tolerances:

- the int8 product and QLinearMatMul: exact. Both sum int8 products exactly
  and apply the same fp32 epilogue (one multiply, round half to even);
- the int4 product: 1e-5 of max|out|. The products (bf16 A times small
  integers) are exact in f32, only the order of the f32 sums differs;
- where the JAX emitter takes its bf16-scale dense fallback instead of its
  kernel, 2e-2 of max|out|, the JAX test's own bound
  (tests/test_pallas_kernels.py).

The kernels themselves run only on the card: tests/test_torch_port_cuda.py
(marked `cuda`) and chip_smoke.py.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.ops.kernels import (
    qmatmul as j_qmatmul_module, qmatmul_int4 as j_int4_module)
from onnx_rusty_inference_engine_tpu.ops.kernels.qmatmul import (
    qmatmul_int8 as j_qmatmul_int8)
from onnx_rusty_inference_engine_tpu.ops.kernels.qmatmul_int4 import (
    int4_fused_supported, qmatmul_int4_bf16 as j_int4_bf16)
from onnx_rusty_inference_engine_tpu.quant import pack_int4 as j_pack_int4
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qmatmul_int4 as q4, qmatmul_int8 as q8)
from chip_smoke import ort_int4_generator
from torch_port_util import run_op_port
from util import run_op


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# (a) qmatmul_int8: the plain version against the Pallas kernel (interpret)
# --------------------------------------------------------------------------
# test_pallas_kernels.py's 100x300x50, then ragged shapes: M = 1 and 17, K
# not a multiple of 16 or of the kernel's 64-byte stage, N = 130
INT8_SHAPES = [(100, 300, 50), (1, 64, 8), (17, 200, 48), (130, 72, 130)]


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_qmatmul_int8_plain_matches_pallas_interpret(M, K, N):
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-128, 128, (K, N), dtype=np.int8)
    want = np.asarray(j_qmatmul_int8(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True))
    got = q8.qmatmul_int8(_t(a), _t(b)).numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K,N", [(300, 50), (64, 8), (768, 130)])
def test_packed_weight_is_k_contiguous_and_zero_padded(K, N):
    """The kernel reads row n of the packed weight as column n of b, over
    Kp bytes: the first K are b's column, the rest 0, so a product over
    all Kp (with a masked to 0 past K, as the kernel masks it) is a @ b."""
    rng = np.random.default_rng(K)
    b = _t(rng.integers(-128, 128, (K, N), dtype=np.int8))
    a = _t(rng.integers(-128, 128, (9, K), dtype=np.int8))
    packed = q8.pack_qmatmul_weight(b)
    Kp = -(-K // q8.K_ALIGN) * q8.K_ALIGN
    assert packed.shape == (N, Kp) and packed.dtype == torch.int8
    assert torch.equal(packed[:, :K], b.t()) and not packed[:, K:].any()
    a_pad = torch.nn.functional.pad(a, (0, Kp - K)).to(torch.int64)
    assert torch.equal((a_pad @ packed.to(torch.int64).t()).to(torch.int32),
                       q8.qmatmul_int8_plain(a, b))


def test_qmatmul_int8_wrapper_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device gets the
    kernel or an error."""
    a = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        q8.qmatmul_int8(a, torch.zeros((8, 2), dtype=torch.int8,
                                       device="meta"))


# --------------------------------------------------------------------------
# (b) QLinearMatMul: the port's emitter against JAX's, under both
# ORIET_KERNELS settings (pallas: JAX's kernel for a 2-D a)
# --------------------------------------------------------------------------
def _qmatmul_inits(K, N, per_col, with_bias, seed=3):
    rng = np.random.default_rng(seed)
    b_s = ((np.abs(rng.standard_normal(N)) * 0.01 + 1e-3).astype(np.float32)
           if per_col else np.array([0.004], np.float32))
    inits = {"a_s": np.float32(0.05), "a_zp": np.int8(0),
             "b": rng.integers(-127, 128, (K, N), dtype=np.int8),
             "b_s": b_s, "b_zp": np.zeros(b_s.shape, np.int8),
             "y_s": np.float32(0.9), "y_zp": np.int8(0)}
    if with_bias:
        inits["bias"] = rng.integers(-3000, 3000, (N,), dtype=np.int32)
    return inits


# (a shape, N, per-column b_s, bias)
QMM_CASES = {
    "2d_per_col_bias": ((37, 96), 40, True, True),
    "2d_per_tensor": ((8, 64), 24, False, False),
    "3d_per_col": ((2, 5, 96), 40, True, False),
    "3d_per_tensor_bias": ((3, 4, 72), 130, False, True),
}


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(QMM_CASES))
def test_qlinear_matmul_matches_jax_emitter(case, kernels, monkeypatch):
    """Under `pallas` the JAX emitter calls its kernel for a 2-D a without
    asking for interpret mode, which the CPU backend refuses; the kernel is
    swapped for the same kernel in interpret mode, as the JAX package's own
    kernel tests run it on the CPU."""
    a_shape, N, per_col, with_bias = QMM_CASES[case]
    a = np.random.default_rng(11).integers(-128, 128, a_shape, dtype=np.int8)
    inits = _qmatmul_inits(a_shape[-1], N, per_col, with_bias)
    calls = []

    def interpreted(x, y):
        calls.append(x.shape)
        return j_qmatmul_int8(x, y, interpret=True)

    monkeypatch.setattr(j_qmatmul_module, "qmatmul_int8", interpreted)
    os.environ["ORIET_KERNELS"] = kernels
    try:
        (want,) = run_op("QLinearMatMul", {"a": a}, inits)
    finally:
        os.environ["ORIET_KERNELS"] = "xla"
    assert len(calls) == (kernels == "pallas" and len(a_shape) == 2)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    assert got.dtype == want.dtype == np.int8
    assert got.shape == want.shape == a_shape[:-1] + (N,)
    np.testing.assert_array_equal(got, want)


def test_qlinear_matmul_requant_ties_round_half_to_even():
    """mult = 0.5 exactly: acc 1, 3, 5, -1, -3 sit on halves and go to the
    even neighbour, as jnp.round does."""
    a = np.array([[1], [3], [5], [-1], [-3]], np.int8)
    inits = {"a_s": np.float32(1.0), "a_zp": np.int8(0),
             "b": np.array([[1]], np.int8), "b_s": np.array([0.5], np.float32),
             "b_zp": np.zeros(1, np.int8), "y_s": np.float32(1.0),
             "y_zp": np.int8(0)}
    (want,) = run_op("QLinearMatMul", {"a": a}, inits)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(-1), [0, 2, 2, 0, -2])


@pytest.fixture
def qmm_routes(monkeypatch):
    """Which kernel wrapper each QLinearMatMul of the port called: "requant"
    (the fused epilogue) or "int32" (the product, then PyTorch's requant)."""
    from onnx_rusty_inference_engine_tpu_torch.ops import quantized

    routes = []
    for name, route in (("qmatmul_int8_requant", "requant"),
                        ("qmatmul_int8", "int32")):
        fn = getattr(quantized, name)

        def spy(*args, _fn=fn, _route=route, **kw):
            routes.append(_route)
            return _fn(*args, **kw)

        monkeypatch.setattr(quantized, name, spy)
    return routes


def _jax_qlinear_matmul(a, inits, kernels, monkeypatch):
    """The JAX emitter's QLinearMatMul under ORIET_KERNELS=`kernels` (its
    Pallas kernel in interpret mode)."""
    monkeypatch.setattr(j_qmatmul_module, "qmatmul_int8",
                        functools.partial(j_qmatmul_int8, interpret=True))
    os.environ["ORIET_KERNELS"] = kernels
    try:
        (want,) = run_op("QLinearMatMul", {"a": a}, inits)
    finally:
        os.environ["ORIET_KERNELS"] = "xla"
    return want


# (a shape, N, per-column b_s, bias, mult 0.5 with sums on halves)
FUSED_CASES = {
    "2d_per_col_bias": ((37, 96), 40, True, True, False),
    "3d_per_tensor_bias": ((3, 4, 72), 130, False, True, False),
    "2d_per_col_nobias": ((16, 48), 24, True, False, False),
    "ties_bias": ((6, 1), 3, False, True, True),
}


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_qlinear_matmul_fused_route_matches_jax_emitter(case, kernels,
                                                        qmm_routes,
                                                        monkeypatch):
    """y_zero_point a constant 0 (the quantizer's form): the port calls the
    fused requant epilogue once, and its int8 equals the JAX emitter's bit
    for bit, with per-column b_s, a bias, and sums that land on halves
    (a_s * b_s / y_s = 0.5), which round half to even."""
    a_shape, N, per_col, with_bias, ties = FUSED_CASES[case]
    rng = np.random.default_rng(21)
    if ties:
        a = np.array([[1], [3], [5], [-1], [-3], [7]], np.int8)
        inits = {"a_s": np.float32(1.0), "a_zp": np.int8(0),
                 "b": np.array([[1, -1, 3]], np.int8),
                 "b_s": np.array([0.5], np.float32),
                 "b_zp": np.zeros(1, np.int8), "y_s": np.float32(1.0),
                 "y_zp": np.int8(0),
                 "bias": np.array([0, 2, -4], np.int32)}
    else:
        a = rng.integers(-128, 128, a_shape, dtype=np.int8)
        inits = _qmatmul_inits(a_shape[-1], N, per_col, with_bias, seed=8)
    want = _jax_qlinear_matmul(a, inits, kernels, monkeypatch)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    assert qmm_routes == ["requant"]
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if ties:  # acc + bias = 1, 3, 5, -1, -3, 7 (col 0), x 0.5 -> even
        np.testing.assert_array_equal(got[:, 0], [0, 2, 2, 0, -2, 4])


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("y_zp", [3, -5])
def test_nonzero_y_zero_point_takes_the_int32_route(y_zp, kernels,
                                                    qmm_routes, monkeypatch):
    """A constant y_zero_point other than 0, which once took the int32
    product and PyTorch's requant (hence the name), is now the requant
    epilogue's own (it adds y_zp before it saturates), still equal to the
    JAX emitter. A b zero point takes the int32 route
    (test_torch_port_qoperator.py)."""
    a = np.random.default_rng(4).integers(-128, 128, (9, 64), dtype=np.int8)
    inits = dict(_qmatmul_inits(64, 33, True, True), y_zp=np.int8(y_zp))
    want = _jax_qlinear_matmul(a, inits, kernels, monkeypatch)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    assert qmm_routes == ["requant"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,K,N", [(4096, 768, 768), (4096, 768, 3072),
                                   (4096, 3072, 768), (32, 768, 768),
                                   (1, 13, 8), (17, 200, 1000)])
def test_int8_tile_fits_bert_and_ragged_shapes(M, K, N):
    """BERT-base's four QLinearMatMul shapes at B = 32, T = 128, and ragged
    ones: a BN the kernel has, one N tile where N <= 256, a ring that fits
    the H100's 227 KB of shared memory, and no (BM, BN) that would leave
    each SM less modelled time."""
    Kp = -(-K // q8.K_ALIGN) * q8.K_ALIGN
    tile = q8.int8_tile(M, N, Kp)
    assert tile.bn in q8.BN_CHOICES and tile.bm in (64, 128)
    assert 2 <= tile.stages <= q8.MAX_STAGES
    assert q8.tile_smem(tile, Kp) <= q8.SMEM_LIMIT
    assert tile.b_resident == (N <= 256 and -(-Kp // 128) * tile.bn * 128
                               <= q8.B_RESIDENT_MAX)
    if N <= 256:
        assert tile.bn >= N

    def per_sm(bm, bn):
        tiles = -(-M // bm) * -(-N // bn)
        return -(-tiles // q8.NUM_SMS) * (bm * bn + q8.TILE_OVERHEAD)

    best = min(per_sm(bm, bn) for bm in (64, 128)
               for bn in q8.BN_CHOICES if bn >= min(N, 128))
    assert per_sm(tile.bm, tile.bn) == best
    if (M, K, N) in ((4096, 768, 768), (4096, 3072, 768)):
        assert tile[:2] == (128, 192)  # 128 tiles: one wave on 132 SMs


def test_qmatmul_int8_requant_wrapper_has_no_fallback_off_the_cpu():
    a = torch.zeros((4, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        q8.qmatmul_int8_requant(a, torch.zeros((8, 2), dtype=torch.int8,
                                               device="meta"),
                                torch.ones(2, device="meta"))


def _uint8(inits):
    out = dict(inits, a_zp=np.uint8(0), b=inits["b"].view(np.uint8),
               b_zp=inits["b_zp"].view(np.uint8))
    return out


@pytest.mark.parametrize("what,a_dtype,inits", [
    ("asymmetric", np.int8, dict(_qmatmul_inits(16, 8, True, False),
                                 a_zp=np.int8(3))),
    ("asymmetric", np.int8, dict(_qmatmul_inits(16, 8, False, False),
                                 b_zp=np.array([-1], np.int8))),
    ("uint8", np.uint8, _uint8(_qmatmul_inits(16, 8, True, False))),
    ("batched weight", np.int8, dict(_qmatmul_inits(16, 8, False, False),
                                     b=np.ones((2, 16, 8), np.int8))),
])
def test_formerly_refused_qlinear_matmul_matches_jax(what, a_dtype, inits):
    """The cases once pinned here as refusals (an a or b zero point, uint8
    operands, a batched b) run, and give the JAX emitter's values."""
    a = np.random.default_rng(0).integers(0, 100, (4, 16)).astype(a_dtype)
    (want,) = run_op("QLinearMatMul", {"a": a}, inits)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


# --------------------------------------------------------------------------
# (c) qmatmul_int4_bf16: the plain version against the Pallas kernel
# --------------------------------------------------------------------------
# test_pallas_kernels.py's shapes: two quant blocks; 16 blocks (the TPU
# kernel's 8-block K tiles); one block clamped to K = 200
@pytest.mark.parametrize("M,K,N,qb", [(40, 512, 96, 256), (16, 4096, 128, 256),
                                      (8, 200, 48, 256)])
def test_int4_bf16_plain_matches_pallas_interpret(M, K, N, qb):
    rng = np.random.default_rng(M + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    packed, scales = j_pack_int4(rng.standard_normal((K, N)).astype(
        np.float32), block_size=qb)
    want = np.asarray(j_int4_bf16(jnp.asarray(a), jnp.asarray(packed),
                                  jnp.asarray(scales), interpret=True))
    got = q4.qmatmul_int4_bf16(_t(a), _t(packed), _t(scales)).numpy()
    assert got.shape == want.shape == (M, N)
    assert _rel_err(got, want) <= 1e-5


def test_int4_bf16_plain_is_the_dequantized_product():
    """Against a dense float64 product on the dequantized weight and the
    bf16-rounded activations, with n < packed rows."""
    K, N, Nw = 96, 30, 64
    rng = np.random.default_rng(4)
    packed, scales = j_pack_int4(rng.standard_normal((K, Nw)).astype(
        np.float32), block_size=32)
    q = np.stack([(packed & 0xF), (packed >> 4)], -1).reshape(Nw, K) - 8.0
    w = q * np.repeat(scales, 32, axis=1)
    a = rng.standard_normal((5, K)).astype(np.float32)
    ab = _t(a).to(torch.bfloat16).float().numpy().astype(np.float64)
    got = q4.qmatmul_int4_bf16(_t(a), _t(packed), _t(scales), n=N).numpy()
    np.testing.assert_allclose(got, (ab @ w.T)[:, :N], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,cols,nb", [(63, 31, 1), (64, 31, 2), (6, 3, 2),
                                       (64, 32, 3)])
def test_interleaved_layout_rejects_what_no_block_tiles(K, cols, nb):
    with pytest.raises(ValueError, match="interleaved"):
        q4.interleaved_layout(K, cols, nb)
    assert q4.interleaved_layout(64, 32, 2) == 16


def test_int4_bf16_wrapper_has_no_fallback_off_the_cpu():
    meta = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        q4.qmatmul_int4_bf16(meta, torch.empty((8, 32), dtype=torch.uint8),
                             torch.empty((8, 1)))


# --------------------------------------------------------------------------
# (d) interleaved MatMulNBits against the JAX emitter
# --------------------------------------------------------------------------
# (a shape, K's block, N): blocks the JAX kernel takes (qblock % 256 == 0,
# or one block), and blocks where JAX falls back to a dense bf16 product
NBITS_CASES = {
    "two_blocks_3d": ((2, 3, 512), 256, 96),
    "one_block_k200": ((8, 200), 256, 48),
    "k3072_n130": ((4, 3072), 256, 130),
    "fallback_block32": ((5, 64), 32, 33),
    "fallback_block64_3d": ((2, 2, 192), 64, 40),
}


@pytest.mark.parametrize("case", list(NBITS_CASES))
def test_matmul_nbits_interleaved_matches_jax(case):
    a_shape, block, N = NBITS_CASES[case]
    K = a_shape[-1]
    rng = np.random.default_rng(K + N)
    a = rng.standard_normal(a_shape).astype(np.float32)
    packed, scales = j_pack_int4(rng.standard_normal((K, N)).astype(
        np.float32), block_size=block)
    bs = K // scales.shape[1]
    attrs = dict(domain="com.microsoft", K=K, N=N, bits=4, block_size=bs)
    inits = {"p": packed, "s": scales}
    fused = int4_fused_supported(K, scales.shape[1])
    os.environ["ORIET_KERNELS"] = "pallas"
    try:
        (want,) = run_op("MatMulNBits", {"a": a}, inits, **attrs)
    finally:
        os.environ["ORIET_KERNELS"] = "xla"
    (got,) = run_op_port("MatMulNBits", {"a": a}, inits, **attrs)
    assert got.shape == want.shape == a_shape[:-1] + (N,)
    assert _rel_err(got, want) <= (1e-5 if fused else 2e-2)
    assert fused == (not case.startswith("fallback"))


# --------------------------------------------------------------------------
# (g) GPT-2 with ORT-layout int4 weights, INT8 KV and fused attention
# --------------------------------------------------------------------------
# n_embd 256: K = 256 (one block) and 1024 (four blocks of 256)
NARROW = GPT2Config(vocab_size=512, n_positions=64, n_embd=256, n_layer=2,
                    n_head=4)


@pytest.fixture(scope="module")
def ort_gpt2():
    """The port's Generator (CPU, INT8 KV, fused attention) running the
    prefill and decode graphs rewritten to ORT-form int4 and carried as
    ONNX bytes; the bytes, for the JAX package to read."""
    B, P = 2, 8
    gen = Generator(NARROW, batch=B, prompt_len=P, max_len=32, device="cpu",
                    kv_dtype="int8", fused_attention=True)
    blobs = ort_int4_generator(gen)
    ids = np.random.default_rng(0).integers(0, NARROW.vocab_size, (B, P))
    return gen, blobs, ids


def _jax_engines(blobs, monkeypatch):
    """The JAX package's Engines on the same bytes, built under
    ORIET_KERNELS=pallas: its interleaved int4 kernel in interpret mode,
    the form the port implements (JAX's dense bf16 fallback is not used,
    and this CPU backend has no bf16 x bf16 -> f32 dot for it).

    The kernel runs with 128-wide N tiles instead of 256: where the whole
    product is one grid step (N <= 256 at M = 16), XLA's CPU backend lifts
    the kernel's bf16 x bf16 -> f32 dot out of the loop into a dot it cannot
    run. The tile width changes no output element's arithmetic: each still
    sums the same quant blocks in the same order."""
    monkeypatch.setenv("ORIET_KERNELS", "pallas")
    monkeypatch.setattr(j_int4_module, "qmatmul_int4_bf16",
                        functools.partial(j_int4_bf16, block_n=128))
    return [JEngine(j_import(j_io.parse_model(b))) for b in blobs]


def test_ort_gpt2_graphs_run_the_interleaved_kernel_form(ort_gpt2):
    gen, _, _ = ort_gpt2
    for g in (gen.prefill.graph, gen.decode.graph):
        nbits = [n for n in g.nodes if n.op_type == "MatMulNBits"]
        assert len(nbits) == 4 * NARROW.n_layer + 1
        assert all("layout" not in n.attrs and n.domain == "com.microsoft"
                   and g.constants[n.inputs[1]].ndim == 2 for n in nbits)


def test_ort_gpt2_prefill_and_step_match_jax(ort_gpt2, monkeypatch):
    """Prefill and one decode step: the port's logits against the JAX
    Engine's on the same graphs and feeds (JAX's int4 kernel in interpret
    mode), within 1e-5 of max|logit|."""
    gen, blobs, ids = ort_gpt2
    j_pre, j_dec = _jax_engines(blobs, monkeypatch)
    logits, cache = gen.start(ids)
    want = j_pre.run({"input_ids": ids})["logits"]
    assert _rel_err(logits.numpy(), want) <= 1e-5
    tok = logits[:, -1].argmax(-1)
    P = ids.shape[1]
    step, _ = gen.step(cache, tok, P)
    feed = {"input_ids": tok.numpy().reshape(-1, 1),
            "pos": np.full((ids.shape[0],), P, np.int64)}
    feed.update({k: v.numpy() for k, v in cache.items()})
    feed.update({k: v.numpy() for k, v in gen._kv_scales.items()})
    want = j_dec.run(feed)["logits"]
    assert _rel_err(step.numpy(), want) <= 1e-5


def test_ort_gpt2_generates_8_greedy_tokens(ort_gpt2, monkeypatch):
    gen, blobs, ids = ort_gpt2
    j_pre, _ = _jax_engines(blobs, monkeypatch)
    toks, _ = gen.generate(ids, 8)
    assert toks.shape == (ids.shape[0], 8)
    assert toks.min() >= 0 and toks.max() < NARROW.vocab_size
    first = j_pre.run({"input_ids": ids})["logits"][:, -1].argmax(-1)
    np.testing.assert_array_equal(toks[:, 0], first)
