"""The port's int8 conv kernel module (ops/kernels/qconv_int8.py) and its
quantized emitters, held against the JAX package.

On the CPU the wrappers run their plain versions; they are compared with
the JAX Pallas kernels in interpret mode (`qmatmul_int8_requant`,
`qconv1x1_int8_requant`) and with the JAX QLinearConv emitter (XLA path),
on the same int8 inputs from a seeded numpy generator. Tolerance, as in
tests/test_pallas_kernels.py: at most 1 LSB (ties in the requant rounding
may fall either way between paths) and more than 99% of elements equal.
The kernel itself runs only on the card: tests/test_torch_port_cuda.py
(marked `cuda`) and chip_smoke.py, which compares it with the plain version
at every SqueezeNet shape.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from onnx_rusty_inference_engine_tpu.ops.kernels.qmatmul import (
    qconv1x1_int8_requant as j_qconv1x1,
    qmatmul_int8_requant as j_qmatmul_requant,
)
from onnx_rusty_inference_engine_tpu.ops.quantized import _requant as j_requant
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qconv_int8 as k
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qmatmul_int8 as q8
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import run_op_port
from util import run_op


def _agree(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"
    assert (got == want).mean() > 0.99, f"equal {(got == want).mean()}"


def _qconv_case(seed, B, C, H, W, O, ksz, per_channel, with_bias):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (B, C, H, W), dtype=np.int8)
    w = rng.integers(-127, 128, (O, C, ksz, ksz), dtype=np.int8)
    b = (rng.integers(-3000, 3000, (O,), dtype=np.int32)
         if with_bias else None)
    x_s = np.float32(0.05)
    w_s = ((np.abs(rng.standard_normal(O)) * 0.01 + 1e-3).astype(np.float32)
           if per_channel else np.float32(0.004))
    y_s = np.float32(0.2 * ksz)
    return x, w, b, x_s, w_s, y_s


# (B, C, H, W, O, kernel, stride, pads[t, l, b, r], per_channel, bias)
CONV_CASES = {
    "1x1": (2, 32, 7, 7, 48, 1, 1, [0, 0, 0, 0], True, True),
    "1x1_scalar_nobias": (2, 24, 6, 5, 40, 1, 1, [0, 0, 0, 0], False, False),
    "3x3_pad1": (2, 16, 9, 9, 24, 3, 1, [1, 1, 1, 1], True, True),
    "3x3_pad1_scalar": (1, 20, 8, 7, 12, 3, 1, [1, 1, 1, 1], False, True),
    "7x7_stride2": (2, 3, 23, 23, 16, 7, 2, [0, 0, 0, 0], True, True),
    "3x3_stride2_asym_pad": (1, 8, 10, 11, 8, 3, 2, [1, 0, 2, 1], True,
                             False),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_qlinearconv_matches_jax_emitter(case):
    B, C, H, W, O, ksz, s, pads, per_ch, with_bias = CONV_CASES[case]
    x, w, b, x_s, w_s, y_s = _qconv_case(7, B, C, H, W, O, ksz, per_ch,
                                         with_bias)
    inits = {"x_s": x_s, "x_zp": np.int8(0), "w": w, "w_s": w_s,
             "w_zp": np.zeros(np.shape(w_s), np.int8), "y_s": y_s,
             "y_zp": np.int8(0)}
    if b is not None:
        inits["b"] = b
    attrs = dict(kernel_shape=[ksz, ksz], strides=[s, s], pads=pads)
    (want,) = run_op("QLinearConv", {"x": x}, inits, **attrs)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **attrs)
    _agree(got, want)


@pytest.mark.parametrize("case", ["1x1", "1x1_scalar_nobias"])
def test_plain_qconv_matches_pallas_qconv1x1(case):
    B, C, H, W, O, ksz, _, _, per_ch, with_bias = CONV_CASES[case]
    x, w, b, x_s, w_s, y_s = _qconv_case(11, B, C, H, W, O, ksz, per_ch,
                                         with_bias)
    mult = (np.asarray(x_s, np.float32) * np.asarray(w_s, np.float32)
            / np.asarray(y_s, np.float32))
    want = np.asarray(j_qconv1x1(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(mult),
                                 None if b is None else jnp.asarray(b),
                                 interpret=True))
    got = k.qconv_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.as_tensor(mult),
        None if b is None else torch.from_numpy(b)).numpy()
    _agree(got, want)


@pytest.mark.parametrize("M,K,N,per_col,with_bias", [
    (64, 128, 96, True, True),
    (100, 300, 50, False, True),
    (33, 72, 40, True, False),
])
def test_plain_qmatmul_matches_pallas(M, K, N, per_col, with_bias):
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-128, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    bias = (rng.integers(-1000, 1000, (N,), dtype=np.int32)
            if with_bias else None)
    mult = ((np.abs(rng.standard_normal(N)) * 1e-3 + 1e-4).astype(np.float32)
            if per_col else np.float32(3e-4))
    want = np.asarray(j_qmatmul_requant(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mult),
        None if bias is None else jnp.asarray(bias), interpret=True))
    got = q8.qmatmul_int8_requant(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.as_tensor(mult),
        None if bias is None else torch.from_numpy(bias)).numpy()
    _agree(got, want)


def test_requant_epilogue_equals_jax_bit_for_bit():
    """The fp32 epilogue (the part that decides the rounding) is the same
    arithmetic as the JAX `_requant`: equal on random sums and on exact
    halves, which both round half to even."""
    rng = np.random.default_rng(5)
    acc = rng.integers(-2_000_000, 2_000_000, (64, 40), dtype=np.int32)
    acc[0, :8] = [1, 3, 5, 7, -1, -3, -5, 255]  # x 0.5: exact halves
    mult = (np.abs(rng.standard_normal(40)) * 1e-4).astype(np.float32)
    mult[:8] = 0.5
    want = np.asarray(j_requant(jnp.asarray(acc), jnp.asarray(mult), None))
    got = k._requant(torch.from_numpy(acc), torch.from_numpy(mult), None,
                     channel_dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :7], [0, 2, 2, 4, 0, -2, -2])


@pytest.mark.parametrize("ksz,stride,pads", [(1, 1, (0, 0, 0, 0)),
                                             (3, 1, (1, 1, 1, 1)),
                                             (7, 2, (0, 0, 0, 0)),
                                             (3, 2, (2, 1, 0, 1))])
def test_packed_weight_layout_is_the_kernels_implicit_gemm(ksz, stride, pads):
    """The kernel reads channels-last activations, their channels padded
    to Cp = conv_channels(C) (5 -> 8 here), along K = (kh, kw, c) and the
    packed weight row by row. Emulate that gather here and check it
    reproduces the exact conv: the layout the CUDA kernel relies on."""
    rng = np.random.default_rng(ksz * 10 + stride)
    B, C, H, W, O = 2, 5, 9, 8, 6
    x = torch.from_numpy(rng.integers(-128, 128, (B, C, H, W), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (O, C, ksz, ksz), np.int8))
    packed = k.pack_qconv_weight(w)
    Cp = k.conv_channels(C)
    K = ksz * ksz * Cp
    assert Cp == 8
    assert packed.shape == (O, -(-K // k.K_ALIGN) * k.K_ALIGN)
    assert not packed[:, K:].any()
    assert not packed[:, :K].reshape(O, ksz * ksz, Cp)[..., C:].any()
    pt, pl, pb, pr = pads
    OH = (H + pt + pb - ksz) // stride + 1
    OW = (W + pl + pr - ksz) // stride + 1
    x_cl = k.channels_last_input(x).to(torch.int64)
    assert x_cl.shape == (B, H, W, Cp) and not x_cl[..., C:].any()
    cols = torch.zeros((B, OH, OW, packed.shape[1]), dtype=torch.int64)
    for kidx in range(K):
        tap, c = divmod(kidx, Cp)
        kh, kw = divmod(tap, ksz)
        for oh in range(OH):
            ih = oh * stride - pt + kh
            if not 0 <= ih < H:
                continue
            for ow in range(OW):
                iw = ow * stride - pl + kw
                if 0 <= iw < W:
                    cols[:, oh, ow, kidx] = x_cl[:, ih, iw, c]
    got = torch.einsum("bhwk,ok->bohw", cols, packed.to(torch.int64))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.double(), (pl, pr, pt, pb)), w.double(),
        stride=stride).to(torch.int64)
    assert torch.equal(got, want)


def _qconv_inits(x_zp=0, w_zp=0, y_zp=0, C=4, O=4, ksz=3):
    rng = np.random.default_rng(2)
    return {"x_s": np.float32(0.1), "x_zp": np.int8(x_zp),
            "w": rng.integers(-127, 128, (O, C, ksz, ksz), dtype=np.int8),
            "w_s": np.float32(0.01), "w_zp": np.int8(w_zp),
            "y_s": np.float32(0.5), "y_zp": np.int8(y_zp)}


@pytest.mark.parametrize("why,inits,attrs", [
    # grouped convs are ported (test_torch_port_qgroup.py); a group count
    # that does not split the channels is still refused
    ("group", _qconv_inits(C=2), {"group": 3}),
])
def test_unported_qlinearconv_raises(why, inits, attrs):
    x = np.random.default_rng(0).integers(-128, 128, (1, 4, 9, 9), np.int8)
    with pytest.raises(UnsupportedOpError, match=why):
        run_op_port("QLinearConv", {"x": x}, inits, kernel_shape=[3, 3],
                    **attrs)


@pytest.mark.parametrize("what,inits,attrs", [
    ("asymmetric", _qconv_inits(x_zp=3), {}),
    ("asymmetric", _qconv_inits(y_zp=-2), {}),
    ("dilat", _qconv_inits(), {"dilations": [2, 2]}),
])
def test_formerly_refused_qlinearconv_matches_jax(what, inits, attrs):
    """The cases test_unported_qlinearconv_raises pinned as refusals before
    the QOperator forms were ported (an x or y zero point, a dilation) now
    run, and give the JAX emitter's values."""
    x = np.random.default_rng(0).integers(-128, 128, (1, 4, 9, 9), np.int8)
    kw = dict(kernel_shape=[3, 3], **attrs)
    (want,) = run_op("QLinearConv", {"x": x}, inits, **kw)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    _agree(got, want)


def test_wrapper_has_no_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device gets the
    kernel or an error."""
    x = torch.zeros((1, 4, 5, 5), dtype=torch.int8, device="meta")
    w = torch.zeros((2, 4, 1, 1), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k.qconv_int8_requant(x, w, torch.ones(2, device="meta"))


@pytest.mark.parametrize("case", [
    ("per_tensor_int8", np.float32(0.02), np.int8(0), None),
    ("per_tensor_uint8", np.float32(0.05), np.uint8(128), None),
    ("per_axis_int8", np.array([0.01, 0.1, 0.5], np.float32),
     np.zeros(3, np.int8), 1),
])
def test_quantize_dequantize_match_jax(case):
    name, scale, zp, axis = case
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 4, 5)) * 2).astype(np.float32)
    # exact ties at half a step, which round half to even
    x.reshape(-1)[:6] = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5],
                                   np.float32) * np.float32(
                                       np.asarray(scale).reshape(-1)[0])
    attrs = {} if axis is None else {"axis": axis}
    q_inits = {"scale": scale, "zp": zp}
    (want_q,) = run_op("QuantizeLinear", {"x": x}, q_inits, **attrs)
    (got_q,) = run_op_port("QuantizeLinear", {"x": x}, q_inits, **attrs)
    assert got_q.dtype == want_q.dtype
    np.testing.assert_array_equal(got_q, want_q)
    (want_d,) = run_op("DequantizeLinear", {"q": want_q}, q_inits, **attrs)
    (got_d,) = run_op_port("DequantizeLinear", {"q": want_q}, q_inits,
                           **attrs)
    np.testing.assert_array_equal(got_d, want_d)


# SqueezeNet 1.0's 22 distinct QLinearConv shapes at b256, 224x224:
# (C, H, O, kernel, stride, pad)
SQUEEZENET_B256_CONVS = [
    (3, 224, 96, 7, 2, 0),
    (96, 54, 16, 1, 1, 0), (16, 54, 64, 1, 1, 0), (16, 54, 64, 3, 1, 1),
    (128, 54, 16, 1, 1, 0), (128, 54, 32, 1, 1, 0), (32, 54, 128, 1, 1, 0),
    (32, 54, 128, 3, 1, 1), (256, 26, 32, 1, 1, 0), (32, 26, 128, 1, 1, 0),
    (32, 26, 128, 3, 1, 1), (256, 26, 48, 1, 1, 0), (48, 26, 192, 1, 1, 0),
    (48, 26, 192, 3, 1, 1), (384, 26, 48, 1, 1, 0), (384, 26, 64, 1, 1, 0),
    (64, 26, 256, 1, 1, 0), (64, 26, 256, 3, 1, 1), (512, 12, 64, 1, 1, 0),
    (64, 12, 256, 1, 1, 0), (64, 12, 256, 3, 1, 1), (512, 12, 1000, 1, 1, 0),
]


@pytest.mark.parametrize("C,H,O,ksz,s,pad", SQUEEZENET_B256_CONVS)
def test_tile_and_producer_fit_every_squeezenet_b256_conv(C, H, O, ksz, s,
                                                           pad):
    """Each conv goes to the producer its shape allows: TMA for the 1x1s (C
    % 16 == 0), the staged-halo producer for the stride-1 3x3 expands to N
    64 and 128 (test_torch_port_conv2d_plan.py holds its plans and its
    fallback rule) and for conv1, whose 3 channels are read as 4 and which
    runs as its space-to-depth rewrite (a stride-1 4x4 over 16 channels:
    tests/test_torch_port_stem_plan.py), the gather for the other
    expands. The tile the wrapper passes the TMA and
    gather convs fits the kernel (a BN it has, a ring of at least 2 slots
    within the H100's 227 KB of shared memory) and covers N in one block
    where N <= 256; the 3x3 expands' gather tile (the plan the staged-halo
    producer replaced, `int8_tile`) holds the same."""
    pads = ((pad, pad), (pad, pad))
    Cp = k.conv_channels(C)
    producer, tile = k.conv_plan((256, C, H, H), (O, C, ksz, ksz), (s, s),
                                 pads)
    # the expands to N <= 128 on the staged-halo producer; to N 192 and 256
    # over 26 x 26 and 12 x 12 its 8-wide patches cover 1.5 and 1.8 times
    # the pixels and its fallback rule keeps them on the gather
    assert producer == ("tma" if ksz == 1 else "halo" if O <= 128 and (
        s == 1 or C == 3) else "gather")
    assert Cp == (4 if C == 3 else C)
    if producer == "halo":
        assert tile.bn in k.HALO_BN and tile.bm in (128, 256)
        OH = (H + 2 * pad - ksz) // s + 1
        tile = q8.int8_tile(256 * OH * OH, O, ksz * ksz * Cp)
    assert tile.bn in q8.BN_CHOICES and tile.bm in (64, 128)
    assert 2 <= tile.stages <= q8.MAX_STAGES
    Kp = -(-ksz * ksz * Cp // k.K_ALIGN) * k.K_ALIGN
    assert q8.tile_smem(tile, Kp) <= q8.SMEM_LIMIT == 232448
    # B stays in shared memory where the conv has one N tile and its K
    # slices fit: all but conv10 and the 3x3 expands of fires 6-9
    assert tile.b_resident == (O <= 256 and -(-Kp // 128) * tile.bn * 128
                               <= q8.B_RESIDENT_MAX)
    if O <= 256:
        assert tile.bn == min(c for c in q8.BN_CHOICES if c >= O)
    else:
        assert -(-O // tile.bn) * tile.bn - O < 128
    assert tile.bm == 128  # every SqueezeNet grid has blocks for all SMs


@pytest.mark.parametrize("C,ksz,stride,pads,want", [
    (3, 7, 2, ((0, 0), (0, 0)), "gather"),
    (16, 1, 1, ((0, 0), (0, 0)), "tma"),
    (512, 1, 1, ((0, 0), (0, 0)), "tma"),
    (24, 1, 1, ((0, 0), (0, 0)), "gather"),
    (32, 1, 2, ((0, 0), (0, 0)), "gather"),
    (32, 1, 1, ((0, 1), (0, 0)), "gather"),
    (64, 3, 1, ((1, 1), (1, 1)), "gather"),
])
def test_conv_producer_routes_by_shape(C, ksz, stride, pads, want):
    assert k.conv_producer(k.conv_channels(C), ksz, ksz, (stride, stride),
                           pads) == want


def test_channels_last_input_views_or_pads():
    """A channels-last x with C % 4 == 0 is read in place; an NCHW x is
    copied channels-last; C = 3 gains a zero fourth channel."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 8, 5, 6), np.int8))
    cl = x.contiguous(memory_format=torch.channels_last)
    got = k.channels_last_input(cl)
    assert got.data_ptr() == cl.data_ptr() and got.is_contiguous()
    assert torch.equal(got, x.permute(0, 2, 3, 1))
    got = k.channels_last_input(x)
    assert got.is_contiguous() and torch.equal(got, x.permute(0, 2, 3, 1))
    x3 = x[:, :3].contiguous()
    got = k.channels_last_input(x3)
    assert got.shape == (2, 5, 6, 4) and not got[..., 3].any()
    assert torch.equal(got[..., :3], x3.permute(0, 2, 3, 1))


@pytest.mark.parametrize("xdt,zx,zy", [(torch.uint8, 131, 200),
                                       (torch.uint8, 0, 0),
                                       (torch.int8, -128, 5),
                                       (torch.int8, 7, -128)])
def test_plain_versions_take_the_qoperator_forms(xdt, zx, zy):
    """The kernel's plain versions, which the card is held to: padding
    taps hold pad_value, the requant epilogue adds y_zp and saturates to
    out_dtype (x's type here), the int32 epilogue returns the exact sums,
    at a dilation; against a float64 reference written out here."""
    rng = np.random.default_rng(9)
    info = torch.iinfo(xdt)
    x = torch.from_numpy(rng.integers(info.min, info.max + 1, (2, 5, 9, 8))
                         .astype(np.uint8 if xdt == torch.uint8 else np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (6, 5, 3, 3), np.int8))
    mult = torch.from_numpy((np.abs(rng.standard_normal(6)) * 2e-3 + 1e-4)
                            .astype(np.float32))
    bias = torch.from_numpy(rng.integers(-4000, 4000, (6,), np.int32))
    kw = dict(stride=(2, 1), padding=((2, 1), (0, 2)), dilation=(2, 1),
              pad_value=zx)
    xd = torch.nn.functional.pad(x.double(), (0, 2, 2, 1), value=float(zx))
    sums = torch.nn.functional.conv2d(xd, w.double(), stride=(2, 1),
                                      dilation=(2, 1))
    assert torch.equal(k.qconv_int8_plain(x, w, **kw), sums.int())
    y = torch.round((sums + bias.double().reshape(1, -1, 1, 1)).float()
                    * mult.reshape(1, -1, 1, 1)) + zy
    want = y.clamp(info.min, info.max).to(xdt)
    got = k.qconv_int8_requant(x, w, mult, bias, **kw, y_zp=zy,
                               out_dtype=xdt)
    assert got.dtype == xdt and torch.equal(got, want)
