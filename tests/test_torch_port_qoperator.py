"""ONNX Runtime's QOperator INT8 forms in the port, held against the JAX
package on the CPU.

Each emitter runs through the JAX package's (`util.run_op`, the XLA path)
and the port's (`torch_port_util.run_op_port`, the kernels' plain versions)
on the same seeded numpy inputs. Tolerances: int8 outputs within 1 LSB with
more than 99% equal (tests/test_pallas_kernels.py's), int32 outputs exact.
The JAX emitters saturate every QLinearConv / QLinearMatMul output to int8
(`_requant` without `out_dtype`), so a uint8 output is held against a numpy
reference of the ONNX spec, and against JAX through its int8 twin: every
uint8 zero point and tensor less 128, which gives the same values less 128.
Whole graphs: narrow SqueezeNet and MobileNetV2 in both ORT forms
(tests/torch_port_qoperator.py builds them). The quantizer: mse ranges and
bias-corrected biases against JAX's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import run_op_port
from util import run_op


def _agree(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max |diff| {diff.max()}"
    assert (got == want).mean() > 0.99, f"equal {(got == want).mean()}"


def _twin(v: np.ndarray) -> np.ndarray:
    """A uint8 tensor or zero point as its int8 twin: v - 128."""
    return (v.astype(np.int16) - 128).astype(np.int8)


def _spec_requant(acc: np.ndarray, mult, y_zp, dtype) -> np.ndarray:
    """ONNX: saturate(round_half_even(acc * mult) + y_zp) in f32."""
    info = np.iinfo(dtype)
    y = np.round(acc.astype(np.float32) * np.float32(mult)) + np.float32(y_zp)
    return np.clip(y, info.min, info.max).astype(dtype)


# --------------------------------------------------------------------------
# QLinearConv
# --------------------------------------------------------------------------
def _conv_case(seed, x_shape, O, k, *, group=1, dtype=np.int8, x_zp=0,
               w_zp=0, y_zp=0, per_channel=False, bias=True):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    C = x_shape[1]
    x = rng.integers(info.min, info.max + 1, x_shape).astype(dtype)
    w = rng.integers(-127, 128, (O, C // group) + tuple(k)).astype(np.int8)
    w_s = ((np.abs(rng.standard_normal(O)) * 0.01 + 2e-3).astype(np.float32)
           if per_channel else np.float32(0.004))
    inits = {"x_s": np.float32(0.05), "x_zp": dtype(x_zp), "w": w,
             "w_s": w_s,
             "w_zp": (np.asarray(w_zp, np.int8) if np.ndim(w_zp)
                      else np.int8(w_zp)),
             "y_s": np.float32(0.3), "y_zp": dtype(y_zp)}
    if bias:
        inits["b"] = rng.integers(-4000, 4000, (O,)).astype(np.int32)
    return x, inits


# (x shape, O, kernel, attrs, x_zp, w_zp, y_zp, per-channel w_s, group)
QCONV_CASES = {
    "asym_3x3_pad": ((2, 8, 9, 9), 12, (3, 3), dict(pads=[1, 1, 1, 1]),
                     5, 0, -3, False, 1),
    "asym_per_channel_wzp": ((1, 8, 7, 8), 6, (3, 3),
                             dict(pads=[1, 0, 1, 2]), -7, [1, -2, 0, 3, 4, -1],
                             2, True, 1),
    "asym_tensor_wzp": ((1, 4, 6, 6), 5, (3, 3), dict(pads=[1, 1, 1, 1]),
                        3, 2, 0, True, 1),
    "dilation2": ((1, 4, 11, 10), 8, (3, 3),
                  dict(pads=[2, 2, 2, 2], dilations=[2, 2]), 9, 0, 4, True, 1),
    "stride2": ((2, 8, 10, 11), 8, (3, 3),
                dict(pads=[1, 1, 1, 1], strides=[2, 2]), -20, 0, 7, True, 1),
    "1x1_asym": ((2, 32, 5, 5), 16, (1, 1), {}, 11, 0, -9, True, 1),
    "conv1d": ((2, 8, 17), 6, (5,), dict(pads=[2, 1], strides=[2]), 4, 0, 1,
               True, 1),
    "conv1d_dilated_wzp": ((1, 4, 15), 4, (3,),
                           dict(pads=[2, 2], dilations=[2]), 4, [1, 0, -1, 2],
                           0, True, 1),
    "grouped_dw_asym": ((2, 16, 8, 8), 16, (3, 3),
                        dict(pads=[1, 1, 1, 1]), 6, 0, -5, True, 16),
    "grouped_dw_stride2": ((1, 16, 9, 9), 16, (3, 3),
                           dict(pads=[1, 1, 1, 1], strides=[2, 2]), -4, 0, 3,
                           True, 16),
    "grouped_dilated": ((1, 8, 9, 9), 8, (3, 3),
                        dict(pads=[2, 2, 2, 2], dilations=[2, 2]), 3, 0, 0,
                        True, 4),
    "grouped_wzp": ((1, 8, 7, 7), 8, (3, 3), dict(pads=[1, 1, 1, 1]), 2,
                    [1, 0, -1, 2, 3, -3, 0, 1], 1, True, 2),
}


@pytest.mark.parametrize("case", list(QCONV_CASES))
def test_qlinearconv_asymmetric_int8_matches_jax(case):
    shape, O, k, attrs, zx, zw, zy, per_ch, group = QCONV_CASES[case]
    x, inits = _conv_case(3, shape, O, k, group=group, x_zp=zx, w_zp=zw,
                          y_zp=zy, per_channel=per_ch)
    kw = dict(kernel_shape=list(k), group=group, **attrs)
    (want,) = run_op("QLinearConv", {"x": x}, inits, **kw)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    _agree(got, want)


def _spec_qconv(x, inits, group, k, attrs):
    """The ONNX spec's QLinearConv in float64 numpy-through-torch: pads
    hold x_zp (x - x_zp is 0 there), exact int sums, f32 requant."""
    spatial = x.ndim - 2
    pads = attrs.get("pads", [0] * 2 * spatial)
    xs = torch.from_numpy(x.astype(np.float64) - float(inits["x_zp"]))
    w = inits["w"].astype(np.float64)
    zw = np.asarray(inits["w_zp"], np.float64)
    w = w - zw.reshape((-1,) + (1,) * (w.ndim - 1)) if zw.ndim else w - zw
    flat = []
    for i in reversed(range(spatial)):
        flat += [pads[i], pads[i + spatial]]
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
    acc = conv(F.pad(xs, flat), torch.from_numpy(w),
               stride=attrs.get("strides", [1] * spatial),
               dilation=attrs.get("dilations", [1] * spatial),
               groups=group).numpy()
    if "b" in inits:
        acc = acc + inits["b"].reshape((1, -1) + (1,) * spatial)
    mult = (np.float32(inits["x_s"]) * np.asarray(inits["w_s"], np.float32)
            / np.float32(inits["y_s"]))
    mult = mult.reshape((1, -1) + (1,) * spatial) if mult.ndim else mult
    return _spec_requant(acc.astype(np.int64), mult, inits["y_zp"],
                         inits["y_zp"].dtype)


@pytest.mark.parametrize("case", ["asym_3x3_pad", "asym_per_channel_wzp",
                                  "dilation2", "conv1d", "grouped_dw_asym",
                                  "grouped_dw_stride2", "grouped_wzp"])
def test_qlinearconv_uint8_matches_spec_and_jax_twin(case):
    """uint8 x and y: the port equals the ONNX spec, and, less 128, the
    JAX emitter on the int8 twin (every uint8 zero point and tensor less
    128)."""
    shape, O, k, attrs, zx, zw, zy, per_ch, group = QCONV_CASES[case]
    x, inits = _conv_case(4, shape, O, k, group=group, dtype=np.uint8,
                          x_zp=zx + 128, w_zp=zw, y_zp=zy + 128,
                          per_channel=per_ch)
    kw = dict(kernel_shape=list(k), group=group, **attrs)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _spec_qconv(x, inits, group, k,
                                                   attrs))
    twin = dict(inits, x_zp=_twin(inits["x_zp"]), y_zp=_twin(inits["y_zp"]))
    (want,) = run_op("QLinearConv", {"x": _twin(x)}, twin, **kw)
    _agree(_twin(got), want)


def test_jax_qlinearconv_saturates_a_uint8_output_to_int8():
    """The JAX emitter's fault the port does not copy: with a uint8
    y_zero_point its QLinearConv still returns int8 clipped to [-128, 127]
    (_requant's default out_dtype), 128 from the spec's uint8 where the
    output saturates either end."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (1, 4, 6, 6)).astype(np.uint8)
    inits = {"x_s": np.float32(0.05), "x_zp": np.uint8(128),
             "w": rng.integers(-127, 128, (4, 4, 3, 3)).astype(np.int8),
             "w_s": np.float32(0.004), "w_zp": np.int8(0),
             "y_s": np.float32(0.05), "y_zp": np.uint8(128)}
    kw = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    (jax_out,) = run_op("QLinearConv", {"x": x}, inits, **kw)
    assert jax_out.dtype == np.int8
    assert jax_out.min() >= -128 and jax_out.max() <= 127
    spec = _spec_qconv(x, inits, 1, (3, 3), {"pads": [1, 1, 1, 1]})
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    np.testing.assert_array_equal(got, spec)
    # equal where both types hold the value; 128 apart at both ends
    np.testing.assert_array_equal(np.clip(spec, 0, 127),
                                  np.clip(jax_out, 0, 127))
    err = np.abs(spec.astype(np.int32) - jax_out.astype(np.int32))
    assert err.max() == 128 and spec.min() == 0 and spec.max() == 255


# 3-D: (x shape, O, kernel, attrs, x_zp, w_zp, y_zp, per-channel w_s, group)
QCONV3D_CASES = {
    "3d_group1": ((2, 8, 5, 6, 7), 6, (3, 3, 3),
                  dict(pads=[1, 1, 1, 1, 1, 1]), 5, 0, -3, True, 1),
    "3d_depthwise": ((1, 16, 4, 7, 7), 16, (3, 3, 3),
                     dict(pads=[1, 1, 1, 1, 1, 1]), -6, 0, 4, True, 16),
    "3d_strided": ((2, 4, 7, 9, 8), 8, (3, 3, 3),
                   dict(pads=[1, 1, 1, 1, 1, 1], strides=[2, 2, 1]), 3, 0,
                   0, True, 1),
    "3d_dilated": ((1, 4, 7, 7, 7), 4, (3, 3, 3),
                   dict(pads=[2, 2, 2, 2, 2, 2], dilations=[2, 1, 2]), 9, 0,
                   -5, False, 1),
    "3d_asymmetric_pads": ((1, 8, 5, 6, 6), 6, (3, 7, 7),
                           dict(pads=[1, 3, 2, 0, 3, 1],
                                strides=[1, 2, 2]), -11, 0, 2, True, 1),
    "3d_per_channel_wzp": ((1, 4, 4, 5, 5), 6, (3, 3, 3),
                           dict(pads=[1, 1, 1, 1, 1, 1]), 2,
                           [1, -2, 0, 3, 4, -1], 1, True, 1),
    "3d_1x1x1_stride2": ((2, 16, 4, 6, 6), 32, (1, 1, 1),
                         dict(strides=[2, 2, 2]), -4, 0, 3, True, 1),
    "3d_grouped_wzp": ((1, 8, 4, 5, 5), 8, (3, 3, 3),
                       dict(pads=[1, 1, 1, 1, 1, 1]), 2,
                       [1, 0, -1, 2, 3, -3, 0, 1], 1, True, 2),
}


@pytest.mark.parametrize("case", list(QCONV3D_CASES))
def test_qlinearconv_3d_matches_jax(case):
    """A 3-D QLinearConv (int8 x and y with zero points, per-channel or
    per-tensor w_s, a w zero point per tensor or per channel, group 1,
    depthwise and grouped) on the kernels' 3-D forms' plain versions:
    equal to the JAX emitter's output bit for bit."""
    shape, O, k, attrs, zx, zw, zy, per_ch, group = QCONV3D_CASES[case]
    x, inits = _conv_case(21, shape, O, k, group=group, x_zp=zx, w_zp=zw,
                          y_zp=zy, per_channel=per_ch)
    kw = dict(kernel_shape=list(k), group=group, **attrs)
    (want,) = run_op("QLinearConv", {"x": x}, inits, **kw)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["3d_group1", "3d_depthwise",
                                  "3d_asymmetric_pads"])
def test_qlinearconv_3d_uint8_matches_spec_and_jax_twin(case):
    """uint8 x and y with zero points: the ONNX spec's values, and less 128
    the JAX emitter's on the int8 twin."""
    shape, O, k, attrs, zx, zw, zy, per_ch, group = QCONV3D_CASES[case]
    x, inits = _conv_case(22, shape, O, k, group=group, dtype=np.uint8,
                          x_zp=zx + 128, w_zp=zw, y_zp=zy + 128,
                          per_channel=per_ch)
    kw = dict(kernel_shape=list(k), group=group, **attrs)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _spec_qconv(x, inits, group, k,
                                                   attrs))
    twin = dict(inits, x_zp=_twin(inits["x_zp"]), y_zp=_twin(inits["y_zp"]))
    (want,) = run_op("QLinearConv", {"x": _twin(x)}, twin, **kw)
    np.testing.assert_array_equal(_twin(got), want)


# (x dtype, w dtype, x_zp, w_zp, group, attrs)
CONVINT3D_CASES = {
    "3d_u8_x_s8_w": (np.uint8, np.int8, 131, None, 1,
                     dict(pads=[1, 1, 1, 1, 1, 1])),
    "3d_depthwise_per_channel": (np.uint8, np.int8, 120,
                                 [1, -2, 0, 3, 4, -1], 6,
                                 dict(pads=[1, 1, 1, 1, 1, 1])),
    "3d_strided_dilated": (np.int8, np.int8, -5, 3, 1,
                           dict(pads=[2, 1, 2, 2, 0, 2], strides=[2, 1, 2],
                                dilations=[1, 2, 1])),
    "3d_u8_both_per_channel": (np.uint8, np.uint8, 100,
                               [128, 127, 130, 126, 125, 129], 2,
                               dict(pads=[0, 1, 1, 0, 1, 1])),
}


@pytest.mark.parametrize("case", list(CONVINT3D_CASES))
def test_convinteger_3d_matches_jax_exactly(case):
    xd, wd, zx, zw, group, attrs = CONVINT3D_CASES[case]
    rng = np.random.default_rng(23)
    xi, wi = np.iinfo(xd), np.iinfo(wd)
    x = rng.integers(xi.min, xi.max + 1, (2, 6, 5, 6, 7)).astype(xd)
    w = rng.integers(wi.min, wi.max + 1,
                     (6, 6 // group, 3, 3, 3)).astype(wd)
    inits = {"w": w, "x_zp": xd(zx)}
    if zw is not None:
        inits["w_zp"] = np.asarray(zw, wd) if np.ndim(zw) else wd(zw)
    kw = dict(kernel_shape=[3, 3, 3], group=group, **attrs)
    (want,) = run_op("ConvInteger", {"x": x}, inits, **kw)
    (got,) = run_op_port("ConvInteger", {"x": x}, inits, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# ConvInteger
# --------------------------------------------------------------------------
# (x dtype, w dtype, x_zp, w_zp, group, attrs)
CONVINT_CASES = {
    "u8_x_s8_w": (np.uint8, np.int8, 131, None, 1, dict(pads=[1, 1, 1, 1])),
    "u8_both_per_channel": (np.uint8, np.uint8, 120, [128, 127, 130, 126, 125,
                                                      129], 1,
                            dict(pads=[1, 2, 0, 1], strides=[2, 1])),
    "s8_dilated": (np.int8, np.int8, -5, 3, 1,
                   dict(pads=[2, 2, 2, 2], dilations=[2, 2])),
    "grouped": (np.uint8, np.int8, 100, None, 2, dict(pads=[1, 1, 1, 1])),
}


@pytest.mark.parametrize("case", list(CONVINT_CASES))
def test_convinteger_matches_jax_exactly(case):
    xd, wd, zx, zw, group, attrs = CONVINT_CASES[case]
    rng = np.random.default_rng(5)
    xi, wi = np.iinfo(xd), np.iinfo(wd)
    x = rng.integers(xi.min, xi.max + 1, (2, 6, 7, 8)).astype(xd)
    w = rng.integers(wi.min, wi.max + 1, (6, 6 // group, 3, 3)).astype(wd)
    inits = {"w": w, "x_zp": xd(zx)}
    if zw is not None:
        inits["w_zp"] = np.asarray(zw, wd) if np.ndim(zw) else wd(zw)
    kw = dict(kernel_shape=[3, 3], group=group, **attrs)
    # the inputs in ONNX's order: x, w, x_zero_point, w_zero_point
    (want,) = run_op("ConvInteger", {"x": x}, inits, **kw)
    (got,) = run_op_port("ConvInteger", {"x": x}, inits, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# QLinearMatMul / QGemm
# --------------------------------------------------------------------------
def _mm_case(seed, a_shape, b_shape, a_dtype=np.int8, b_dtype=np.int8,
             a_zp=0, b_zp=0, y_zp=0, y_dtype=np.int8, per_col=True):
    rng = np.random.default_rng(seed)
    ai, bi = np.iinfo(a_dtype), np.iinfo(b_dtype)
    a = rng.integers(ai.min, ai.max + 1, a_shape).astype(a_dtype)
    b = rng.integers(bi.min, bi.max + 1, b_shape).astype(b_dtype)
    N = b_shape[-1]
    b_s = ((np.abs(rng.standard_normal(N)) * 0.004 + 1e-3).astype(np.float32)
           if per_col else np.float32(0.002))
    inits = {"a_s": np.float32(0.04), "a_zp": a_dtype(a_zp), "b": b,
             "b_s": b_s, "b_zp": (np.asarray(b_zp, b_dtype) if np.ndim(b_zp)
                                  else b_dtype(b_zp)),
             "y_s": np.float32(0.5), "y_zp": y_dtype(y_zp)}
    return a, inits


# (a shape, b shape, a_zp, b_zp, y_zp)
QMM_CASES = {
    "asym_a": ((5, 24), (24, 10), 7, 0, -4),
    "asym_a_b": ((2, 3, 20), (20, 6), -3, 2, 5),
    "per_col_bzp": ((4, 16), (16, 4), 1, [1, 0, -2, 3], 0),
    "batched_b": ((2, 5, 12), (2, 12, 7), 4, 0, 2),
    "batched_broadcast": ((3, 4, 8), (1, 8, 5), -2, 1, -1),
}


@pytest.mark.parametrize("case", list(QMM_CASES))
def test_qlinearmatmul_asymmetric_and_batched_match_jax(case):
    a_shape, b_shape, za, zb, zy = QMM_CASES[case]
    a, inits = _mm_case(6, a_shape, b_shape, a_zp=za, b_zp=zb, y_zp=zy,
                        per_col=len(b_shape) == 2)
    (want,) = run_op("QLinearMatMul", {"a": a}, inits)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    _agree(got, want)


@pytest.mark.parametrize("case", ["asym_a", "asym_a_b", "batched_b"])
def test_qlinearmatmul_uint8_matches_spec_and_jax_twin(case):
    a_shape, b_shape, za, zb, zy = QMM_CASES[case]
    a, inits = _mm_case(7, a_shape, b_shape, np.uint8, np.uint8, za + 128,
                        zb + 128, zy + 128, np.uint8,
                        per_col=len(b_shape) == 2)
    (got,) = run_op_port("QLinearMatMul", {"a": a}, inits)
    assert got.dtype == np.uint8
    acc = np.matmul(a.astype(np.int64) - int(inits["a_zp"]),
                    inits["b"].astype(np.int64) - int(inits["b_zp"]))
    mult = inits["a_s"] * inits["b_s"] / inits["y_s"]
    np.testing.assert_array_equal(
        got, _spec_requant(acc, mult, inits["y_zp"], np.uint8))
    twin = dict(inits, a_zp=_twin(inits["a_zp"]), b=_twin(inits["b"]),
                b_zp=_twin(inits["b_zp"]), y_zp=_twin(inits["y_zp"]))
    (want,) = run_op("QLinearMatMul", {"a": _twin(a)}, twin)
    _agree(_twin(got), want)


# (transA, transB, float output, alpha, a dtype)
QGEMM_CASES = {
    "plain": (0, 0, False, 1.0, np.int8),
    "transB": (0, 1, False, 1.0, np.int8),
    "transA_transB": (1, 1, False, 1.0, np.uint8),
    "float_out": (0, 1, True, 1.0, np.int8),
    "float_out_alpha": (1, 0, True, 0.5, np.uint8),
}


@pytest.mark.parametrize("case", list(QGEMM_CASES))
def test_qgemm_matches_jax(case):
    ta, tb, float_out, alpha, ad = QGEMM_CASES[case]
    rng = np.random.default_rng(8)
    M, K, N = 6, 20, 9
    ai = np.iinfo(ad)
    a = rng.integers(ai.min, ai.max + 1, (K, M) if ta else (M, K)).astype(ad)
    b = rng.integers(-127, 128, (N, K) if tb else (K, N)).astype(np.int8)
    inits = {"a_s": np.float32(0.03), "a_zp": ad(ai.min + 133),
             "b": b, "b_s": np.float32(0.002), "b_zp": np.int8(0),
             "c": rng.integers(-2000, 2000, (N,)).astype(np.int32)}
    if not float_out:
        inits["y_s"] = np.float32(0.4)
        inits["y_zp"] = ad(ai.min + 120)
    kw = dict(transA=ta, transB=tb, alpha=alpha)
    (want,) = run_op("QGemm", {"a": a}, inits, domain="com.microsoft", **kw)
    (got,) = run_op_port("QGemm", {"a": a}, inits, **kw)
    if float_out:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif ad == np.int8:
        _agree(got, want)
    else:  # the JAX emitter gives a.dtype: uint8 here, as the port
        assert got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


# --------------------------------------------------------------------------
# the QLinear contrib ops and AveragePool
# --------------------------------------------------------------------------
def _q_tensor(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
@pytest.mark.parametrize("op,attrs", [
    ("QLinearSigmoid", {}),
    ("QLinearLeakyRelu", {"alpha": 0.1}),
    ("QLinearGlobalAveragePool", {}),
    ("QLinearGlobalAveragePool", {"channels_last": 1}),
    ("QLinearAveragePool", {"kernel_shape": [3, 3], "strides": [2, 2],
                            "pads": [1, 1, 1, 1]}),
    ("QLinearAveragePool", {"kernel_shape": [2, 2], "count_include_pad": 1,
                            "pads": [0, 0, 1, 1], "ceil_mode": 1}),
])
def test_qlinear_unary_contrib_ops_match_jax(op, attrs, dtype):
    rng = np.random.default_rng(9)
    x = _q_tensor(rng, (8, 48, 7, 48), dtype)
    zp = dtype(3) if dtype == np.int8 else dtype(131)
    y_s = np.float32(0.01 if "Sigmoid" in op else 0.05)
    inits = {"x_s": np.float32(0.07), "x_zp": zp, "y_s": y_s,
             "y_zp": dtype(-100) if dtype == np.int8 else dtype(20)}
    (want,) = run_op(op, {"x": x}, inits, domain="com.microsoft", **attrs)
    (got,) = run_op_port(op, {"x": x}, inits, **attrs)
    assert got.dtype == want.dtype == dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_qlinearconcat_matches_jax(dtype):
    rng = np.random.default_rng(10)
    a = _q_tensor(rng, (2, 3, 4, 4), dtype)
    b = _q_tensor(rng, (2, 5, 4, 4), dtype)
    z = (lambda v: dtype(v)) if dtype == np.int8 else (lambda v: dtype(v + 128))
    inputs = {"y_s": np.float32(0.08), "y_zp": z(-2), "a": a,
              "a_s": np.float32(0.05), "a_zp": z(4), "b": b,
              "b_s": np.float32(0.11), "b_zp": z(-9)}
    (want,) = run_op("QLinearConcat", inputs, {}, domain="com.microsoft",
                     axis=1)
    (got,) = run_op_port("QLinearConcat", inputs, {}, axis=1)
    assert got.dtype == want.dtype == dtype
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("attrs", [
    {"kernel_shape": [3, 3]},
    {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]},
    {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
     "count_include_pad": 1},
    {"kernel_shape": [2, 3], "strides": [2, 2], "ceil_mode": 1},
    {"kernel_shape": [3], "pads": [1, 1]},
])
def test_average_pool_matches_jax(attrs):
    rng = np.random.default_rng(11)
    shape = (2, 3, 9) if len(attrs["kernel_shape"]) == 1 else (2, 3, 9, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    (want,) = run_op("AveragePool", {"x": x}, {}, **attrs)
    (got,) = run_op_port("AveragePool", {"x": x}, {}, **attrs)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["QLinearAdd", "QLinearMul"])
def test_qlinear_binary_keeps_uint8(op):
    rng = np.random.default_rng(12)
    a = _q_tensor(rng, (2, 4, 3, 3), np.uint8)
    b = _q_tensor(rng, (2, 4, 3, 3), np.uint8)
    inits = {"a_s": np.float32(0.05), "a_zp": np.uint8(120), "b": b,
             "b_s": np.float32(0.03), "b_zp": np.uint8(135),
             "y_s": np.float32(0.07), "y_zp": np.uint8(128)}
    (got,) = run_op_port(op, {"a": a}, inits)
    (want,) = run_op(op, {"a": a}, inits, domain="com.microsoft")
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# whole graphs: SqueezeNet 1.0 and MobileNetV2 in ORT's QOperator form
# --------------------------------------------------------------------------
from onnx_rusty_inference_engine_tpu import onnx_io as j_io  # noqa: E402
from onnx_rusty_inference_engine_tpu.graph import (  # noqa: E402
    import_model as j_import)
from onnx_rusty_inference_engine_tpu_torch.engine import (  # noqa: E402
    Engine as TEngine)
from onnx_rusty_inference_engine_tpu_torch.graph import (  # noqa: E402
    import_model as t_import)
from onnx_rusty_inference_engine_tpu_torch.models import (  # noqa: E402
    build_mobilenetv2, build_squeezenet)
from onnx_rusty_inference_engine_tpu_torch.quant import (  # noqa: E402
    calibrate)
from onnx_rusty_inference_engine_tpu.debug import (  # noqa: E402
    dump_intermediates)
from onnx_rusty_inference_engine_tpu_torch import (  # noqa: E402
    onnx_io as t_io)
from onnx_rusty_inference_engine_tpu_torch.debug import (  # noqa: E402
    probe_graph)
from test_torch_port_squeezenet import _teacher_forced  # noqa: E402
from torch_port_qoperator import (LOGITS, int8_twin,  # noqa: E402
                                  qoperator_bytes, qoperator_graph)

# model -> (build function, input name, input side): full width at a small image
QOP_MODELS = {"squeezenet": (build_squeezenet, "data_0", 64),
              "mobilenetv2": (build_mobilenetv2, "input", 64)}


def _qop_graphs(model):
    """(float graph, QUInt8 graph, QInt8 graph, the batch), calibrated with
    the port on the batch's first image."""
    build, name, side = QOP_MODELS[model]
    g = t_import(build(seed=0))
    x = np.random.default_rng(13).standard_normal(
        (2, 3, side, side)).astype(np.float32)
    ranges = calibrate(g, [{name: x[:1]}], device="cpu")
    return (g, qoperator_graph(g, ranges, "uint8"),
            qoperator_graph(g, ranges, "int8"), {name: x})


def _port_values(graph, feed):
    """Every tensor of the port's CPU run of `graph`: name -> numpy."""
    names = [o for n in graph.nodes for o in n.outputs if o]
    return TEngine(probe_graph(graph, names), device="cpu").run(feed).outputs


def _gap_ties(node, graph, values) -> np.ndarray:
    """Where a QLinearGlobalAveragePool's exact value (the mean in float64
    of the dequantized input, over y's scale, plus y's zero point) lies
    within f32 rounding of a half step: where two f32 summation orders may
    round it either way."""
    x, xs, xzp, ys, yzp = node.inputs

    def c(k):
        return float(np.asarray(graph.constants[k]).reshape(-1)[0])

    mean = ((values[x].astype(np.float64) - c(xzp)) * c(xs)).mean(
        axis=(2, 3), keepdims=True)
    v = mean / c(ys) + c(yzp)
    return np.abs(v - np.floor(v) - 0.5) < 1e-5 * np.maximum(1, np.abs(v))


@pytest.mark.parametrize("model", list(QOP_MODELS))
def test_qoperator_graph_qint8_form_matches_jax(model):
    """The QInt8 file (asymmetric int8 activations, per-channel int8
    weights, QLinearConcat / QLinearGlobalAveragePool / QLinearAdd / QGemm)
    parsed by both packages. Node for node, each port node fed JAX's
    inputs: int8 outputs within 1 LSB with more than 99% equal (a
    QLinearGlobalAveragePool's only at ties of its exact mean, which the two
    f32 summation orders round either way), f32 within 1e-5. Run free, the logits within 2 LSB of their output scale of
    JAX's, with the same top-1 (a GAP's f32 mean sums in another order, and
    a flipped LSB there moves many QGemm outputs by one). The file is the
    QUInt8 one's int8 twin."""
    g, qu8, qs8, feed = _qop_graphs(model)
    twin = int8_twin(qu8)
    assert [(n.op_type, n.inputs) for n in twin.nodes] == \
        [(n.op_type, n.inputs) for n in qs8.nodes]
    for k, v in qs8.constants.items():
        np.testing.assert_array_equal(twin.constants[k], v, err_msg=k)
    data = qoperator_bytes(qs8)
    jg = j_import(j_io.parse_model(data))
    tg = t_import(t_io.parse_model(data))
    want = dump_intermediates(jg, feed)
    got = _teacher_forced(tg, {**want, **feed})
    nodes = {o: n for n in tg.nodes for o in n.outputs}
    assert len(got) == len(tg.nodes)
    for name, v in got.items():
        w = np.asarray(want[name])
        assert v.dtype == w.dtype and v.shape == w.shape, name
        if v.dtype == np.int8:
            d = np.abs(v.astype(np.int32) - w.astype(np.int32))
            n = nodes[name]
            if n.op_type == "QLinearGlobalAveragePool":
                # an f32 mean: each differing element a tie of the exact one
                assert d.max() <= 1 and _gap_ties(n, tg, want)[d > 0].all()
            else:
                assert d.max() <= 1 and (d == 0).mean() > 0.99, name
        else:
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    logits = LOGITS[g.name]
    free = TEngine(tg, device="cpu").run(feed).outputs[logits]
    ys = float(np.asarray(qs8.constants[f"{logits}__s"]).reshape(-1)[0])
    assert np.abs(free - want[logits]).max() / ys <= 2 + 1e-3
    assert np.array_equal(free.reshape(2, -1).argmax(1),
                          want[logits].reshape(2, -1).argmax(1))


@pytest.mark.parametrize("model", list(QOP_MODELS))
def test_qoperator_graph_quint8_form_is_its_int8_twin_plus_128(model):
    """The QUInt8 file (uint8 activations, QLinearConv on uint8 x with its
    zero point as the padding, uint8 MaxPool, QLinearConcat, ...) through
    the port: every quantized tensor less 128 equals the QInt8 file's, and
    the logits are equal, so it agrees with JAX through its twin."""
    g, qu8, qs8, feed = _qop_graphs(model)
    u8 = _port_values(t_import(t_io.parse_model(qoperator_bytes(qu8))), feed)
    s8 = _port_values(t_import(t_io.parse_model(qoperator_bytes(qs8))), feed)
    n_u8 = 0
    for name, v in u8.items():
        if v.dtype == np.uint8:
            n_u8 += 1
            np.testing.assert_array_equal(_twin(v), s8[name], err_msg=name)
        else:
            np.testing.assert_array_equal(v, s8[name], err_msg=name)
    assert n_u8 > 20


# --------------------------------------------------------------------------
# the quantizer: bias correction
# --------------------------------------------------------------------------
from onnx_rusty_inference_engine_tpu.quant import (  # noqa: E402
    bias_correct as j_bias_correct, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch.quant import (  # noqa: E402
    bias_correct, quantize_graph)
from test_torch_port_engine import _feed, _narrow_model  # noqa: E402


@pytest.mark.parametrize("method", ["minmax", "mse"])
def test_bias_correct_matches_jax(method):
    """Both packages quantize the narrow SqueezeNet-shaped model from the
    same ranges, then correct its biases on two calibration batches: the
    same targets get bias inputs, and every corrected int32 bias is within
    1 of JAX's (f32 means of the two packages' outputs may round a delta
    the other way); the correction moves the biases."""
    from onnx_rusty_inference_engine_tpu.quant import (
        calibrate as j_calibrate)
    from onnx_rusty_inference_engine_tpu.quant import QuantConfig as JQC
    from onnx_rusty_inference_engine_tpu_torch.quant import QuantConfig

    m = _narrow_model(13)
    feeds = [_feed(), {k: v[::-1].copy() for k, v in _feed().items()}]
    jg, tg = j_import(m), t_import(t_io.parse_model(j_io.serialize_model(m)))
    ranges = j_calibrate(jg, feeds, method=method)
    jq = j_quantize(jg, ranges=ranges, config=JQC(calibration=method))
    tq = quantize_graph(tg, ranges=ranges,
                        config=QuantConfig(calibration=method), device="cpu")
    before = {k: np.array(v) for k, v in tq.constants.items()}
    jq = j_bias_correct(jq, jg, feeds)
    tq = bias_correct(tq, tg, feeds, device="cpu")
    assert [n.inputs for n in tq.nodes] == [n.inputs for n in jq.nodes]
    biases = [n.inputs[8] for n in tq.nodes
              if n.op_type in ("QLinearConv", "QLinearMatMul")]
    assert biases
    moved = 0
    for b in biases:
        got, want = tq.constants[b], np.asarray(jq.constants[b])
        assert got.dtype == want.dtype == np.int32, b
        assert np.abs(got.astype(np.int64) - want).max() <= 1, b
        if b in before:
            moved += int(np.any(got != before[b]))
        else:
            moved += int(np.any(got != 0))
    assert moved > 0


def test_cli_inspect_finds_every_qoperator_op_supported(tmp_path, capsys):
    """`inspect` on both QOperator files (QLinearConcat,
    QLinearGlobalAveragePool, QLinearAdd, QGemm, ...) reports no op as
    unsupported."""
    import json

    from onnx_rusty_inference_engine_tpu_torch import cli as t_cli

    for model in QOP_MODELS:
        _, qu8, qs8, _ = _qop_graphs(model)
        for form, g in (("uint8", qu8), ("int8", qs8)):
            path = tmp_path / f"{model}_{form}.onnx"
            path.write_bytes(qoperator_bytes(g))
            assert t_cli.main(["inspect", "--model", str(path)]) == 0
            body = json.loads(capsys.readouterr().out)
            assert body["unsupported_ops"] == [], (model, form)
