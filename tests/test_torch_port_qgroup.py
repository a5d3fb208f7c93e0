"""The port's grouped int8 conv (ops/kernels/qconv_grouped_int8.py), the
grouped branch of its QLinearConv emitter and its QLinearAdd / QLinearMul
emitters, held against the JAX package on the CPU.

- The grouped conv's plain version (float64 sums through F.conv2d(groups))
  against what the JAX QLinearConv emitter computes for group > 1: XLA's
  lax.conv_general_dilated(feature_group_count, preferred_element_type=
  int32), + bias, then `_requant`. Both sums are exact, so the int8 results
  are equal bit for bit: depthwise 3x3 at stride 1 and 2 (MobileNetV2's
  shapes, narrowed), a group-2 conv that is not depthwise, depthwise with a
  channel multiplier, channel counts that are not multiples of 4, with and
  without a bias, per-channel and scalar multipliers.
- The QLinearConv emitter end to end on grouped convs: the port's graph
  against the JAX emitter, bit for bit.
- QLinearAdd and QLinearMul against the JAX `_qlinear_binary` emitters on
  inputs built so that many results fall exactly on a rounding tie (x.5),
  where a reciprocal multiply in place of the true division, or rounding
  half away from zero, would move them one step: equal bit for bit, for
  int8 and for uint8 with non-zero zero points.
The kernel itself runs only on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.ops.quantized import _requant as j_requant
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_grouped_int8 as g8)
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import run_op_port, to_port
from util import make_model, node, run_op

# (B, C, H, W, O, group, kernel, stride, pad, per-channel mult, bias)
GROUPED = {
    "dw3x3_s1": (2, 32, 12, 12, 32, 32, 3, 1, 1, True, True),
    "dw3x3_s2": (2, 96, 11, 12, 96, 96, 3, 2, 1, True, True),
    "dw3x3_s2_scalar_nobias": (1, 24, 9, 9, 24, 24, 3, 2, 1, False, False),
    "dw3x3_c6_unaligned": (2, 6, 7, 5, 6, 6, 3, 1, 1, True, True),
    "group2_3x3": (2, 16, 8, 9, 24, 2, 3, 1, 1, True, True),
    "group2_c10_o6": (1, 10, 6, 7, 6, 2, 3, 2, 1, True, False),
    "dw_multiplier2": (2, 8, 7, 7, 16, 8, 3, 1, 1, True, True),
    "group4_1x1": (2, 16, 5, 5, 32, 4, 1, 1, 0, False, True),
}


def _case(name, seed=5):
    B, C, H, W, O, group, k, s, p, per_ch, with_bias = GROUPED[name]
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (B, C, H, W), dtype=np.int8)
    w = rng.integers(-127, 128, (O, C // group, k, k), dtype=np.int8)
    b = (rng.integers(-3000, 3000, (O,), dtype=np.int32)
         if with_bias else None)
    mult = ((np.abs(rng.standard_normal(O)) * 2e-3 + 1e-3).astype(np.float32)
            if per_ch else np.float32(0.004))
    return x, w, b, mult, group, k, s, p


def _jax_grouped(x, w, b, mult, group, s, p):
    """The JAX QLinearConv emitter's group > 1 arithmetic."""
    acc = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=(s, s),
        padding=[(p, p), (p, p)],
        dimension_numbers=lax.ConvDimensionNumbers(
            lhs_spec=(0, 1, 2, 3), rhs_spec=(0, 1, 2, 3),
            out_spec=(0, 1, 2, 3)),
        feature_group_count=group, preferred_element_type=jnp.int32)
    if b is not None:
        acc = acc + jnp.asarray(b).reshape(1, -1, 1, 1)
    m = jnp.asarray(mult)
    if m.ndim == 1:
        m = m.reshape(1, -1, 1, 1)
    return np.asarray(j_requant(acc, m, None))


@pytest.mark.parametrize("name", list(GROUPED))
def test_grouped_plain_equals_lax_grouped_conv(name):
    x, w, b, mult, group, k, s, p = _case(name)
    want = _jax_grouped(x, w, b, mult, group, s, p)
    got = g8.qconv_grouped_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.as_tensor(mult),
        None if b is None else torch.from_numpy(b), stride=(s, s),
        padding=((p, p), (p, p))).numpy()
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["dw3x3_s1", "group2_3x3",
                                  "dw3x3_c6_unaligned", "dw_multiplier2"])
def test_grouped_qlinearconv_emitter_matches_jax(name):
    x, w, b, mult, group, k, s, p = _case(name, seed=9)
    O = w.shape[0]
    w_s = (np.full(O, 0.01, np.float32) if np.ndim(mult)
           else np.float32(0.01))
    inits = {"x_s": np.float32(0.05), "x_zp": np.int8(0), "w": w,
             "w_s": w_s, "w_zp": np.zeros(np.shape(w_s), np.int8),
             "y_s": np.float32(0.7), "y_zp": np.int8(0)}
    if b is not None:
        inits["b"] = b
    attrs = dict(kernel_shape=[k, k], strides=[s, s], pads=[p] * 4,
                 group=group)
    (want,) = run_op("QLinearConv", {"x": x}, inits, **attrs)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **attrs)
    assert got.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pack_grouped_weight_layout():
    w = torch.arange(6 * 2 * 3 * 3, dtype=torch.int32).remainder(251).sub(
        125).to(torch.int8).reshape(6, 2, 3, 3)
    packed = g8.pack_qconv_grouped_weight(w)
    assert tuple(packed.shape) == (3 * 3 * 2, 8)
    for kh in range(3):
        for kw in range(3):
            for c in range(2):
                row = packed[(kh * 3 + kw) * 2 + c]
                assert torch.equal(row[:6], w[:, c, kh, kw])
                assert not row[6:].any()


@pytest.mark.parametrize("C,Cg,O,group,aligned,mode", [
    (32, 1, 32, 32, True, "depthwise"),
    (960, 1, 960, 960, True, "depthwise"),
    (32, 1, 32, 32, False, "general"),
    (6, 1, 6, 6, True, "general"),
    (16, 8, 24, 2, True, "general"),
    (10, 5, 6, 2, True, "general"),
    (8, 1, 16, 8, True, "general"),
])
def test_grouped_mode(C, Cg, O, group, aligned, mode):
    assert g8.grouped_mode(C, Cg, O, group, aligned) == mode


def test_conv_groups_refuses_channels_that_do_not_split():
    assert g8.conv_groups((1, 12, 5, 5), (6, 4, 3, 3)) == 3
    with pytest.raises(ValueError):
        g8.conv_groups((1, 12, 5, 5), (7, 4, 3, 3))
    with pytest.raises(ValueError):
        g8.conv_groups((1, 10, 5, 5), (6, 4, 3, 3))


def test_dilated_grouped_qlinearconv_still_raises():
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (1, 8, 9, 9), dtype=np.int8)
    inits = {"x_s": np.float32(0.05), "x_zp": np.int8(0),
             "w": rng.integers(-127, 128, (8, 1, 3, 3), dtype=np.int8),
             "w_s": np.float32(0.01), "w_zp": np.int8(0),
             "y_s": np.float32(0.5), "y_zp": np.int8(0)}
    with pytest.raises(UnsupportedOpError, match="dilation"):
        run_op_port("QLinearConv", {"x": x}, inits, kernel_shape=[3, 3],
                    group=8, dilations=[2, 2])


def _binary_case(op, dtype, seed):
    """Operands whose dequantized sum or product often lands exactly on a
    rounding tie of the output scale."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max + 1, (4, 6, 5, 5)).astype(dtype)
    b = rng.integers(info.min, info.max + 1, (4, 6, 5, 5)).astype(dtype)
    zp = dtype(0) if dtype == np.int8 else dtype(128)
    if op == "QLinearAdd":
        # (a - zp) / 2 + (b - zp) / 4 in quarters; y_s = 0.5: x.5 ties
        scales = (np.float32(0.5), np.float32(0.25), np.float32(0.5))
    else:
        # (a - zp)(b - zp) / 4 over y_s = 2: a multiple of 1/8, ties at 4/8
        scales = (np.float32(0.5), np.float32(0.5), np.float32(2.0))
    return a, b, zp, scales


@pytest.mark.parametrize("op", ["QLinearAdd", "QLinearMul"])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_qlinear_binary_matches_jax_at_ties(op, dtype):
    a, b, zp, (a_s, b_s, y_s) = _binary_case(op, dtype, 3)
    inits = {"a_s": a_s, "a_zp": zp, "b_s": b_s, "b_zp": zp, "y_s": y_s,
             "y_zp": zp}
    feeds = {"a": a, "b": b}
    want = _run_binary(JEngine, j_import, op, feeds, inits)
    got = _run_binary(lambda g: Engine(g, device="cpu"), to_port, op, feeds,
                      inits)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the case holds ties: results exactly half-way before rounding
    af = (a.astype(np.float64) - float(zp)) * float(a_s)
    bf = (b.astype(np.float64) - float(zp)) * float(b_s)
    pre = (af + bf if op == "QLinearAdd" else af * bf) / float(y_s)
    assert (np.abs(pre - np.floor(pre) - 0.5) == 0).mean() > 0.05


def _run_binary(engine, importer, op, feeds, inits):
    """One QLinearAdd / QLinearMul node with its inputs in ONNX order (the
    operands interleaved with their scales and zero points), run by one
    package."""
    names = ["a", "a_s", "a_zp", "b", "b_s", "b_zp", "y_s", "y_zp"]
    m = make_model([node(op, names, ["out0"])], feeds, ["out0"], inits, 13)
    return engine(importer(m)).run(feeds).outputs["out0"]
