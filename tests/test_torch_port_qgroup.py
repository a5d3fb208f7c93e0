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
from test_torch_port_cuda import (GROUPED_CASES, TILE_EDGE_CASES,
                                  _mobilenet_depthwise_convs)
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


@pytest.mark.parametrize("C,Cg,O,group,kernel,stride,align,mode", [
    (32, 1, 32, 32, (3, 3), (1, 1), 16, "tile"),
    (960, 1, 960, 960, (3, 3), (2, 2), 16, "tile"),
    (32, 1, 32, 32, (3, 3), (1, 1), 4, "general"),
    (32, 1, 32, 32, (3, 3), (1, 2), 16, "general"),
    (32, 1, 32, 32, (3, 3), (3, 3), 16, "general"),
    (32, 1, 32, 32, (5, 5), (1, 1), 16, "general"),
    (36, 1, 36, 36, (3, 3), (1, 1), 16, "general"),
    (32, 1, 32, 32, (3, 3), (1, 1), 2, "general"),
    (6, 1, 6, 6, (3, 3), (1, 1), 16, "general"),
    (16, 8, 24, 2, (3, 3), (1, 1), 16, "general"),
    (10, 5, 6, 2, (3, 3), (1, 1), 16, "general"),
    (8, 1, 16, 8, (3, 3), (1, 1), 16, "general"),
])
def test_grouped_mode(C, Cg, O, group, kernel, stride, align, mode):
    assert g8.grouped_mode(C, Cg, O, group, kernel, stride, align) == mode


def test_address_align():
    assert [g8.address_align(p) for p in (0, 1, 2, 4, 12, 48, 4096)] == \
        [16, 1, 2, 4, 4, 16, 16]


def _plan_shapes():
    """(id, x shape, w shape, stride, padding, the plan's constants, the
    input's alignment): MobileNetV2's 17 depthwise convs at b256 and every
    grouped shape of the card tests, with their narrowed constants."""
    out = [(f"mobilenet{i}_c{C}_h{H}_s{s}", (256, C, H, H), (C, 1, 3, 3),
            (s, s), ((1, 1), (1, 1)), {}, 16)
           for i, (C, H, s) in enumerate(_mobilenet_depthwise_convs())]
    for name, (B, C, H, W, O, group, k, s, (pt, pb, pl, pr), _) in \
            GROUPED_CASES.items():
        out.append((name, (B, C, H, W), (O, C // group, k, k), (s, s),
                    ((pt, pb), (pl, pr)), {}, 16))
    for name, (B, C, H, W, s, (pt, pb, pl, pr), consts, offset) in \
            TILE_EDGE_CASES.items():
        out.append((name, (B, C, H, W), (C, 1, 3, 3), (s, s),
                    ((pt, pb), (pl, pr)), consts, g8.address_align(offset)))
    return out


@pytest.mark.parametrize("name,xs,ws,stride,padding,consts,align",
                         _plan_shapes(), ids=[c[0] for c in _plan_shapes()])
def test_grouped_plan_covers_each_output_once(name, xs, ws, stride,
                                              padding, consts, align,
                                              monkeypatch):
    """The tile form's plan at every shape, as the kernel's entry point
    takes it (`tile_args`): its tiles, split as the kernel splits a tile id
    (channel runs fastest, then columns, rows, images), and each tile's
    threads (4 channels x 2 columns x the tile's rows, masked to the image)
    write each output of one image exactly once; the grid counts every
    image; the input boxes fit TMA (sides <= 256, runs of 16-byte
    multiples) and every read stays inside its box; the staging buffers
    hold a box; a block's threads and shared memory fit (256, 227 KB). The
    form is the one the wrapper counts in `.schedules`: `grouped_mode` of
    the shapes."""
    for k, v in consts.items():
        monkeypatch.setattr(g8, k, v)
    B, C, H, W = xs
    O, Cg, KH, KW = ws
    plan = g8.grouped_plan(xs, ws, stride, padding, align)
    assert plan["form"] == g8.grouped_mode(C, Cg, O, C // Cg, (KH, KW),
                                           stride, align)
    assert plan["form"] in g8.qconv_grouped_int8_requant.schedules
    if name.startswith("mobilenet"):
        assert plan["form"] == "tile"
    if plan["form"] != "tile":
        assert plan["tile"] is None and plan["grid"][0] > 0
        return
    s = stride[0]
    (pt, pb), (pl, pr) = padding
    OH, OW = (H + pt + pb - 3) // s + 1, (W + pl + pr - 3) // s + 1
    th, tw, run, bh, bw, buf, smem, threads, n_h, n_w, n_c = \
        g8.tile_args(plan)
    assert (plan["run"], plan["box"]) == (run, (bh, bw, run))
    assert tw % 2 == 0 and run % 16 == 0
    assert (bh, bw) == ((th - 1) * s + 3, (tw - 1) * s + 3)
    assert max(bh, bw, run) <= 256
    # the last input row and column a thread reads lie inside the box
    assert (th - 1) * s + 2 < bh and 2 * s * (tw // 2 - 1) + 2 + s < bw
    q, p = run // 4, tw // 2
    assert q * p <= threads <= 256 and threads % 32 == 0
    assert buf % 128 == 0 and bh * bw * run <= buf < bh * bw * run + 128
    assert 2 * buf + 16 <= smem <= 227 * 1024
    assert plan["grid"] == (B, n_h, n_w, n_c)
    assert plan["tiles"] == B * n_h * n_w * n_c
    seen = np.zeros((OH, OW, C), np.int32)
    for t in range(n_h * n_w * n_c):   # image 0's tiles
        cr, rest = t % n_c, t // n_c
        tw_i, th_i = rest % n_w, rest // n_w
        oh0 = th_i * th
        rows = min(th, OH - oh0)
        assert rows >= 1
        for tid in range(q * p):
            c = cr * run + 4 * (tid % q)
            ow = tw_i * tw + 2 * (tid // q)
            if c >= C or ow >= OW:
                continue
            seen[oh0:oh0 + rows, ow:ow + 2, c:c + 4] += 1
    assert (seen == 1).all(), (seen.min(), seen.max())


def test_conv_groups_refuses_channels_that_do_not_split():
    assert g8.conv_groups((1, 12, 5, 5), (6, 4, 3, 3)) == 3
    with pytest.raises(ValueError):
        g8.conv_groups((1, 12, 5, 5), (7, 4, 3, 3))
    with pytest.raises(ValueError):
        g8.conv_groups((1, 10, 5, 5), (6, 4, 3, 3))


def test_dilated_grouped_qlinearconv_matches_jax():
    """Formerly pinned as a refusal: a dilated depthwise conv now runs (the
    grouped kernel's general form) and gives the JAX emitter's values."""
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, (1, 8, 9, 9), dtype=np.int8)
    inits = {"x_s": np.float32(0.05), "x_zp": np.int8(0),
             "w": rng.integers(-127, 128, (8, 1, 3, 3), dtype=np.int8),
             "w_s": np.float32(0.01), "w_zp": np.int8(0),
             "y_s": np.float32(0.5), "y_zp": np.int8(0)}
    kw = dict(kernel_shape=[3, 3], group=8, dilations=[2, 2])
    (want,) = run_op("QLinearConv", {"x": x}, inits, **kw)
    (got,) = run_op_port("QLinearConv", {"x": x}, inits, **kw)
    assert got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


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


@pytest.mark.parametrize("xdt,zx,zy", [(torch.uint8, 128, 255),
                                       (torch.int8, -128, -3)])
def test_grouped_plain_versions_take_the_qoperator_forms(xdt, zx, zy):
    """The grouped kernel's plain versions: padding taps hold pad_value,
    the requant adds y_zp and saturates to out_dtype, the int32 output is
    the exact sums plus the bias; against a float64 reference."""
    rng = np.random.default_rng(10)
    info = torch.iinfo(xdt)
    x = torch.from_numpy(rng.integers(info.min, info.max + 1, (2, 8, 7, 9))
                         .astype(np.uint8 if xdt == torch.uint8 else np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (8, 2, 3, 3), np.int8))
    mult = torch.from_numpy((np.abs(rng.standard_normal(8)) * 4e-3 + 1e-4)
                            .astype(np.float32))
    bias = torch.from_numpy(rng.integers(-3000, 3000, (8,), np.int32))
    kw = dict(stride=(1, 2), padding=((1, 1), (2, 0)), dilation=(1, 2),
              pad_value=zx)
    xd = torch.nn.functional.pad(x.double(), (2, 0, 1, 1), value=float(zx))
    sums = torch.nn.functional.conv2d(xd, w.double(), stride=(1, 2),
                                      dilation=(1, 2), groups=4)
    sums = sums + bias.double().reshape(1, -1, 1, 1)
    assert torch.equal(g8.qconv_grouped_int8(x, w, bias, **kw), sums.int())
    y = torch.round(sums.float() * mult.reshape(1, -1, 1, 1)) + zy
    got = g8.qconv_grouped_int8_requant(x, w, mult, bias, **kw, y_zp=zy,
                                        out_dtype=xdt)
    assert got.dtype == xdt
    assert torch.equal(got, y.clamp(info.min, info.max).to(xdt))
