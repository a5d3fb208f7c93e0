"""The INT8 path made whole, held against the JAX package on the CPU:
zero points computed at run time, a narrow R3D-18 (3-D convs) in fp32 and
INT8, and ONNX Runtime's dynamically quantized SqueezeNet.

- Run-time zero points: one QLinearConv / ConvInteger / QLinearMatMul /
  QGemm node whose x (a), w (b) or y zero points are graph inputs (what a
  DynamicQuantizeLinear before it gives), through both packages' Engines
  on the same seeded inputs. Every int32 output exact, every requantized
  one bit-equal to JAX's (QGemm's within 1 LSB, as with constant zero
  points: its multiplier folds alpha and y_s), and the port's run-time form
  bit-equal to its own run with the same values as constants.
- R3D-18 at width 8 with one BasicBlock a stage over 4x16x16 clips
  (tests/torch_port_video.py): fp32 logits within 1e-5 x max|ref| of
  JAX's; both quantizers build the same INT8 graph from the same ranges;
  every QLinearConv of it, fed JAX's inputs, bit-equal to JAX's output.
- SqueezeNet 1.0 (full widths, 64x64 images) in ORT's quantize_dynamic
  form (tests/torch_port_dynamic.py): each ConvInteger, fed JAX's inputs,
  exact; every DynamicQuantizeLinear bit-equal; the logits within 1e-5 x
  max|ref|.
"""

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine as TEngine
from onnx_rusty_inference_engine_tpu_torch.graph import (
    export_model as t_export, import_model as t_import)
from onnx_rusty_inference_engine_tpu_torch.models import build_squeezenet
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_graph as t_quantize)
from test_torch_port_squeezenet import _teacher_forced
from torch_port_dynamic import dynamic_bytes
from torch_port_util import assert_graphs_equal, to_port
from torch_port_video import R3D_INPUT, R3D_LOGITS, build_r3d18
from util import make_model, node


def _both(op, named, runtime, domain="", **attrs):
    """One `op` node over `named` ((name, value) in ONNX input order),
    the names in `runtime` graph inputs (values computed before the node,
    as far as it knows), the rest initializers: (JAX's output, the port's,
    the port's with every value an initializer)."""
    feeds = {k: np.asarray(v) for k, v in named if k in runtime}
    inits = {k: v for k, v in named if k not in runtime}
    n = node(op, [k for k, _ in named], ["y"], domain=domain, **attrs)
    m = make_model([n], feeds, ["y"], inits)
    want = JEngine(j_import(j_io.parse_model(j_io.serialize_model(m)))).run(
        feeds).outputs["y"]
    got = TEngine(to_port(m), device="cpu").run(feeds).outputs["y"]
    const = make_model([node(op, [k for k, _ in named], ["y"], domain=domain,
                             **attrs)],
                       {}, ["y"], dict(named))
    fixed = TEngine(to_port(const), device="cpu").run({}).outputs["y"]
    return np.asarray(want), got, fixed


def _q(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


# --------------------------------------------------------------------------
# run-time zero points
# --------------------------------------------------------------------------
# case -> (x shape, O, kernel, group, x dtype, attrs, run-time inputs)
RT_CONV = {
    "2d_x_y": ((2, 8, 7, 7), 6, (3, 3), 1, np.int8, dict(pads=[1, 1, 1, 1]),
               {"x_zp", "y_zp"}),
    "2d_uint8_x_y_scale": ((1, 8, 6, 9), 4, (3, 3), 1, np.uint8,
                           dict(pads=[1, 2, 0, 1], strides=[2, 1]),
                           {"x", "x_s", "x_zp", "y_zp"}),
    "2d_w_per_channel": ((1, 4, 6, 6), 5, (3, 3), 1, np.int8,
                         dict(pads=[1, 1, 1, 1]), {"x_zp", "w_zp"}),
    "grouped_x_y": ((1, 16, 8, 8), 16, (3, 3), 16, np.int8,
                    dict(pads=[1, 1, 1, 1]), {"x_zp", "y_zp"}),
    "3d_x_y": ((1, 4, 4, 5, 6), 6, (3, 3, 3), 1, np.uint8,
               dict(pads=[1, 1, 1, 1, 1, 1], strides=[1, 2, 1]),
               {"x_zp", "y_zp"}),
    "1d_x": ((2, 8, 11), 4, (3,), 1, np.int8, dict(pads=[1, 1]), {"x_zp"}),
}


@pytest.mark.parametrize("case", list(RT_CONV))
def test_qlinearconv_runtime_zero_points_match_jax(case):
    shape, O, k, group, xd, attrs, runtime = RT_CONV[case]
    rng = np.random.default_rng(31)
    x = _q(rng, shape, xd)
    zx = xd(rng.integers(np.iinfo(xd).min + 20, np.iinfo(xd).max - 20))
    zw = (rng.integers(-3, 4, O).astype(np.int8) if "w_zp" in runtime
          else np.int8(0))
    # int8 y (the JAX emitter saturates every output to int8)
    named = [("x", x), ("x_s", np.float32(0.05)), ("x_zp", zx),
             ("w", _q(rng, (O, shape[1] // group) + k, np.int8)),
             ("w_s", (np.abs(rng.standard_normal(O)) * 0.01 + 2e-3
                      ).astype(np.float32)),
             ("w_zp", zw), ("y_s", np.float32(0.4)), ("y_zp", np.int8(-9)),
             ("b", rng.integers(-3000, 3000, O).astype(np.int32))]
    want, got, fixed = _both("QLinearConv", named, runtime,
                             kernel_shape=list(k), group=group, **attrs)
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fixed)


# case -> (x dtype, w dtype, x shape, group, attrs, run-time inputs)
RT_CONVINT = {
    "uint8_x": (np.uint8, np.int8, (2, 6, 7, 8), 1, dict(pads=[1, 1, 1, 1]),
                {"x_zp"}),
    "uint8_x_uint8_w": (np.uint8, np.uint8, (1, 6, 7, 7), 1,
                        dict(pads=[1, 0, 1, 2], strides=[2, 1]),
                        {"x_zp", "w_zp"}),
    "grouped": (np.uint8, np.int8, (1, 6, 6, 6), 3, dict(pads=[1, 1, 1, 1]),
                {"x_zp"}),
    "3d_per_channel_w": (np.int8, np.int8, (1, 4, 5, 5, 5), 1,
                         dict(pads=[1, 1, 1, 1, 1, 1]), {"x_zp", "w_zp"}),
}


@pytest.mark.parametrize("case", list(RT_CONVINT))
def test_convinteger_runtime_zero_points_match_jax_exactly(case):
    xd, wd, shape, group, attrs, runtime = RT_CONVINT[case]
    rng = np.random.default_rng(32)
    k = (3,) * (len(shape) - 2)
    O = 6
    per_ch = "w_zp" in runtime and len(shape) == 5
    zw = (_q(rng, (O,), wd) if per_ch
          else wd(np.iinfo(wd).min + 130))
    named = [("x", _q(rng, shape, xd)),
             ("w", _q(rng, (O, shape[1] // group) + k, wd)),
             ("x_zp", xd(np.iinfo(xd).min + 117)), ("w_zp", zw)]
    want, got, fixed = _both("ConvInteger", named, runtime,
                             kernel_shape=list(k), group=group, **attrs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fixed)


# case -> (a shape, b shape, run-time inputs)
RT_QMM = {
    "a_y": ((5, 24), (24, 10), {"a_zp", "y_zp"}),
    "a_b": ((2, 3, 20), (20, 6), {"a_zp", "b_zp"}),
    "y_only": ((4, 16), (16, 8), {"y_zp"}),
    "batched_a_y": ((2, 5, 12), (2, 12, 7), {"a", "a_zp", "y_zp"}),
}


@pytest.mark.parametrize("case", list(RT_QMM))
def test_qlinearmatmul_runtime_zero_points_match_jax(case):
    a_shape, b_shape, runtime = RT_QMM[case]
    rng = np.random.default_rng(33)
    named = [("a", _q(rng, a_shape, np.int8)), ("a_s", np.float32(0.04)),
             ("a_zp", np.int8(-13)), ("b", _q(rng, b_shape, np.int8)),
             ("b_s", np.float32(0.003)), ("b_zp", np.int8(3)),
             ("y_s", np.float32(0.5)), ("y_zp", np.int8(6))]
    want, got, fixed = _both("QLinearMatMul", named, runtime)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fixed)


@pytest.mark.parametrize("float_out", [False, True])
def test_qgemm_runtime_zero_points_match_jax(float_out):
    rng = np.random.default_rng(34)
    M, K, N = 6, 20, 9
    named = [("a", _q(rng, (M, K), np.uint8)), ("a_s", np.float32(0.03)),
             ("a_zp", np.uint8(141)),
             ("b", _q(rng, (N, K), np.int8)), ("b_s", np.float32(0.002)),
             ("b_zp", np.int8(0)),
             ("c", rng.integers(-2000, 2000, (N,)).astype(np.int32))]
    if not float_out:
        named += [("y_s", np.float32(0.4)), ("y_zp", np.uint8(120))]
    runtime = {"a_zp"} | (set() if float_out else {"y_zp"})
    want, got, fixed = _both("QGemm", named, runtime, domain="com.microsoft",
                             transB=1)
    np.testing.assert_array_equal(got, fixed)
    if float_out:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
            <= 1


# --------------------------------------------------------------------------
# R3D-18, narrow
# --------------------------------------------------------------------------
R3D_NARROW = dict(width=8, blocks=(1, 1, 1, 1), num_classes=10,
                  clip=(3, 4, 16, 16))


@pytest.fixture(scope="module")
def r3d():
    m = build_r3d18(**R3D_NARROW)
    feed = {R3D_INPUT: np.random.default_rng(35).standard_normal(
        (4, *R3D_NARROW["clip"])).astype(np.float32)}
    return j_import(m), to_port(m), feed


def test_r3d_fp32_matches_jax(r3d):
    jg, tg, feed = r3d
    convs = [n for n in tg.nodes if n.op_type == "Conv"]
    assert len(convs) == 12 and all(len(n.attrs["kernel_shape"]) == 3
                                    for n in convs)
    want = JEngine(jg).run(feed).outputs[R3D_LOGITS]
    got = TEngine(tg, device="cpu").run(feed).outputs[R3D_LOGITS]
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_r3d_int8_matches_jax(r3d):
    """Calibrated (minmax) on the first 2 clips; the same ranges give the
    same graph in both packages; each QLinearConv and the fc's
    QLinearMatMul, fed JAX's values of its inputs, equal JAX's bit for
    bit, the other int8 nodes within 1 LSB; run free, the logits within
    2 steps of their scale and the same top-1."""
    jg, tg, feed = r3d
    ranges = j_calibrate(jg, [{R3D_INPUT: feed[R3D_INPUT][:2]}])
    jq = j_quantize(jg, ranges=ranges)
    tq = t_quantize(tg, ranges=ranges)
    assert_graphs_equal(jq, tq)
    ops = [n.op_type for n in tq.nodes]
    assert ops.count("QLinearConv") == 12 and ops.count("QLinearMatMul") == 1
    want = dump_intermediates(jq, feed)
    got = _teacher_forced(tq, {**want, **feed})
    kinds = {o: n.op_type for n in tq.nodes for o in n.outputs}
    exact = 0
    for name, v in got.items():
        w = np.asarray(want[name])
        assert v.dtype == w.dtype and v.shape == w.shape, name
        if kinds[name] in ("QLinearConv", "QLinearMatMul"):
            np.testing.assert_array_equal(v, w, err_msg=name)
            exact += 1
        elif v.dtype == np.int8:
            assert np.abs(v.astype(np.int32) - w.astype(np.int32)).max() \
                <= 1, name
    assert exact == 13
    free = TEngine(tq, device="cpu").run(feed).outputs[R3D_LOGITS]
    ref = JEngine(jq).run(feed).outputs[R3D_LOGITS]
    step = float(np.abs(ref).max()) / 127
    assert np.abs(free - ref).max() <= 2 * step + 1e-6
    assert np.array_equal(free.argmax(1), ref.argmax(1))


# --------------------------------------------------------------------------
# ORT's dynamically quantized SqueezeNet
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dynamic():
    data = dynamic_bytes(to_port(build_squeezenet(seed=0)))
    feed = {"data_0": np.random.default_rng(36).standard_normal(
        (2, 3, 64, 64)).astype(np.float32)}
    return (j_import(j_io.parse_model(data)),
            t_import(t_io.parse_model(data)), feed)


def test_dynamic_squeezenet_matches_jax(dynamic):
    jg, tg, feed = dynamic
    ops = [n.op_type for n in tg.nodes]
    assert ops.count("ConvInteger") == 26
    assert ops.count("DynamicQuantizeLinear") == 18
    want = dump_intermediates(jg, feed)
    got = _teacher_forced(tg, {**want, **feed})
    kinds = {o: n.op_type for n in tg.nodes for o in n.outputs}
    checked = 0
    for name, v in got.items():
        w = np.asarray(want[name])
        assert v.dtype == w.dtype and v.shape == w.shape, name
        if kinds[name] in ("ConvInteger", "DynamicQuantizeLinear"):
            np.testing.assert_array_equal(v, w, err_msg=name)
            checked += 1
    assert checked == 26 + 3 * 18
    logits = tg.outputs[0]
    free = TEngine(tg, device="cpu").run(feed).outputs[logits]
    ref = JEngine(jg).run(feed).outputs[logits]
    np.testing.assert_allclose(free, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_dynamic_form_round_trips_as_bytes(dynamic):
    """The port's export of the dynamic graph parses back to the same
    graph, its zero points still computed at run time."""
    _, tg, _ = dynamic
    again = t_import(t_io.parse_model(t_io.serialize_model(t_export(tg))))
    assert_graphs_equal(tg, again)
    for n in again.nodes:
        if n.op_type == "ConvInteger":
            assert n.inputs[2] not in again.constants


# --------------------------------------------------------------------------
# the 3-D conv's plan, weight layout, input layout and fake result (CPU)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("x_shape,w_shape,stride,pads", [
    ((16, 3, 16, 112, 112), (64, 3, 3, 7, 7), (1, 2, 2), (1, 3, 3)),
    ((16, 64, 16, 56, 56), (128, 64, 1, 1, 1), (2, 2, 2), (0, 0, 0)),
    ((16, 256, 4, 14, 14), (512, 256, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 8, 3, 5, 6), (20, 8, 2, 3, 1), (1, 1, 1), (0, 1, 0)),
])
def test_3d_conv_plan_and_layouts(x_shape, w_shape, stride, pads):
    """A stride-1 3-D conv over C % 16 == 0 channels, and R3D-18's stem as
    its space-to-depth rewrite, on the staged-halo producer (BM 64 x 2 or
    4 planes, BN one of HALO_BN), every other on
    the gather, on a tile whose instances carry the 3-D form (TILE_3D_BM x
    TILE_3D_BN); the packed weight's rows in (kd, kh, kw, c) order; a
    channels_last_3d input read in place; the fake result's shape and
    strides those of the kernel's output view."""
    import torch

    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_int8 as k)

    padding = tuple((p, p) for p in pads)
    producer, tile = k.conv_plan(x_shape, w_shape, stride, padding)
    halo = (tuple(stride) == (1, 1, 1) and w_shape[1] % 16 == 0
            or k.stem_s2d(w_shape[1], w_shape[2:], stride))
    assert producer == ("halo" if halo else "gather")
    if halo:
        assert tile.bm in [64 * p for p in k.HALO_PLANES]
        assert tile.bn in k.HALO_BN
    else:
        assert tile.bm in k.TILE_3D_BM and tile.bn in k.TILE_3D_BN
        assert tile.bn >= min(w_shape[0], k.TILE_3D_BN[-1])
    rng = np.random.default_rng(37)
    w = torch.from_numpy(_q(rng, w_shape, np.int8))
    packed = k.pack_qconv_weight(w)
    O, C = w_shape[:2]
    Cp = k.conv_channels(C)
    taps = int(np.prod(w_shape[2:]))
    assert packed.shape == (O, -(-taps * Cp // k.K_ALIGN) * k.K_ALIGN)
    want = torch.zeros((O,) + tuple(w_shape[2:]) + (Cp,), dtype=torch.int8)
    want[..., :C] = w.permute(0, 2, 3, 4, 1)
    assert torch.equal(packed[:, :taps * Cp], want.reshape(O, -1))
    assert not packed[:, taps * Cp:].any()
    small = (1,) + tuple(x_shape[1:2]) + tuple(min(n, 6) for n in x_shape[2:])
    x = torch.from_numpy(_q(rng, small, np.int8))
    xc = x.contiguous(memory_format=torch.channels_last_3d)
    xl = k.channels_last_input(xc)
    assert xl.shape == small[:1] + small[2:] + (Cp,)
    assert torch.equal(xl[..., :C], x.permute(0, 2, 3, 4, 1))
    assert (xl.data_ptr() == xc.data_ptr()) == (Cp == C)
    fake = k.conv_fake(x.to("meta"), w.to("meta"), list(stride),
                       k.schema_padding(padding), [1, 1, 1], torch.int8)
    out = k.conv_out_size(small[2:], w_shape[2:], stride, padding)
    assert tuple(fake.shape) == (1, O) + out
