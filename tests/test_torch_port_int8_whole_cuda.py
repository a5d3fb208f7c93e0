"""The INT8 path made whole on the card (marker `cuda`; each test skips
without a CUDA device): the 3-D forms of both int8 conv kernels, zero
points read from device memory, and the Engines of R3D-18 and ONNX
Runtime's dynamically quantized SqueezeNet.

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_int8_whole_cuda.py -q

- The group-1 kernel's 3-D form (the gather producer, depth a run-time
  size, or the staged-halo producer where `conv_plan` names it) bit-equal
  to its plain version at R3D-18's conv shapes (2 clips), at ragged and
  strided, dilated and asymmetrically padded shapes, with int8 and uint8
  x, both epilogues, counted in the `3d` form.
- The grouped kernel's 3-D forms (tile3d where `grouped_plan` names it,
  else the general form): depthwise 3x3x3 and grouped, requant and int32,
  bit-equal to its plain version.
- A zero point given as a device tensor: every kernel reads it in the run
  (counted `device_zero_point`), bit-equal to the same value given as an
  int; inside a captured CUDA graph a new value written into the tensor
  between replays gives that value's result, bit for bit.
- The Engines: R3D-18 narrow fp32 within 1e-5 x max|ref| of the CPU and
  INT8 bit-equal to the CPU; the dynamic SqueezeNet's ConvIntegers on
  the device-zero-point form, two feeds with different zero points each
  replayed equal to its own eager run and to the CPU's ConvIntegers.
"""

import os
import sys

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_grouped_int8 as g8, qconv_int8 as k, qmatmul_int8 as m8)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_dynamic import dynamic_bytes, reparsed  # noqa: E402
from torch_port_video import (R3D_INPUT, R3D_LOGITS,  # noqa: E402
                              build_r3d18)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _q(rng, shape, dtype, dev):
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape
                                         ).astype(dtype)).to(dev)


def _operands(rng, x_shape, w_shape, xdt, dev):
    x = _q(rng, x_shape, xdt, dev)
    w = _q(rng, w_shape, np.int8, dev)
    O = w_shape[0]
    mult = torch.from_numpy((np.abs(rng.standard_normal(O)) * 2e-4 + 1e-5
                             ).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.integers(-20000, 20000, O).astype(
        np.int32)).to(dev)
    return x, w, mult, bias


# R3D-18's convs at 2 clips (x shape, O, kernel, stride, pad), and ragged /
# odd ones: C = 3 (padded to 4), a 1x1x1 stride-2 downsample, asymmetric
# pads, dilation
CONV3D = [
    ((2, 3, 16, 112, 112), 64, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
    ((2, 64, 16, 56, 56), 64, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 64, 16, 56, 56), 128, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((2, 64, 16, 56, 56), 128, (1, 1, 1), (2, 2, 2), (0, 0, 0)),
    ((2, 256, 4, 14, 14), 256, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((2, 512, 2, 7, 7), 512, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 12, 5, 9, 7), 20, (3, 3, 3), (2, 1, 2), (1, 1, 1)),
    ((1, 8, 3, 5, 6), 8, (2, 3, 1), (1, 1, 1), (0, 1, 0)),
]


@pytest.mark.parametrize("xs,O,kern,s,p", CONV3D)
@pytest.mark.parametrize("xdt", [np.int8, np.uint8])
def test_3d_conv_equals_plain(cuda, xs, O, kern, s, p, xdt):
    rng = np.random.default_rng(sum(xs) + O)
    x, w, mult, bias = _operands(rng, xs, (O, xs[1]) + kern, xdt, cuda)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    pad = tuple((q, q) for q in p)
    zx = 131 if xdt == np.uint8 else -7
    kw = dict(stride=s, padding=pad, pad_value=zx)
    packed = k.pack_qconv_weight(w, s)
    before = dict(k.qconv_int8_requant.forms)
    got = k.qconv_int8_requant(x, w, mult, bias, **kw, y_zp=5,
                               packed=packed)
    acc = k.qconv_int8(x, w, **kw, packed=packed)
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.forms["3d"] == before["3d"] + 2
    # the staged-halo producer: unit stride, C % 16 == 0, either epilogue;
    # the stem (C 3, stride (1, 2, 2)) as its space-to-depth rewrite
    assert k.conv_plan(x.shape, w.shape, s, pad)[0] == (
        "halo" if s == (1, 1, 1) and xs[1] % 16 == 0
        or k.stem_s2d(xs[1], kern, s) else "gather")
    assert k.qconv_int8_requant.forms["s2d"] == before["s2d"] + 2 * (
        k.stem_s2d(xs[1], kern, s))
    want = k.qconv_int8_requant_plain(x, w, mult, bias, **kw, y_zp=5)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(acc, k.qconv_int8_plain(x, w, **kw))
    # channels_last_3d: the next conv reads it in place
    assert k.channels_last_input(got).data_ptr() == got.data_ptr()


@pytest.mark.parametrize("pads,dil", [(((1, 2), (0, 1), (2, 0)), (1, 1, 1)),
                                      (((2, 2), (2, 2), (2, 2)), (2, 1, 2))])
def test_3d_conv_pads_and_dilation_equal_plain(cuda, pads, dil):
    rng = np.random.default_rng(5)
    x, w, mult, bias = _operands(rng, (2, 16, 6, 9, 8), (24, 16, 3, 3, 3),
                                 np.int8, cuda)
    kw = dict(stride=(1, 2, 1), padding=pads, dilation=dil, pad_value=3)
    got = k.qconv_int8_requant(x, w, mult, bias, **kw,
                               packed=k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert torch.equal(got, k.qconv_int8_requant_plain(x, w, mult, bias,
                                                       **kw))


@pytest.mark.parametrize("xs,O,group,s", [
    ((2, 64, 16, 56, 56), 64, 64, (1, 1, 1)),   # R3D layer1's activation
    ((2, 32, 8, 14, 14), 32, 32, (2, 2, 2)),
    ((1, 24, 5, 7, 9), 48, 12, (1, 2, 1)),
    ((1, 16, 3, 5, 5), 16, 16, (1, 1, 1)),
])
@pytest.mark.parametrize("xdt", [np.int8, np.uint8])
def test_3d_grouped_conv_equals_plain(cuda, xs, O, group, s, xdt):
    rng = np.random.default_rng(xs[1] + group)
    x, w, mult, bias = _operands(rng, xs, (O, xs[1] // group, 3, 3, 3), xdt,
                                 cuda)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    zx = 140 if xdt == np.uint8 else 9
    kw = dict(stride=s, padding=((1, 1),) * 3, pad_value=zx)
    packed = g8.pack_qconv_grouped_weight(w)
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    got = g8.qconv_grouped_int8_requant(x, w, mult, bias, **kw, y_zp=-3,
                                        packed=packed)
    acc = g8.qconv_grouped_int8(x, w, bias, **kw, packed=packed)
    torch.cuda.synchronize()
    # the requant output on tile3d where the plan names it (a depthwise
    # 3x3x3, C % 16 == 0), the int32 output on the general form
    form = g8.grouped_plan(x.shape, w.shape, s, kw["padding"],
                           g8.input_align(x))["form"]
    assert form == ("tile3d" if O == group and xs[1] % 16 == 0
                    else "general")
    after = g8.qconv_grouped_int8_requant.schedules
    assert after["general"] == before["general"] + 1 + (form == "general")
    assert after["tile3d"] == before["tile3d"] + (form == "tile3d")
    assert torch.equal(got, g8.qconv_grouped_int8_requant_plain(
        x, w, mult, bias, **kw, y_zp=-3))
    assert torch.equal(acc, g8.qconv_grouped_int8_plain(x, w, bias, **kw))


def _zp(v, dev):
    return torch.tensor([v], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("spatial", [2, 3])
@pytest.mark.parametrize("grouped", [False, True])
def test_device_zero_points_equal_ints_and_replay(cuda, spatial, grouped):
    """pad value and y zero point as device tensors: equal to the ints;
    captured once, a new value written between replays takes effect."""
    rng = np.random.default_rng(11 + spatial)
    C = 16
    xs = (2, C) + ((4,) if spatial == 3 else ()) + (9, 9)
    ws = ((C, 1) if grouped else (24, C)) + (3,) * spatial
    x, w, mult, bias = _operands(rng, xs, ws, np.uint8, cuda)
    mod = g8 if grouped else k
    conv = mod.qconv_grouped_int8_requant if grouped else \
        k.qconv_int8_requant
    plain = mod.qconv_grouped_int8_requant_plain if grouped else \
        k.qconv_int8_requant_plain
    packed = (g8.pack_qconv_grouped_weight if grouped
              else k.pack_qconv_weight)(w)
    kw = dict(padding=((1, 1),) * spatial, out_dtype=torch.uint8)
    zx, zy = _zp(131, cuda), _zp(17, cuda)
    forms = conv.forms if grouped else k.qconv_int8_requant.forms
    before = forms["device_zero_point"]
    got = conv(x, w, mult, bias, **kw, pad_value=zx, y_zp=zy, packed=packed)
    torch.cuda.synchronize()
    assert forms["device_zero_point"] == before + 1
    assert torch.equal(got, plain(x, w, mult, bias, **kw, pad_value=131,
                                  y_zp=17))
    # captured: the tensors' values are read at each replay
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        conv(x, w, mult, bias, **kw, pad_value=zx, y_zp=zy, packed=packed)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv(x, w, mult, bias, **kw, pad_value=zx, y_zp=zy,
                   packed=packed)
    for a, b in ((131, 17), (3, 250), (255, 0)):
        zx.fill_(a)
        zy.fill_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, plain(x, w, mult, bias, **kw, pad_value=a,
                                      y_zp=b)), (a, b)


def test_device_zero_points_on_the_int32_epilogues(cuda):
    rng = np.random.default_rng(12)
    x, w, _, _ = _operands(rng, (2, 8, 3, 7, 7), (8, 8, 3, 3, 3), np.uint8,
                           cuda)
    zx = _zp(200, cuda)
    pad = ((1, 1),) * 3
    got = k.qconv_int8(x, w, padding=pad, pad_value=zx,
                       packed=k.pack_qconv_weight(w))
    wg = w[:, :1].contiguous()
    got_g = g8.qconv_grouped_int8(x, wg, None, padding=pad, pad_value=zx,
                                  packed=g8.pack_qconv_grouped_weight(wg))
    torch.cuda.synchronize()
    assert torch.equal(got, k.qconv_int8_plain(x, w, padding=pad,
                                               pad_value=200))
    assert torch.equal(got_g, g8.qconv_grouped_int8_plain(
        x, wg, None, padding=pad, pad_value=200))


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.uint8])
def test_gemm_device_y_zero_point(cuda, out_dtype):
    rng = np.random.default_rng(13)
    a = _q(rng, (100, 96), np.int8, cuda)
    b = _q(rng, (96, 40), np.int8, cuda)
    mult = torch.tensor(4e-4, device=cuda)
    bias = torch.from_numpy(rng.integers(-5000, 5000, 40).astype(
        np.int32)).to(cuda)
    zy = 100 if out_dtype == torch.uint8 else -60
    before = m8.qmatmul_int8.forms["device_zero_point"]
    got = m8.qmatmul_int8_requant(a, b, mult, bias, y_zp=_zp(zy, cuda),
                                  out_dtype=out_dtype,
                                  packed=m8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert m8.qmatmul_int8.forms["device_zero_point"] == before + 1
    assert torch.equal(got, m8.qmatmul_int8_requant_plain(
        a, b, mult, bias, y_zp=zy, out_dtype=out_dtype))


def test_r3d_engines_on_the_card_equal_the_cpu(cuda):
    from onnx_rusty_inference_engine_tpu_torch.quant import (calibrate,
                                                             quantize_graph)

    g = import_model(build_r3d18(width=8, blocks=(1, 1, 1, 1),
                                 num_classes=10, clip=(3, 4, 16, 16)))
    x = np.random.default_rng(14).standard_normal(
        (4, 3, 4, 16, 16)).astype(np.float32)
    feed = {R3D_INPUT: x}
    want = Engine(g, device="cpu").run(feed).outputs[R3D_LOGITS]
    got = Engine(g).run(feed).outputs[R3D_LOGITS]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ranges = calibrate(g, [{R3D_INPUT: x[:2]}], device="cpu")
    q = quantize_graph(g, ranges=ranges)
    before = k.qconv_int8_requant.forms["3d"]
    got8 = Engine(q).run(feed).outputs[R3D_LOGITS]
    assert k.qconv_int8_requant.forms["3d"] - before == 12
    want8 = Engine(q, device="cpu").run(feed).outputs[R3D_LOGITS]
    np.testing.assert_array_equal(got8, want8)


def test_dynamic_squeezenet_replays_with_each_feeds_zero_points(cuda):
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
    from onnx_rusty_inference_engine_tpu_torch.models import (
        build_squeezenet)

    g = reparsed(dynamic_bytes(import_model(build_squeezenet(seed=0))))
    convint = [n.outputs[0] for n in g.nodes if n.op_type == "ConvInteger"]
    zps = [n.outputs[2] for n in g.nodes
           if n.op_type == "DynamicQuantizeLinear"]
    probe = probe_graph(g, convint + zps)
    card, cpu = Engine(probe), Engine(probe, device="cpu")
    rng = np.random.default_rng(15)
    feeds = [{"data_0": rng.standard_normal((2, 3, 64, 64)).astype(
        np.float32) * s + o} for s, o in ((1.0, 0.0), (0.5, 2.0))]
    before = k.qconv_int8_requant.forms["device_zero_point"]
    outs = [card(f) for f in feeds] + [card(f) for f in feeds]
    torch.cuda.synchronize()
    assert len(card._graphs) == 1
    # the first call eager, three replays (each adds its launches)
    assert k.qconv_int8_requant.forms["device_zero_point"] - before \
        == 26 * 4
    z0 = [int(outs[0][z].item()) for z in zps]
    z1 = [int(outs[1][z].item()) for z in zps]
    assert z0 != z1  # the two feeds' zero points differ
    for i, f in enumerate(feeds):
        eager = card.forward({"data_0": torch.as_tensor(f["data_0"],
                                                        device=cuda)})
        want = cpu.run(f).outputs
        for name in convint:
            assert torch.equal(outs[i + 2][name], eager[name]), name
            np.testing.assert_array_equal(outs[i + 2][name].cpu().numpy(),
                                          want[name], err_msg=name)
