"""The 3-D int8 convs' Hopper forms on the card (marker `cuda`; each test
skips without a CUDA device): the group-1 kernel's staged-halo producer
and the grouped kernel's tile3d form.

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_conv3d_cuda.py -q

- The staged-halo producer (`conv_plan` -> "halo") bit-equal to its plain
  version at R3D-18's stride-1 3x3x3 shapes (2 clips: output widths 56,
  28, 14 and 7, C 64-512 in one box or in 128-channel chunks, tiles of 4
  and of 2 planes, resident weights and a ring), at a depth edge and
  ragged boxes, C 32 and 96 (one chunk of C), N 48-512 (a part N tile),
  another kernel and asymmetric pads; int8 and uint8 x, pad byte 0 and
  not, an output zero point, zero points in device memory with a uint8
  output (eager and replayed); counted under `.producers["halo"]`. A C of
  24 (C % 16 != 0) and a strided conv stay on the gather
  (test_torch_port_conv2d_cuda.py runs the 3-D C of 16 and 48).
- The tile3d form (`grouped_plan` -> "tile3d") bit-equal to its plain
  version over depthwise 3x3x3 shapes: output widths 56, 28, 14 and 7, a
  depth edge, C 16, 64 and 512 (channel runs), stride 1, (1, 2, 2) and 2,
  int8 and uint8 x, pad byte 0 and not, an output zero point; counted
  under `.schedules["tile3d"]`. The int32 output, a zero point in device
  memory and dilation stay on the general form.
- Both forms replayed from a CUDA graph equal their eager call.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_grouped_int8 as g8, qconv_int8 as k)

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


def _operands(rng, x_shape, w_shape, xdt, dev, bias_max=20000):
    x = _q(rng, x_shape, xdt, dev).contiguous(
        memory_format=torch.channels_last_3d)
    w = _q(rng, w_shape, np.int8, dev)
    O = w_shape[0]
    mult = torch.from_numpy((np.abs(rng.standard_normal(O)) * 2e-4 + 1e-5
                             ).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.integers(-bias_max, bias_max, O).astype(
        np.int32)).to(dev)
    return x, w, mult, bias


# (x shape, O, kernel, pads): R3D-18's stride-1 3x3x3 convs at 2 clips, a
# depth edge and ragged boxes, one-chunk C of 32 and 96, chunks of 128 (C
# 384), N 48 and 80 (a part N tile of 64 and 128), another kernel with
# asymmetric pads
HALO = [
    ((2, 64, 16, 56, 56), 64, (3, 3, 3), ((1, 1),) * 3),
    ((2, 128, 8, 28, 28), 128, (3, 3, 3), ((1, 1),) * 3),
    ((2, 256, 4, 14, 14), 256, (3, 3, 3), ((1, 1),) * 3),
    ((2, 512, 2, 7, 7), 512, (3, 3, 3), ((1, 1),) * 3),
    ((1, 64, 5, 13, 11), 48, (3, 3, 3), ((1, 1),) * 3),
    ((2, 32, 3, 9, 17), 80, (3, 3, 3), ((1, 1),) * 3),
    ((1, 96, 4, 10, 10), 128, (3, 3, 3), ((1, 1),) * 3),
    ((1, 384, 3, 6, 6), 192, (3, 3, 3), ((1, 1),) * 3),
    ((2, 64, 6, 9, 8), 64, (2, 3, 1), ((1, 0), (0, 2), (1, 1))),
]


@pytest.mark.parametrize("xs,O,kern,pads", HALO)
@pytest.mark.parametrize("xdt,zx,zy", [(np.int8, 0, 0), (np.int8, -7, 5),
                                       (np.uint8, 131, -3)])
def test_halo_conv_equals_plain(cuda, xs, O, kern, pads, xdt, zx, zy):
    rng = np.random.default_rng(sum(xs) + O + zx)
    x, w, mult, bias = _operands(rng, xs, (O, xs[1]) + kern, xdt, cuda)
    kw = dict(stride=(1, 1, 1), padding=pads, pad_value=zx, y_zp=zy)
    producer, tile = k.conv_plan(x.shape, w.shape, (1, 1, 1), pads)
    assert producer == "halo" and tile.bm in (128, 256)
    before = k.qconv_int8_requant.producers["halo"]
    got = k.qconv_int8_requant(x, w, mult, bias, **kw,
                               packed=k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers["halo"] == before + 1
    want = k.qconv_int8_requant_plain(x, w, mult, bias, **kw)
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


def test_halo_leaves_c16_and_strided_convs_on_the_gather(cuda):
    rng = np.random.default_rng(3)
    for xs, O, s in (((2, 24, 4, 9, 9), 32, (1, 1, 1)),
                     ((2, 64, 8, 14, 14), 128, (2, 2, 2))):
        x, w, mult, bias = _operands(rng, xs, (O, xs[1], 3, 3, 3), np.int8,
                                     cuda)
        pad = ((1, 1),) * 3
        assert k.conv_plan(x.shape, w.shape, s, pad)[0] == "gather"
        before = dict(k.qconv_int8_requant.producers)
        got = k.qconv_int8_requant(x, w, mult, bias, stride=s, padding=pad,
                                   packed=k.pack_qconv_weight(w))
        torch.cuda.synchronize()
        assert k.qconv_int8_requant.producers["gather"] \
            == before["gather"] + 1
        assert torch.equal(got, k.qconv_int8_requant_plain(
            x, w, mult, bias, stride=s, padding=pad))


def test_halo_device_zero_points_and_uint8_y(cuda):
    """pad value and y zero point as device tensors on the staged-halo
    producer (a uint8 x and a uint8 y): equal to the same values as ints;
    captured once, a new value written between replays takes effect."""
    rng = np.random.default_rng(24)
    x, w, mult, bias = _operands(rng, (2, 64, 5, 12, 12), (64, 64, 3, 3, 3),
                                 np.uint8, cuda)
    packed = k.pack_qconv_weight(w)
    kw = dict(padding=((1, 1),) * 3, out_dtype=torch.uint8)
    assert k.conv_plan(x.shape, w.shape, (1, 1, 1), kw["padding"])[0] \
        == "halo"
    zx = torch.tensor([131], dtype=torch.int32, device=cuda)
    zy = torch.tensor([17], dtype=torch.int32, device=cuda)

    def conv():
        return k.qconv_int8_requant(x, w, mult, bias, **kw, pad_value=zx,
                                    y_zp=zy, packed=packed)

    before = k.qconv_int8_requant.producers["halo"]
    got = conv()
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers["halo"] == before + 1
    assert torch.equal(got, k.qconv_int8_requant_plain(
        x, w, mult, bias, **kw, pad_value=131, y_zp=17))
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        conv()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv()
    for a, b in ((3, 250), (255, 0)):
        zx.fill_(a)
        zy.fill_(b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k.qconv_int8_requant_plain(
            x, w, mult, bias, **kw, pad_value=a, y_zp=b)), (a, b)


# (x shape, stride): output widths 56, 28, 14, 7, a depth edge, C 16 and
# 512 (eight channel runs), strides 1, (1, 2, 2) and 2
TILE3D = [
    ((2, 64, 16, 56, 56), (1, 1, 1)),
    ((2, 64, 16, 56, 56), (1, 2, 2)),
    ((2, 32, 8, 28, 28), (2, 2, 2)),
    ((1, 512, 4, 14, 14), (1, 1, 1)),
    ((2, 16, 5, 7, 7), (1, 1, 1)),
    ((1, 48, 7, 13, 15), (2, 1, 1)),
]


@pytest.mark.parametrize("xs,s", TILE3D)
@pytest.mark.parametrize("xdt,zx,zy", [(np.int8, 0, 0), (np.int8, 9, -4),
                                       (np.uint8, 140, 3)])
def test_tile3d_equals_plain(cuda, xs, s, xdt, zx, zy):
    rng = np.random.default_rng(sum(xs) + sum(s) + zx)
    C = xs[1]
    x, w, mult, bias = _operands(rng, xs, (C, 1, 3, 3, 3), xdt, cuda,
                                 bias_max=2000)
    pad = ((1, 1),) * 3
    kw = dict(stride=s, padding=pad, pad_value=zx, y_zp=zy)
    plan = g8.grouped_plan(x.shape, w.shape, s, pad, g8.input_align(x))
    assert plan["form"] == "tile3d"
    before = g8.qconv_grouped_int8_requant.schedules["tile3d"]
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, **kw, packed=g8.pack_qconv_grouped_weight(w))
    torch.cuda.synchronize()
    assert g8.qconv_grouped_int8_requant.schedules["tile3d"] == before + 1
    want = g8.qconv_grouped_int8_requant_plain(x, w, mult, bias, **kw)
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got.int() - want.int()).abs().max())


def test_tile3d_extreme_biases_take_the_exact_conversion(cuda):
    """Biases past the float trick's exact range (27 products each up to
    255 x 128) go through __int2float_rn, with the same results."""
    rng = np.random.default_rng(21)
    x, w, mult, _ = _operands(rng, (1, 32, 4, 9, 9), (32, 1, 3, 3, 3),
                              np.uint8, cuda)
    bias = torch.from_numpy(rng.integers(-2 ** 24, 2 ** 24, 32).astype(
        np.int32)).to(cuda)
    mult = mult * 1e-3
    kw = dict(padding=((1, 1),) * 3, pad_value=77)
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, **kw, packed=g8.pack_qconv_grouped_weight(w))
    torch.cuda.synchronize()
    assert torch.equal(got, g8.qconv_grouped_int8_requant_plain(
        x, w, mult, bias, **kw))


def test_tile3d_leaves_int32_device_zp_and_dilation_on_general(cuda):
    rng = np.random.default_rng(22)
    x, w, mult, bias = _operands(rng, (2, 32, 6, 10, 10), (32, 1, 3, 3, 3),
                                 np.int8, cuda)
    packed = g8.pack_qconv_grouped_weight(w)
    pad = ((1, 1),) * 3
    zp = torch.tensor([4], dtype=torch.int32, device=cuda)
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    outs = [
        (g8.qconv_grouped_int8(x, w, bias, padding=pad, pad_value=3,
                               packed=packed),
         g8.qconv_grouped_int8_plain(x, w, bias, padding=pad, pad_value=3)),
        (g8.qconv_grouped_int8_requant(x, w, mult, bias, padding=pad,
                                       pad_value=zp, packed=packed),
         g8.qconv_grouped_int8_requant_plain(x, w, mult, bias, padding=pad,
                                             pad_value=4)),
        (g8.qconv_grouped_int8_requant(x, w, mult, bias, padding=pad,
                                       dilation=(1, 2, 2), packed=packed),
         g8.qconv_grouped_int8_requant_plain(x, w, mult, bias, padding=pad,
                                             dilation=(1, 2, 2))),
    ]
    torch.cuda.synchronize()
    after = g8.qconv_grouped_int8_requant.schedules
    assert after["general"] == before["general"] + 3
    assert after["tile3d"] == before["tile3d"]
    for got, want in outs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["halo", "tile3d"])
def test_captured_replay_equals_eager(cuda, form):
    rng = np.random.default_rng(23)
    if form == "halo":
        x, w, mult, bias = _operands(rng, (2, 64, 4, 12, 12),
                                     (64, 64, 3, 3, 3), np.uint8, cuda)
        packed = k.pack_qconv_weight(w)

        def conv():
            return k.qconv_int8_requant(x, w, mult, bias,
                                        padding=((1, 1),) * 3,
                                        pad_value=128, packed=packed)
    else:
        x, w, mult, bias = _operands(rng, (2, 64, 6, 20, 20),
                                     (64, 1, 3, 3, 3), np.int8, cuda)
        packed = g8.pack_qconv_grouped_weight(w)

        def conv():
            return g8.qconv_grouped_int8_requant(
                x, w, mult, bias, stride=(1, 2, 2), padding=((1, 1),) * 3,
                pad_value=-2, packed=packed)
    eager = conv()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        conv()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv()
    x.copy_(torch.roll(x, 1, dims=0))  # a new input, read at the replay
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, conv())
    assert not torch.equal(out, eager)
