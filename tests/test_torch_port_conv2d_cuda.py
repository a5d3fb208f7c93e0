"""The 2-D int8 convs on the staged-halo producer, and the 1x1 ConvInteger
on TMA, on the card (marker `cuda`; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_conv2d_cuda.py -q

- The staged-halo producer's 2-D form (`conv_plan` -> "halo": 16 or 32 rows
  x 8 columns a tile) bit-equal to the plain versions over C 16, 32, 48,
  64, 256 and 512 (one box, odd 16-channel blocks, 128-channel chunks),
  3x3 and 5x5 kernels, H and W of 13, 27 and 54, in five forms: int8 x
  padded with 0 and with a constant, an output zero point; uint8 x padded
  with a zero point in device memory, a uint8 output with one; the int32
  epilogue with the pad value a constant and in device memory. The plan is
  forced to the halo for every shape, so the kernel is tested where a
  written rule might send a shape to the gather.
- The 3-D form over C 16 and 48 (the odd-block k32 steps), both epilogues.
- The 1x1 ConvInteger (int32 epilogue, a device zero point) by TMA at
  SqueezeNet's squeeze and expand shapes (over C 16 by the gather), and
  its window-sum launch (an all-ones weight, N = 1).
- At batch 1, resident weights over several N tiles with fewer tiles than
  SMs (the grid cut to the tiles), 2-D on the int32 epilogue and 3-D.
- One captured graph replayed with two device zero points: each output
  equals its own eager run.
- A halo tile the entry point refuses raises and counts nothing.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_int8 as k, qmatmul_int8 as q8)

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
    memory = (torch.channels_last if len(x_shape) == 4
              else torch.channels_last_3d)
    x = _q(rng, x_shape, xdt, dev).contiguous(memory_format=memory)
    w = _q(rng, w_shape, np.int8, dev)
    O = w_shape[0]
    mult = torch.from_numpy((np.abs(rng.standard_normal(O)) * 2e-4 + 1e-5
                             ).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.integers(-20000, 20000, O).astype(
        np.int32)).to(dev)
    return x, w, mult, bias


@pytest.fixture
def halo_only(monkeypatch):
    """conv_plan with every conv the halo takes forced onto it (a written
    fallback rule may send a shape to the gather)."""
    real = k.conv_plan

    def plan(xs, ws, stride, padding, dilation=None, epilogue="requant"):
        producer, tile = real(xs, ws, stride, padding, dilation, epilogue)
        if producer == "halo":
            return producer, tile
        out = k.conv_out_size(xs[2:], ws[2:], stride, padding, dilation)
        return "halo", k.halo_plan(k.conv_channels(xs[1]), ws[0], ws[2:],
                                   out, xs[0])["tile"]

    monkeypatch.setattr(k, "conv_plan", plan)


# (x dtype, pad value, y zero point, output): "dev" values are one-element
# int32 tensors on the card that the kernel reads in the run
FORMS = [("int8", 0, 0, "int8"), ("int8", -7, 5, "int8"),
         ("uint8", "dev131", "dev200", "uint8"),
         ("uint8", "dev77", None, "int32"), ("int8", 9, None, "int32")]

SHAPES = [(C, ks, hw) for C in (16, 32, 48, 64, 256, 512) for ks in (3, 5)
          for hw in ((13, 13), (27, 54), (54, 27))]


def _zp(v, dev):
    if isinstance(v, str):
        return torch.tensor([int(v[3:])], dtype=torch.int32, device=dev)
    return v


def _run(x, w, mult, bias, form, padding, stride, packed):
    """(the kernel's result, the plain version's) for one form."""
    _, pv, yz, out = form
    dev = x.device
    kw = dict(stride=stride, padding=padding, pad_value=_zp(pv, dev))
    if out == "int32":
        return (k.qconv_int8(x, w, **kw, packed=packed),
                k.qconv_int8_plain(x, w, **kw))
    odt = torch.uint8 if out == "uint8" else torch.int8
    kw.update(y_zp=_zp(yz, dev), out_dtype=odt)
    return (k.qconv_int8_requant(x, w, mult, bias, **kw, packed=packed),
            k.qconv_int8_requant_plain(x, w, mult, bias, **kw))


@pytest.mark.parametrize("C,ks,hw", SHAPES)
@pytest.mark.parametrize("form", FORMS, ids=["-".join(map(str, f))
                                            for f in FORMS])
def test_halo_2d_equals_plain(cuda, halo_only, C, ks, hw, form):
    rng = np.random.default_rng(C * 7 + ks + hw[0])
    O = (64 if ks == 3 else 48) if C <= 64 else (128 if ks == 3 else 96)
    xdt = np.uint8 if form[0] == "uint8" else np.int8
    x, w, mult, bias = _operands(rng, (2, C, *hw), (O, C, ks, ks), xdt, cuda)
    padding = ((ks // 2, ks // 2),) * 2
    before = dict(k.qconv_int8_requant.producers)
    got, want = _run(x, w, mult, bias, form, padding, (1, 1),
                     k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers == dict(
        before, halo=before["halo"] + 1)
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got.long() - want.long()).abs().max())
    # channels-last: the next conv reads it in place
    assert k.channels_last_input(got).data_ptr() == got.data_ptr()


@pytest.mark.parametrize("C", [16, 48])
@pytest.mark.parametrize("form", [FORMS[1], FORMS[2], FORMS[3]],
                         ids=["int8", "uint8_dev", "int32_dev"])
def test_halo_3d_odd_blocks_equal_plain(cuda, C, form):
    """The 3-D form over C % 32 == 16: a k32 step spans two taps."""
    rng = np.random.default_rng(C)
    xdt = np.uint8 if form[0] == "uint8" else np.int8
    x, w, mult, bias = _operands(rng, (2, C, 5, 13, 11), (40, C, 3, 3, 3),
                                 xdt, cuda)
    padding = ((1, 1),) * 3
    assert k.conv_plan(x.shape, w.shape, (1, 1, 1), padding,
                       epilogue="int32" if form[3] == "int32"
                       else "requant")[0] == "halo"
    got, want = _run(x, w, mult, bias, form, padding, (1, 1, 1),
                     k.pack_qconv_weight(w))
    assert torch.equal(got, want)


@pytest.mark.parametrize("C,O,hw", [(96, 16, 54), (16, 64, 54),
                                    (256, 48, 26), (64, 256, 12),
                                    (512, 1000, 12)])
def test_1x1_convinteger_on_tma(cuda, C, O, hw):
    """ORT's dynamic SqueezeNet's 1x1 ConvIntegers: uint8 x, its zero point
    in device memory (no padding tap reads it), the int32 epilogue, by
    TMA (over C 16 by the gather, `conv_plan`'s rule); and the window-sum
    launch of a weight with a zero point (an all-ones weight, N = 1)."""
    rng = np.random.default_rng(C + O)
    x, w, _, _ = _operands(rng, (3, C, hw, hw), (O, C, 1, 1), np.uint8,
                           cuda)
    zp = torch.tensor([113], dtype=torch.int32, device=cuda)
    ones = torch.ones((1, C, 1, 1), dtype=torch.int8, device=cuda)
    producer = "gather" if C == 16 else "tma"
    for ws in (w.shape, ones.shape):
        assert k.conv_plan(x.shape, ws, (1, 1), ((0, 0), (0, 0)), None,
                           "int32")[0] == producer
    before = dict(k.qconv_int8_requant.producers)
    got = k.qconv_int8(x, w, pad_value=zp, packed=k.pack_qconv_weight(w))
    xsum = k.qconv_int8(x, ones, pad_value=zp,
                        packed=k.pack_qconv_weight(ones))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers == dict(
        before, **{producer: before[producer] + 2})
    assert torch.equal(got, k.qconv_int8_plain(x, w, pad_value=zp))
    assert torch.equal(xsum, k.qconv_int8_plain(x, ones, pad_value=zp))


def test_squeezenet_expand_routes_to_the_halo(cuda):
    """fire2's expand3x3 at b2 (C 16, 54 x 54) without a forced plan."""
    rng = np.random.default_rng(2)
    x, w, mult, bias = _operands(rng, (2, 16, 54, 54), (64, 16, 3, 3),
                                 np.int8, cuda)
    pad = ((1, 1), (1, 1))
    assert k.conv_plan(x.shape, w.shape, (1, 1), pad)[0] == "halo"
    before = k.qconv_int8_requant.producers["halo"]
    got = k.qconv_int8_requant(x, w, mult, bias, padding=pad, pad_value=3,
                               packed=k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers["halo"] == before + 1
    assert torch.equal(got, k.qconv_int8_requant_plain(
        x, w, mult, bias, padding=pad, pad_value=3))


@pytest.mark.parametrize("xs,ws,epilogue", [
    ((1, 64, 12, 12), (256, 64, 3, 3), "int32"),     # fire9's expand, b1
    ((1, 64, 26, 26), (256, 64, 3, 3), "int32"),     # fire8's
    ((1, 64, 4, 14, 14), (128, 64, 3, 3, 3), "requant"),  # 3-D, 2 N tiles
])
def test_halo_few_tiles_over_several_n_tiles(cuda, xs, ws, epilogue):
    """At batch 1 a resident plan over two or more N tiles has fewer tiles
    than the card has SMs: the grid stops at the tiles (each block keeping
    one N tile), and every output is still written once, bit-equal."""
    rng = np.random.default_rng(ws[0] + len(ws))
    x, w, mult, bias = _operands(rng, xs, ws, np.uint8, cuda)
    padding = ((1, 1),) * (len(ws) - 2)
    out = k.conv_out_size(xs[2:], ws[2:], (1,) * len(padding), padding)
    plan = k.halo_plan(xs[1], ws[0], ws[2:], out, xs[0])
    assert plan["tile"].b_resident and ws[0] > plan["tile"].bn
    assert k.conv_plan(xs, ws, (1,) * len(padding), padding, None,
                       epilogue)[0] == "halo"
    form = (FORMS[3] if epilogue == "int32"
            else ("uint8", "dev131", "dev200", "uint8"))
    before = k.qconv_int8_requant.producers["halo"]
    got, want = _run(x, w, mult, bias, form, padding, (1,) * len(padding),
                     k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers["halo"] == before + 1
    assert torch.equal(got, want)


def test_captured_graph_replays_two_device_zero_points(cuda, halo_only):
    """One CUDA graph of a 3x3 ConvInteger (int32, halo) and a 1x1 (TMA),
    their zero point a device tensor: replayed with 3 and then 200 in it,
    each output equals the eager run with that value."""
    rng = np.random.default_rng(9)
    x, w, _, _ = _operands(rng, (2, 48, 27, 27), (192, 48, 3, 3), np.uint8,
                           cuda)
    w1 = _q(rng, (64, 48, 1, 1), np.int8, cuda)
    zp = torch.tensor([0], dtype=torch.int32, device=cuda)
    pad = ((1, 1), (1, 1))
    packed, packed1 = k.pack_qconv_weight(w), k.pack_qconv_weight(w1)

    def body():
        return (k.qconv_int8(x, w, padding=pad, pad_value=zp, packed=packed),
                k.qconv_int8(x, w1, pad_value=zp, packed=packed1))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    for value in (3, 200):
        zp.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        eager = body()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
        assert torch.equal(outs[0], k.qconv_int8_plain(
            x, w, padding=pad, pad_value=value))


def test_refused_halo_tiles_raise_and_count_nothing(cuda, monkeypatch):
    """A halo tile the entry point refuses (BM 192 and 64, BN 48, a ring of
    9 slots): the wrappers raise, naming the producer, and count no launch;
    nothing falls back to the gather."""
    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 16, 3, 3), dtype=torch.int8, device=cuda)
    mult = torch.ones(32, device=cuda)
    packed = k.pack_qconv_weight(w)
    for tile in (q8.Int8Tile(192, 64, 2), q8.Int8Tile(128, 48, 2),
                 q8.Int8Tile(128, 64, 9), q8.Int8Tile(64, 64, 2)):
        monkeypatch.setattr(k, "conv_plan", lambda *a, t=tile: ("halo", t))
        before = (k.qconv_int8_requant.launches,
                  dict(k.qconv_int8_requant.producers))
        with pytest.raises(RuntimeError, match="halo producer"):
            k.qconv_int8_requant(x, w, mult, padding=((1, 1), (1, 1)),
                                 packed=packed)
        with pytest.raises(RuntimeError, match="halo producer"):
            k.qconv_int8(x, w, padding=((1, 1), (1, 1)), packed=packed)
        assert (k.qconv_int8_requant.launches,
                k.qconv_int8_requant.producers) == before
