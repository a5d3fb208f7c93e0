"""The stride-2 stems as their space-to-depth rewrite, on the card (marker
`cuda`; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_stem_cuda.py -q

- Each stem of the port's graphs (SqueezeNet 1.0's, ResNet-50's and
  MobileNetV2's conv1 at b256, R3D-18's stem at b16 clips), at its full
  batch and at a ragged one, from its NCHW graph input: the layout kernel
  and the staged-halo producer (`conv_plan` of its rewrite), bit-equal to
  the plain versions of the original conv in the static INT8 form (int8 x
  padded with 0), QUInt8 (uint8 x and y with zero points), QInt8 (int8
  with zero points) and the int32 epilogue with the pad value in device
  memory (ORT's dynamic ConvInteger), and the window-sum launch of its
  all-ones weight; counted once each in `.forms["s2d"]` and on the halo.
- The layout kernel (`space_to_depth`) bit-equal to its plain version over
  NCHW and channels-last inputs, 2-D and 3-D, odd sizes, odd leading
  paddings, C 1-4, int8 and uint8, pad values as ints and in device
  memory (saturated to x's type).
- One captured graph of a stem's ConvInteger and its window sums, replayed
  with two device zero points: each output equals its own eager run.
- The form's refusals: a weight packed without the stem's stride (the
  original layout), a halo tile the entry point refuses, a layout the
  layout kernel refuses: each raises and counts nothing.
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


# the stems as the port's graphs hold them (x at the smoke's batches, w,
# stride, padding pairs)
STEMS = {
    "squeezenet": ((256, 3, 224, 224), (96, 3, 7, 7), (2, 2),
                   ((0, 0), (0, 0))),
    "resnet50": ((256, 3, 224, 224), (64, 3, 7, 7), (2, 2),
                 ((3, 3), (3, 3))),
    "mobilenetv2": ((256, 3, 224, 224), (32, 3, 3, 3), (2, 2),
                    ((1, 1), (1, 1))),
    "r3d18": ((16, 3, 16, 112, 112), (64, 3, 3, 7, 7), (1, 2, 2),
              ((1, 1), (3, 3), (3, 3))),
}

# (x dtype, pad value, y zero point, output): "dev" values are one-element
# int32 tensors on the card that the kernel reads in the run
FORMS = {"static": ("int8", 0, 0, "int8"),
         "quint8": ("uint8", 131, 128, "uint8"),
         "qint8": ("int8", -9, 4, "int8"),
         "int32_device_zp": ("uint8", "dev117", None, "int32")}


def _q(rng, shape, dtype, dev):
    info = np.iinfo(dtype)
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape
                                         ).astype(dtype)).to(dev)


def _zp(v, dev):
    if isinstance(v, str):
        return torch.tensor([int(v[3:])], dtype=torch.int32, device=dev)
    return v


def _stem_operands(rng, xs, ws, xdt, dev):
    x = _q(rng, xs, xdt, dev)  # NCHW (NCDHW), as a graph input
    w = _q(rng, ws, np.int8, dev)
    O = ws[0]
    mult = torch.from_numpy((np.abs(rng.standard_normal(O)) * 2e-4 + 1e-5
                             ).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.integers(-20000, 20000, O).astype(
        np.int32)).to(dev)
    return x, w, mult, bias


@pytest.mark.parametrize("batch", ["full", "ragged"])
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("model", list(STEMS))
def test_stem_equals_plain(cuda, model, form, batch):
    xs, ws, stride, padding = STEMS[model]
    if batch == "ragged":
        xs = (3,) + xs[1:]
    xdt_name, pv, yz, out = FORMS[form]
    xdt = np.uint8 if xdt_name == "uint8" else np.int8
    rng = np.random.default_rng(len(model) + len(form) + xs[0])
    x, w, mult, bias = _stem_operands(rng, xs, ws, xdt, cuda)
    epilogue = "int32" if out == "int32" else "requant"
    assert k.conv_plan(xs, ws, stride, padding, None, epilogue)[0] == "halo"
    packed = k.pack_qconv_weight(w, stride)
    kw = dict(stride=stride, padding=padding, pad_value=_zp(pv, cuda))
    before = (k.qconv_int8_requant.launches,
              dict(k.qconv_int8_requant.producers),
              dict(k.qconv_int8_requant.forms))
    if out == "int32":
        ones = torch.ones((1, *ws[1:]), dtype=torch.int8, device=cuda)
        got = k.qconv_int8(x, w, **kw, packed=packed)
        xsum = k.qconv_int8(x, ones, **kw,
                            packed=k.pack_qconv_weight(ones, stride))
        torch.cuda.synchronize()
        want = k.qconv_int8_plain(x, w, **kw)
        assert torch.equal(xsum, k.qconv_int8_plain(x, ones, **kw))
        n = 2
    else:
        odt = torch.uint8 if out == "uint8" else torch.int8
        kw.update(y_zp=_zp(yz, cuda), out_dtype=odt)
        got = k.qconv_int8_requant(x, w, mult, bias, **kw, packed=packed)
        torch.cuda.synchronize()
        want = k.qconv_int8_requant_plain(x, w, mult, bias, **kw)
        n = 1
    assert got.shape == want.shape
    assert torch.equal(got, want), int((got.long() - want.long()).abs().max())
    launches, producers, forms = before
    assert k.qconv_int8_requant.launches == launches + n
    assert k.qconv_int8_requant.producers == dict(
        producers, halo=producers["halo"] + n)
    assert k.qconv_int8_requant.forms["s2d"] == forms["s2d"] + n
    # channels-last: the next conv reads it in place
    assert k.channels_last_input(got).data_ptr() == got.data_ptr()


@pytest.mark.parametrize("x_shape,kernel,padding,layout", [
    ((256, 3, 224, 224), (7, 7), ((0, 0), (0, 0)), "nchw"),
    ((256, 3, 224, 224), (7, 7), ((3, 3), (3, 3)), "nchw"),
    ((5, 3, 23, 30), (3, 3), ((1, 1), (1, 1)), "channels_last"),
    ((2, 1, 9, 8), (5, 5), ((2, 1), (3, 0)), "nchw"),
    ((3, 4, 17, 13), (7, 3), ((0, 2), (1, 1)), "channels_last"),
    ((16, 3, 16, 112, 112), (3, 7, 7), ((1, 1), (3, 3), (3, 3)), "nchw"),
    ((2, 2, 5, 11, 9), (1, 3, 5), ((0, 0), (1, 0), (2, 2)), "channels_last"),
])
def test_layout_kernel_equals_plain(cuda, x_shape, kernel, padding, layout):
    spatial = len(kernel)
    stride = (1,) * (spatial - 2) + (2, 2)
    rng = np.random.default_rng(sum(x_shape))
    w_shape = (8, x_shape[1], *kernel)
    for xdt, pad in ((np.int8, 0), (np.int8, -5), (np.uint8, 200),
                     (np.uint8, "dev300"), (np.int8, "dev-77")):
        x = _q(rng, x_shape, xdt, cuda)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last
                             if spatial == 2 else torch.channels_last_3d)
        geo = k.s2d_conv(x.shape, w_shape, stride, padding)
        pv = _zp(pad, cuda)
        got = k.space_to_depth(x, geo, pv)
        torch.cuda.synchronize()
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
        assert torch.equal(got, k.space_to_depth_plain(x, geo, pv)), (xdt,
                                                                      pad)


def test_captured_stem_replays_two_device_zero_points(cuda):
    """SqueezeNet's conv1 as ORT's dynamic ConvInteger at b8: the int32
    sums and the window sums of its all-ones weight in one captured
    graph, the zero point a device tensor: replayed with 3 and then 200
    in it, each output equals the eager run with that value."""
    xs, ws, stride, padding = STEMS["squeezenet"]
    rng = np.random.default_rng(4)
    x, w, _, _ = _stem_operands(rng, (8,) + xs[1:], ws, np.uint8, cuda)
    ones = torch.ones((1, *ws[1:]), dtype=torch.int8, device=cuda)
    packed = k.pack_qconv_weight(w, stride)
    packed1 = k.pack_qconv_weight(ones, stride)
    zp = torch.tensor([0], dtype=torch.int32, device=cuda)
    kw = dict(stride=stride, padding=padding, pad_value=zp)

    def body():
        return (k.qconv_int8(x, w, **kw, packed=packed),
                k.qconv_int8(x, ones, **kw, packed=packed1))

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
            x, w, stride=stride, padding=padding, pad_value=value))


def test_stem_refusals_raise_and_count_nothing(cuda, monkeypatch):
    """A weight packed as the original conv (no stride given: not the
    rewrite's layout), a halo tile the entry point refuses (BN 48), and a
    layout over 5 channels: each raises, and no launch is counted; nothing
    falls back to the gather."""
    xs, ws, stride, padding = STEMS["resnet50"]
    rng = np.random.default_rng(8)
    x, w, mult, bias = _stem_operands(rng, (2,) + xs[1:], ws, np.int8, cuda)
    counters = (k.qconv_int8_requant.producers, k.qconv_int8_requant.forms)

    def state():
        return (k.qconv_int8_requant.launches,) + tuple(dict(c)
                                                        for c in counters)

    before = state()
    with pytest.raises(ValueError, match="layout"):
        k.qconv_int8_requant(x, w, mult, bias, stride=stride,
                             padding=padding, packed=k.pack_qconv_weight(w))
    assert state() == before
    tile = q8.Int8Tile(128, 48, 2, True)
    monkeypatch.setattr(k, "conv_plan", lambda *a: ("halo", tile))
    with pytest.raises(RuntimeError, match="halo producer"):
        k.qconv_int8_requant(x, w, mult, bias, stride=stride,
                             padding=padding,
                             packed=k.pack_qconv_weight(w, stride))
    with pytest.raises(RuntimeError, match="halo producer"):
        k.qconv_int8(x, w, stride=stride, padding=padding,
                     packed=k.pack_qconv_weight(w, stride))
    assert state() == before
    geo = k.s2d_conv(x.shape, ws, stride, padding)
    x5 = torch.zeros((2, 5, 16, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(RuntimeError, match="space_to_depth"):
        k.space_to_depth(x5, geo)
    assert state() == before
