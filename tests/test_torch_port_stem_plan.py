"""The stride-2 stems as their space-to-depth rewrite, on the CPU: no
kernel.

A group-1 conv over C <= 4 channels (read as 4) at stride 2 in H and W (1
in depth), dilation 1 and a kernel wider than 1 (`qconv_int8.stem_s2d`)
runs on the card as a stride-1 conv over 16 channels (`s2d_conv`): each
2 x 2 block of input pixels stacked into one pixel, the weight's taps
regrouped likewise (`s2d_weight`), an odd leading padding's last row and
column written by the layout as one half of the first pixel row and
column. These tests hold:

- the rewrite exact: the plain conv of the rewritten x and weight at
  stride 1 equals `qconv_int8_plain` / `qconv_int8_requant_plain` of the
  originals bit for bit, at the four stems the port's graphs hold
  (SqueezeNet 1.0's, ResNet-50's and MobileNetV2's conv1, R3D-18's stem),
  over a sweep of kernels, paddings, odd and even sizes and 3-D, int8 and
  uint8 x, pad values 0, constant and in a one-element tensor, and for a
  weight with a zero point through the window sums;
- the rewritten operands through the port's plain requant equal the JAX
  package's QLinearConv emitter (within 1 LSB, as tests/
  test_pallas_kernels.py holds int8 outputs);
- `conv_plan` takes exactly the stems to the rewrite (and its stems to the
  staged-halo producer), the layout's plain version equals an index
  gather in numpy, and the packed weight is the rewritten one's.
"""

import numpy as np
import pytest
import torch

import onnx_rusty_inference_engine_tpu_torch as P
from onnx_rusty_inference_engine_tpu_torch import weights as W
from onnx_rusty_inference_engine_tpu_torch.graph import Node
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_int8 as k)
from util import run_op

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

# (x dtype, pad value) of the forms the stems run in: the static INT8
# (int8, 0), QUInt8 (uint8, its zero point), QInt8 (int8, its zero point),
# ORT's dynamic ConvInteger (uint8, a zero point in device memory)
FORMS = {"static": (torch.int8, 0), "quint8": (torch.uint8, 131),
         "qint8": (torch.int8, -9),
         "dynamic": (torch.uint8, torch.tensor([117], dtype=torch.int32))}


def _operands(rng, x_shape, w_shape, dtype):
    lo, hi = (0, 256) if dtype == torch.uint8 else (-128, 128)
    x = torch.from_numpy(rng.integers(lo, hi, x_shape)).to(dtype)
    w = torch.from_numpy(rng.integers(-127, 128, w_shape)).to(torch.int8)
    return x, w


def _nchw(x_cl: torch.Tensor) -> torch.Tensor:
    """The layout's [B, (D,) Hs, Ws, 16] as the plain conv's [B, 16, (D,)
    Hs, Ws] view."""
    return x_cl.permute(0, x_cl.dim() - 1, *range(1, x_cl.dim() - 1))


def _rewritten(x, w, stride, padding, pad_value):
    geo = k.s2d_conv(x.shape, w.shape, stride, padding)
    assert geo is not None
    xs = k.space_to_depth_plain(x, geo, pad_value)
    assert tuple(_nchw(xs).shape) == geo["x"]
    ws = k.s2d_weight(w)
    assert tuple(ws.shape) == geo["w"]
    return _nchw(xs), ws, geo


def _assert_exact(x, w, stride, padding, pad_value, rng):
    """The int32 sums and the requant of the rewrite equal the originals'."""
    xs, ws, geo = _rewritten(x, w, stride, padding, pad_value)
    want = k.qconv_int8_plain(x, w, stride=stride, padding=padding,
                              pad_value=pad_value)
    got = k.qconv_int8_plain(xs, ws, stride=geo["stride"],
                             padding=geo["padding"], pad_value=pad_value)
    assert got.shape == want.shape and torch.equal(got, want)
    O = w.shape[0]
    mult = torch.from_numpy((rng.random(O) * 3e-4 + 1e-5).astype(np.float32))
    bias = torch.from_numpy(rng.integers(-3000, 3000, (O,)).astype(np.int32))
    for out_dtype, y_zp in ((torch.int8, -5), (torch.uint8, 130)):
        want = k.qconv_int8_requant_plain(
            x, w, mult, bias, stride=stride, padding=padding,
            pad_value=pad_value, y_zp=y_zp, out_dtype=out_dtype)
        got = k.qconv_int8_requant_plain(
            xs, ws, mult, bias, stride=geo["stride"],
            padding=geo["padding"], pad_value=pad_value, y_zp=y_zp,
            out_dtype=out_dtype)
        assert torch.equal(got, want)


def _small(x_shape, batch=1, depth=None):
    """A stem's x at `batch` (a 3-D one `depth` planes deep)."""
    mid = () if len(x_shape) == 4 else (depth or x_shape[2],)
    return (batch, x_shape[1], *mid, *x_shape[-2:])


# --------------------------------------------------------------------------
# the stems: read off the graphs, planned, exact
# --------------------------------------------------------------------------
def _first_conv(model):
    if model == "r3d18":
        from torch_port_video import build_r3d18
        g = P.import_model(build_r3d18())
    else:
        g = P.import_model({"squeezenet": P.build_squeezenet,
                            "resnet50": P.build_resnet50,
                            "mobilenetv2": P.build_mobilenetv2}[model]())
    convs = [n for n in g.nodes if n.op_type == "Conv"]
    return g, convs


@pytest.mark.parametrize("model", list(STEMS))
def test_the_graphs_hold_one_stem_each(model):
    """Each model's first conv is its stem, at the geometry STEMS names;
    no other conv of the graph is a stem."""
    g, convs = _first_conv(model)
    xs, ws, stride, padding = STEMS[model]
    n = convs[0]
    w = g.constants[n.inputs[1]]
    spatial = len(ws) - 2
    pads = n.attr("pads")
    assert tuple(w.shape) == ws and tuple(n.attr("strides")) == stride
    assert tuple(zip(pads[:spatial], pads[spatial:])) == padding
    assert tuple(g.inputs[0].shape[1:]) == xs[1:]
    stems = [c for c in convs if k.stem_s2d(
        g.constants[c.inputs[1]].shape[1],
        tuple(g.constants[c.inputs[1]].shape[2:]),
        c.attr("strides", [1] * spatial), c.attr("dilations", None))
        and int(c.attr("group", 1)) == 1]
    assert stems == [n]


# the rewritten stem's tile: BN 96 for SqueezeNet's N 96, BN 64 else; two
# m64 patches of 8 rows a tile in 2-D (109 and 112 rows: four would waste
# more), four planes in R3D-18's 3-D
STEM_TILES = {"squeezenet": (128, 96), "resnet50": (128, 64),
              "mobilenetv2": (128, 64), "r3d18": (256, 64)}


@pytest.mark.parametrize("model", list(STEMS))
def test_stem_is_planned_as_its_rewrite_on_the_halo(model):
    xs, ws, stride, padding = STEMS[model]
    geo = k.s2d_conv(xs, ws, stride, padding)
    C, kernel = ws[1], ws[2:]
    assert geo["x"][1] == geo["w"][1] == k.S2D_CHANNELS == 16
    assert geo["w"][-2:] == tuple(-(-n // 2) for n in kernel[-2:])
    assert geo["stride"] == (1,) * len(kernel)
    out = k.conv_out_size(xs[2:], kernel, stride, padding)
    assert k.conv_out_size(geo["x"][2:], geo["w"][2:], geo["stride"],
                           geo["padding"]) == out
    for epilogue in ("requant", "int32"):
        producer, tile = k.conv_plan(xs, ws, stride, padding, None, epilogue)
        assert producer == "halo"
        assert (tile.bm, tile.bn) == STEM_TILES[model]
        assert tile.b_resident and tile.stages >= 2
        plan = k.halo_plan(16, ws[0], geo["w"][2:], out, xs[0])
        assert plan["tile"] == tile and plan["smem"] <= k.SMEM_LIMIT
    Kp = int(np.prod(geo["w"][1:]))
    w = torch.zeros(ws, dtype=torch.int8)
    assert k.pack_qconv_weight(w, stride).shape == (ws[0], Kp)
    assert Kp % k.K_ALIGN == 0 and C <= 4


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("model", list(STEMS))
def test_rewrite_is_exact_at_the_stems(model, form):
    """Batch 1 (R3D-18: 4 of its 16 planes, at 56 x 56 of 112 x 112) in
    every form a stem runs in: the int32 sums and both requant outputs of
    the rewrite equal the original conv's bit for bit."""
    xs, ws, stride, padding = STEMS[model]
    dtype, pad_value = FORMS[form]
    shape = _small(xs, 1, 4)
    if model == "r3d18":
        shape = shape[:3] + (56, 56)
    rng = np.random.default_rng(len(model) * 7 + len(form))
    x, w = _operands(rng, shape, ws, dtype)
    _assert_exact(x, w, stride, padding, pad_value, rng)


# --------------------------------------------------------------------------
# a sweep of geometries
# --------------------------------------------------------------------------
SWEEP = [(kk, lo, size) for kk in (3, 5, 7) for lo in range(4)
         for size in (11, 12)]


@pytest.mark.parametrize("kk,lo,size", SWEEP)
def test_rewrite_is_exact_over_kernels_paddings_and_sizes(kk, lo, size):
    """k 3 / 5 / 7 in rows (3 / 5 / 7 in columns), a leading padding 0-3
    and a trailing one that differs (rows and columns apart), H odd or
    even and W of the other parity,
    C 1-4, int8 and uint8 x, pad value 0, a constant or a tensor."""
    i = SWEEP.index((kk, lo, size))
    rng = np.random.default_rng(100 + i)
    C = 1 + i % 4
    dtype = torch.uint8 if i % 2 else torch.int8
    pad_value = [0, (200 if i % 2 else -77),
                 torch.tensor([90 if i % 2 else -40], dtype=torch.int32)
                 ][i % 3]
    padding = ((lo, (lo + 1) % 4), ((lo + 2) % 4, lo))
    x, w = _operands(rng, (2, C, size, size + 1), (5, C, kk, (3, 5, 7)[i % 3]),
                     dtype)
    _assert_exact(x, w, (2, 2), padding, pad_value, rng)


@pytest.mark.parametrize("x_shape,kernel,padding", [
    ((2, 3, 5, 13, 12), (3, 7, 7), ((1, 1), (3, 3), (3, 3))),
    ((1, 3, 4, 9, 11), (1, 3, 3), ((0, 0), (1, 0), (0, 1))),
    ((2, 2, 3, 10, 7), (2, 5, 3), ((1, 0), (2, 2), (1, 1))),
    ((1, 4, 6, 8, 8), (3, 3, 5), ((0, 2), (0, 0), (2, 3))),
])
def test_rewrite_is_exact_in_3d(x_shape, kernel, padding):
    """Depth at stride 1 (kept as it is), rows and columns at stride 2."""
    rng = np.random.default_rng(sum(x_shape))
    for dtype, pad_value in FORMS.values():
        x, w = _operands(rng, x_shape, (6, x_shape[1], *kernel), dtype)
        _assert_exact(x, w, (1, 2, 2), padding, pad_value, rng)


@pytest.mark.parametrize("model", list(STEMS))
def test_window_sums_of_a_weight_with_a_zero_point(model):
    """The QLinearConv whose weight has a zero point: sum (x - zx)(w - zw)
    over each window, padding holding zx, from the rewrite's sums of x
    and w and of x and the all-ones weight (packed the same way: zeros in
    the added taps and channels), less zx sum w, plus taps zx zw with the
    original taps (`_Conv.sums`)."""
    xs, ws, stride, padding = STEMS[model]
    shape = _small(xs, 1, 3)
    shape = shape[:-2] + (40, 40)
    rng = np.random.default_rng(3)
    x, w = _operands(rng, shape, ws, torch.uint8)
    zx, zw = 121, -3
    ones = torch.ones((1, *ws[1:]), dtype=torch.int8)
    xr, wr, geo = _rewritten(x, w, stride, padding, zx)
    g = dict(stride=geo["stride"], padding=geo["padding"], pad_value=zx)
    acc = k.qconv_int8_plain(xr, wr, **g)
    xsum = k.qconv_int8_plain(xr, k.s2d_weight(ones), **g)
    taps = int(np.prod(ws[1:]))
    got = (acc - zx * w.to(torch.int32).sum(dim=tuple(range(1, w.dim())))
           .reshape((1, -1) + (1,) * (w.dim() - 2)) - zw * xsum
           + taps * zx * zw)
    # the same in float64 from the definition
    xd = x.to(torch.float64) - zx
    flat = [p for lo_hi in reversed(padding) for p in lo_hi]
    conv = torch.nn.functional.conv3d if x.dim() == 5 else \
        torch.nn.functional.conv2d
    want = conv(torch.nn.functional.pad(xd, flat), w.to(torch.float64) - zw,
                stride=stride).to(torch.int32)
    assert torch.equal(got, want)
    # and the ones weight's packing is the rewritten ones weight's
    assert torch.equal(k.pack_qconv_weight(ones, stride),
                       k.pack_qconv_weight(k.s2d_weight(ones)))


# --------------------------------------------------------------------------
# against the JAX package's QLinearConv emitter
# --------------------------------------------------------------------------
@pytest.mark.parametrize("model", list(STEMS))
def test_rewritten_requant_matches_the_jax_emitter(model):
    """B 2 at 32 x 32 (R3D-18: 4 planes): the JAX emitter's QLinearConv of
    the stem, and the port's plain requant at stride 1 of the rewritten x
    (padded with x's zero point) and weight, x's zero point folded into
    the bias as the emitter folds it (-zx sum w): within 1 LSB, > 99%
    equal."""
    xs, ws, stride, padding = STEMS[model]
    shape = _small(xs, 2, 4)[:-2] + (32, 32)
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, shape).astype(np.int8)
    w = rng.integers(-127, 128, ws).astype(np.int8)
    O, zx, zy = ws[0], np.int8(-6), np.int8(3)
    w_s = (np.abs(rng.standard_normal(O)) * 0.01 + 2e-3).astype(np.float32)
    b = rng.integers(-4000, 4000, (O,)).astype(np.int32)
    inits = {"x_s": np.float32(0.05), "x_zp": zx, "w": w, "w_s": w_s,
             "w_zp": np.int8(0), "y_s": np.float32(0.3), "y_zp": zy, "b": b}
    spatial = len(ws) - 2
    pads = [lo for lo, _ in padding] + [hi for _, hi in padding]
    (want,) = run_op("QLinearConv", {"x": x}, inits,
                     kernel_shape=list(ws[2:]), strides=list(stride),
                     pads=pads)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    xr, wr, geo = _rewritten(xt, wt, stride, padding, int(zx))
    mult = (torch.tensor(0.05, dtype=torch.float32) * torch.from_numpy(w_s)
            / torch.tensor(0.3, dtype=torch.float32))
    bias = (torch.from_numpy(b) - int(zx) * wt.to(torch.int32).sum(
        dim=tuple(range(1, spatial + 2))))
    got = k.qconv_int8_requant_plain(
        xr, wr, mult, bias, stride=geo["stride"], padding=geo["padding"],
        pad_value=int(zx), y_zp=int(zy)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (got == want).mean() > 0.99


# --------------------------------------------------------------------------
# which convs, the layout, the packing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("C,kernel,stride,dilation,want", [
    (3, (7, 7), (2, 2), None, True),
    (1, (3, 3), (2, 2), None, True),
    (4, (5, 3), (2, 2), (1, 1), True),
    (2, (2, 2), (2, 2), None, True),
    (3, (3, 7, 7), (1, 2, 2), None, True),
    (3, (1, 3, 3), (1, 2, 2), None, True),
    (5, (7, 7), (2, 2), None, False),        # read as 8 channels
    (16, (3, 3), (2, 2), None, False),
    (3, (7, 7), (1, 1), None, False),        # stride 1
    (3, (7, 7), (2, 1), None, False),
    (3, (7, 7), (3, 3), None, False),
    (3, (7, 7), (2, 2), (2, 2), False),      # dilated
    (3, (1, 1), (2, 2), None, False),        # a 1x1
    (3, (1, 7), (2, 2), None, False),
    (3, (3, 7, 7), (2, 2, 2), None, False),  # depth stride 2
    (3, (3, 3, 3), (1, 2, 2), (2, 1, 1), False),
    (3, (7,), (2,), None, False),            # 1-D
])
def test_conv_plan_takes_exactly_the_stems(C, kernel, stride, dilation,
                                           want):
    x_shape = (2, C) + (4,) * (len(kernel) == 3) + (15,) * min(2, len(kernel))
    padding = tuple((1, 1) for _ in kernel)
    w_shape = (8, C) + kernel
    assert k.stem_s2d(C, kernel, stride, dilation) == want
    geo = k.s2d_conv(x_shape, w_shape, stride, padding, dilation)
    assert (geo is not None) == want
    if len(kernel) == 1:
        return
    w = torch.ones(w_shape, dtype=torch.int8)
    packed = k.pack_qconv_weight(w, stride, dilation)
    if want:
        assert torch.equal(packed, k.pack_qconv_weight(k.s2d_weight(w)))
        assert k.conv_plan(x_shape, w_shape, stride, padding, dilation) \
            == k.conv_plan(geo["x"], geo["w"], geo["stride"],
                           geo["padding"], geo["dilation"])
    else:
        assert torch.equal(packed, k.pack_qconv_weight(w))


def _gather_layout(x: np.ndarray, geo: dict, pad: int) -> np.ndarray:
    """The layout by its definition, one byte at a time."""
    B, C = x.shape[:2]
    mid, (H, W) = x.shape[2:-2], x.shape[-2:]
    (mh, mw), (Hs, Ws) = geo["lead"], geo["x"][-2:]
    x5 = x.reshape(B, C, int(np.prod(mid)), H, W)
    out = np.full((B, x5.shape[2], Hs, Ws, 16), pad, dtype=x.dtype)
    for i in range(Hs):
        for j in range(Ws):
            for sh in (0, 1):
                for sw in (0, 1):
                    h, w = 2 * i + sh - mh, 2 * j + sw - mw
                    if 0 <= h < H and 0 <= w < W:
                        s = (2 * sh + sw) * 4
                        out[:, :, i, j, s:s + C] = x5[:, :, :, h, w].transpose(
                            0, 2, 1)
    return out.reshape(B, *mid, Hs, Ws, 16)


@pytest.mark.parametrize("x_shape,kernel,padding,layout", [
    ((2, 3, 11, 12), (7, 7), ((3, 2), (0, 1)), "nchw"),
    ((1, 3, 12, 9), (3, 3), ((1, 1), (1, 1)), "channels_last"),
    ((2, 1, 7, 7), (5, 5), ((2, 2), (3, 0)), "nchw"),
    ((1, 3, 3, 9, 10), (3, 7, 7), ((1, 1), (3, 3), (3, 3)), "nchw"),
    ((2, 4, 2, 6, 5), (1, 3, 3), ((0, 0), (1, 0), (0, 1)), "channels_last"),
])
def test_layout_plain_equals_the_index_gather(x_shape, kernel, padding,
                                              layout):
    """`space_to_depth_plain` (the layout kernel's plain version, which
    the CPU's `space_to_depth` and `conv_input` return for a stem) equals
    the layout by its definition, for NCHW and channels-last x, int8 and
    uint8, pad values as ints and as a one-element tensor (saturated to
    x's type); a conv that is not a stem gets `channels_last_input`."""
    spatial = len(kernel)
    stride = (1,) * (spatial - 2) + (2, 2)
    rng = np.random.default_rng(len(x_shape) + x_shape[2])
    for dtype, pad, want_pad in ((torch.int8, -3, -3), (torch.uint8, 250, 250),
                                 (torch.uint8, torch.tensor([300]), 255),
                                 (torch.int8, torch.tensor([-7]), -7)):
        x, _ = _operands(rng, x_shape, (1, 1), dtype)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last
                             if spatial == 2 else torch.channels_last_3d)
        w_shape = (8, x_shape[1], *kernel)
        geo = k.s2d_conv(x.shape, w_shape, stride, padding)
        got = k.space_to_depth_plain(x, geo, pad)
        assert got.is_contiguous() and got.dtype == dtype
        want = _gather_layout(x.numpy(), geo, want_pad)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(k.space_to_depth(x, geo, pad), got)
        assert torch.equal(k.conv_input(x, w_shape, stride, padding,
                                        pad_value=pad), got)
    x8 = torch.zeros((1, 8) + tuple(x_shape[2:]), dtype=torch.int8)
    assert torch.equal(
        k.conv_input(x8, (8, 8, *kernel), stride, padding),
        k.channels_last_input(x8))


def test_packed_stem_weight_rows():
    """The packed rows of a stem: taps (kd, q, r), each 16 channels (sh,
    sw, c) = w[o, c, kd, 2q + sh, 2r + sw], zero past the kernel and C."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.integers(-127, 128, (4, 3, 2, 5, 3))).to(
        torch.int8)
    packed = k.pack_qconv_weight(w, (1, 2, 2)).numpy()
    KHs, KWs = 3, 2
    assert packed.shape == (4, 2 * KHs * KWs * 16)
    rows = packed.reshape(4, 2, KHs, KWs, 2, 2, 4)
    wn = w.numpy()
    for q in range(KHs):
        for r in range(KWs):
            for sh in (0, 1):
                for sw in (0, 1):
                    h, ww = 2 * q + sh, 2 * r + sw
                    got = rows[:, :, q, r, sh, sw]
                    if h < 5 and ww < 3:
                        np.testing.assert_array_equal(
                            got[..., :3], wn[:, :, :, h, ww].transpose(0, 2, 1))
                        assert not got[..., 3].any()
                    else:
                        assert not got.any()


def test_weights_pack_conv_weights_at_their_nodes_stride():
    """weights._conv_pack: a stem node's weight in the rewritten layout, a
    stride-1 conv's and a 1-D stride-2 conv's (of height 1) as they are,
    a grouped conv's in the grouped layout."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.integers(-127, 128, (8, 3, 7, 7))).to(torch.int8)
    stem = Node("Conv", ["x", "w"], ["y"], name="stem",
                attrs={"strides": [2, 2], "kernel_shape": [7, 7]})
    plain = Node("Conv", ["x", "w"], ["y"], name="s1",
                 attrs={"kernel_shape": [7, 7]})
    flat = Node("Conv", ["x", "w"], ["y"], name="c1d",
                attrs={"strides": [2], "kernel_shape": [7]})
    assert torch.equal(W._conv_pack(stem)(w),
                       k.pack_qconv_weight(k.s2d_weight(w)))
    assert torch.equal(W._conv_pack(plain)(w), k.pack_qconv_weight(w))
    w1 = w[:, :, :1, :]
    assert torch.equal(W._conv_pack(flat)(w1), k.pack_qconv_weight(w1))
    grouped = Node("Conv", ["x", "w"], ["y"], name="g",
                   attrs={"strides": [2, 2], "group": 3})
    assert W._conv_pack(grouped) is W.pack_qconv_grouped_weight
