"""The plans of the 2-D int8 convs on the staged-halo producer, on the CPU:
no kernel and no model forward.

- `conv_plan` sends each group-1 conv of the port's own graphs to the
  producer the design names, the shapes carried through the float graph's
  nodes: SqueezeNet 1.0 b256 (static INT8 and ORT's dynamic form on the
  int32 epilogue), ResNet-50 b256 and UNet b32 256 x 256; a stride-1 kxk
  over C % 16 == 0 to the staged-halo producer where the fallback rule
  (`halo_2d_wins`) keeps it there (weights resident and N <= 128, or on
  the int32 epilogue N % 128 == 0), to the gather where it does not
  (SqueezeNet's N 192, and N 256 on the requant epilogue; ResNet-50's 14
  and 7, a ring of weights); a stride-2 stem over 3 channels, as its
  space-to-depth rewrite (a stride-1 conv over 16 channels:
  tests/test_torch_port_stem_plan.py), to the staged-halo producer. The
  one BM of the TMA producer's int32 instances is the same in the plan
  and in the CUDA source.
- Each 2-D halo plan's output boxes, walked as the kernel walks its tiles,
  cover the output once; its input box holds every tap's reads at H and W
  of 13, 27 and 54; its K walk takes each 16-byte K slice of the packed
  weight once; its shared memory fits a block.
- The kernel's K walk over the box (one k32 step = two 16-channel core
  matrices, the second at the step's leading offset; where C % 32 == 16 a
  step spans two taps and reads the box's copy of block 0) is emulated
  here byte by byte and equals `qconv_int8_plain`, as
  test_torch_port_qconv.py emulates the gather.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import onnx_rusty_inference_engine_tpu_torch as P
from onnx_rusty_inference_engine_tpu_torch.models.unet import (UNetConfig,
                                                               build_unet)
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_int8 as k, qmatmul_int8 as q8)

_SAME = ("Relu", "BatchNormalization", "Dropout", "Identity", "Clip", "Add")


def _graph_convs(g, batch):
    """The graph's convs as (name, x shape, w shape, stride, padding), the
    shapes carried from its input at `batch` through the nodes that set
    them (Conv, pools, ConvTranspose, Concat; Relu and Add keep them)."""
    inp = g.inputs[0]
    shapes = {inp.name: (batch, *inp.shape[1:])}
    convs = []
    for n in g.nodes:
        if not n.inputs or n.inputs[0] not in shapes:
            continue
        x = shapes[n.inputs[0]]
        op = n.op_type
        if op in ("Conv", "MaxPool", "ConvTranspose"):
            if op == "Conv":
                w = tuple(g.constants[n.inputs[1]].shape)
                kernel, out_c = w[2:], w[0]
            elif op == "ConvTranspose":
                w = g.constants[n.inputs[1]].shape
                kernel, out_c = tuple(w[2:]), w[1]
            else:
                kernel, out_c = tuple(n.attr("kernel_shape")), x[1]
            stride = tuple(n.attr("strides", [1, 1]))
            p = list(n.attr("pads", [0, 0, 0, 0]))
            padding = ((p[0], p[2]), (p[1], p[3]))
            if op == "ConvTranspose":
                out = tuple((h - 1) * s + kk for h, s, kk in zip(
                    x[2:], stride, kernel))
            else:
                out = k.conv_out_size(x[2:], kernel, stride, padding)
            shapes[n.outputs[0]] = (x[0], out_c, *out)
            if op == "Conv":
                convs.append((n.name, x, w, stride, padding))
        elif op == "Concat":
            ins = [shapes[i] for i in n.inputs]
            shapes[n.outputs[0]] = (x[0], sum(s[1] for s in ins), *x[2:])
        elif op == "GlobalAveragePool":
            shapes[n.outputs[0]] = (*x[:2], 1, 1)
        elif op in _SAME:
            shapes[n.outputs[0]] = x
    return convs


SQUEEZENET = _graph_convs(P.import_model(P.build_squeezenet()), 256)
RESNET50 = _graph_convs(P.import_model(P.build_resnet50()), 256)
UNET = _graph_convs(P.import_model(build_unet(UNetConfig(), batch=32,
                                              size=256)), 32)


# the output sizes of the models' stride-1 3x3s that the fallback rule
# keeps on the staged-halo producer, those where it keeps N <= 128 there
# (and on the int32 epilogue N % 128 == 0), and those where it sends any N
# to the gather (ResNet-50's weights in a ring)
HALO_SIZES = (54, 56, 28, 32, 64, 128, 256)
BY_N_SIZES = (26, 12)
GATHER_SIZES = (14, 7)


def _eligible(xs, ws, stride):
    """A stride-1 kxk (k > 1) over C % 16 == 0 channels: what the staged-
    halo producer can take."""
    return (stride == (1, 1) and k.conv_channels(xs[1]) % 16 == 0
            and ws[2:] != (1, 1))


def _design(xs, ws, stride, epilogue):
    """The producer the design names for a group-1 2-D conv of the models:
    the halo for an eligible conv over an output of HALO_SIZES, and of
    BY_N_SIZES where N <= 128 or (int32) N % 128 == 0 (the gather for the
    other N and for GATHER_SIZES), and for a stem (conv1's 3 channels at
    stride 2, as its space-to-depth rewrite; N <= 128), TMA for a stride-1
    unpadded 1x1 over C % 16 == 0 (on the int32 epilogue C >= 32), the
    gather for the rest (the strided convs over more channels, the int32
    1x1s over C 16)."""
    if k.stem_s2d(xs[1], ws[2:], stride):
        assert ws[0] <= 128
        return "halo"
    if _eligible(xs, ws, stride):
        assert xs[2] in HALO_SIZES + BY_N_SIZES + GATHER_SIZES
        n_ok = ws[0] <= 128 or (epilogue == "int32" and ws[0] % 128 == 0)
        return ("halo" if xs[2] in HALO_SIZES
                or (xs[2] in BY_N_SIZES and n_ok) else "gather")
    C = k.conv_channels(xs[1])
    if (stride == (1, 1) and C % 16 == 0
            and not (epilogue == "int32" and C == 16)):
        return "tma"
    return "gather"


def _split(convs, epilogue="requant"):
    split = dict.fromkeys(k.PRODUCERS, 0)
    for _, xs, ws, stride, padding in convs:
        split[k.conv_plan(xs, ws, stride, padding, None, epilogue)[0]] += 1
    return split


@pytest.mark.parametrize("epilogue,tma,halo,gather", [
    ("requant", 17, 5, 4), ("int32", 15, 7, 4)])
def test_squeezenet_b256_splits_by_producer(epilogue, tma, halo, gather):
    """The static INT8 forward (requant) and ORT's dynamic one (int32, its
    zero point in device memory): the 1x1s by TMA (on the int32 epilogue
    not fires 2-3's expand1x1 over C 16), conv1 (as its space-to-depth
    rewrite) and the 3x3 expands of fires 2-5 (N 64 and 128) on the
    staged-halo producer, and on the int32 epilogue those of fires 8-9 (N
    256 over 26 x 26 and 12 x 12); the expands of fires 6-7 (N 192), on
    the requant epilogue those of fires 8-9 and on the int32 one fires
    2-3's expand1x1 on the gather."""
    assert len(SQUEEZENET) == 26
    assert _split(SQUEEZENET, epilogue) == {"tma": tma, "halo": halo,
                                            "gather": gather}


MODELS = ([("squeezenet", c) for c in SQUEEZENET]
          + [("resnet50", c) for c in RESNET50]
          + [("unet", c) for c in UNET])


@pytest.mark.parametrize("model,conv", MODELS,
                         ids=[f"{m}-{c[0]}" for m, c in MODELS])
def test_conv_takes_the_named_producer(model, conv):
    name, xs, ws, stride, padding = conv
    for epilogue in ("requant", "int32"):
        producer, tile = k.conv_plan(xs, ws, stride, padding, None,
                                     epilogue)
        assert producer == _design(xs, ws, stride, epilogue), (name,
                                                               epilogue)
        if producer == "halo":
            assert tile.bm in (128, 256) and tile.bn in k.HALO_BN
            assert tile.stages >= 2
        else:
            assert 2 <= tile.stages <= q8.MAX_STAGES
            if producer == "tma" and epilogue == "int32":
                assert tile.bm in k.TILE_TMA_INT32_BM


def test_model_splits():
    assert len(RESNET50) == 53 and len(UNET) == 11
    # ResNet-50: the stem (its space-to-depth rewrite) and layers 1-2's six
    # stride-1 3x3s on the halo; 3 strided 3x3s, 3 strided shortcuts and
    # layers 3-4's seven stride-1 3x3s on the gather
    assert _split(RESNET50) == {"tma": 33, "halo": 1 + 6, "gather": 6 + 7}
    assert _split(UNET) == {"tma": 1, "halo": 6, "gather": 4}


# (x, w, resident, wins on the requant epilogue, wins on the int32 one)
FALLBACK_CASES = [
    ((256, 16, 54, 54), (64, 16, 3, 3), True, True, True),
    ((256, 32, 26, 26), (128, 32, 3, 3), True, True, True),
    ((256, 64, 26, 26), (256, 64, 3, 3), True, False, True),
    ((256, 48, 26, 26), (192, 48, 3, 3), True, False, False),
    ((256, 64, 12, 12), (256, 64, 3, 3), True, False, True),
    ((256, 64, 56, 56), (64, 64, 3, 3), True, True, True),
    ((256, 128, 28, 28), (128, 128, 3, 3), True, True, True),
    ((256, 256, 14, 14), (256, 256, 3, 3), False, False, False),
    ((256, 512, 7, 7), (512, 512, 3, 3), False, False, False),
    ((32, 32, 256, 256), (16, 32, 3, 3), True, True, True),
]


@pytest.mark.parametrize("epilogue", ["requant", "int32"])
@pytest.mark.parametrize("xs,ws,resident,requant,int32", FALLBACK_CASES)
def test_fallback_rule(xs, ws, resident, requant, int32, epilogue):
    """`halo_2d_wins`: the weights stay resident, and N fits one N tile or,
    on the int32 epilogue, fills whole ones."""
    wins = int32 if epilogue == "int32" else requant
    out = k.conv_out_size(xs[2:], ws[2:], (1, 1), ((1, 1), (1, 1)))
    plan = k.halo_plan(xs[1], ws[0], ws[2:], out, xs[0])
    assert plan["tile"].b_resident == resident
    assert plan["tile"].bn == (64 if ws[0] <= 64 else 128)
    assert k.halo_2d_wins(plan, ws[0], epilogue) == wins
    assert k.conv_plan(xs, ws, (1, 1), ((1, 1), (1, 1)), None,
                       epilogue)[0] == ("halo" if wins else "gather")


def test_tma_int32_bm_matches_the_source():
    """The TMA producer's int32 instances: the BM the plan gives is the one
    BM csrc/qconv_int8.cu instances (its TMA_INT32_BM), so the two cannot
    drift apart."""
    src = (Path(k.__file__).resolve().parents[2] / "csrc"
           / "qconv_int8.cu").read_text()
    bms = re.findall(r"constexpr int TMA_INT32_BM = (\d+);", src)
    assert [int(b) for b in bms] == list(k.TILE_TMA_INT32_BM)
    assert src.count("TMA_INT32_BM>(") == 2
    tile = k.conv_plan((256, 64, 12, 12), (256, 64, 1, 1), (1, 1),
                       ((0, 0), (0, 0)), None, "int32")[1]
    assert tile.bm == int(bms[0])


def _halo_tiles(B, OH, OW, TH, TW):
    """The kernel's walk of a 2-D halo plan's M tiles (columns fastest,
    then rows, images): each tile's (image, oh0, ow0)."""
    n_th, n_tw = -(-OH // TH), -(-OW // TW)
    for mt in range(B * n_th * n_tw):
        tw, r = mt % n_tw, mt // n_tw
        yield r // n_th, r % n_th * TH, tw * TW


PLAN_SHAPES = [(c[1], c[2], c[4]) for _, c in MODELS
               if _eligible(c[1], c[2], c[3])] + [
    ((2, C, H, H), (O, C, ks, ks), ((ks // 2, ks // 2),) * 2)
    for C in (16, 32, 48, 64, 256, 512) for H in (13, 27, 54)
    for ks, O in ((3, 64), (5, 192))] + [
    ((1, 80, 9, 30), (96, 80, 3, 5), ((0, 2), (1, 3)))]


@pytest.mark.parametrize("xs,ws,padding", PLAN_SHAPES)
def test_halo_plan_covers_the_output_and_fits(xs, ws, padding):
    """Every conv the halo can take, whether or not the fallback rule keeps
    it there (the card tests force the plan onto the halo)."""
    B, C = xs[:2]
    kernel = ws[2:]
    producer, tile = k.conv_plan(xs, ws, (1, 1), padding)
    out = k.conv_out_size(xs[2:], kernel, (1, 1), padding)
    plan = k.halo_plan(C, ws[0], kernel, out, B)
    assert producer == ("halo" if k.halo_2d_wins(plan, ws[0], "requant")
                        else "gather")
    if producer == "halo":
        assert tile == plan["tile"]
    td, th, tw = plan["out_box"]
    assert (td, tw) == (1, k.HALO_ROWS) and th == 8 * plan["planes"]
    assert plan["tile"].bm == 64 * plan["planes"]
    seen = np.zeros((B, *out), np.int32)
    for b, oh0, ow0 in _halo_tiles(B, *out, th, tw):
        seen[b, oh0:oh0 + th, ow0:ow0 + tw] += 1
    assert (seen == 1).all()
    # the box (its origin the tile's first output less the padding) holds
    # every tap of every output of the tile
    bd, bh, bw = plan["box"]
    assert bd == 1 and bh == th + kernel[0] - 1 and bw == tw + kernel[1] - 1
    assert plan["cb_pitch"] % 128 == 0 and plan["cb_pitch"] >= bh * bw * 16
    cbs = plan["chunk"] // 16
    assert plan["blocks"] == cbs + cbs % 2
    assert plan["box_bytes"] == plan["blocks"] * plan["cb_pitch"]
    assert plan["smem"] <= q8.SMEM_LIMIT == 232448
    # the K walk: each 16-byte K slice of the packed weight once
    Kp = math.prod(kernel) * C
    assert k.pack_qconv_weight(torch.zeros(ws, dtype=torch.int8)).shape \
        == (ws[0], Kp)
    seen_k = [s for _, _, col in _k_walk(plan, C, math.prod(kernel))
              for s in (col // 16, col // 16 + 1) if s < Kp // 16]
    assert sorted(seen_k) == list(range(Kp // 16))


def _k_walk(plan, C, taps):
    """The kernel's k32 steps of one tile: (chunk, the step's byte of the
    chunk's K walk, its first byte of the packed weight row); every step
    of a slice, those past the chunk's K against zero weights."""
    chunk, n_chunks = plan["chunk"], plan["n_chunks"]
    for q in range(n_chunks):
        for j in range(plan["chunk_k"]):
            for kk in range(4):
                kl = j * q8.STAGE_K + kk * 32
                col = (j * q8.STAGE_K if n_chunks == 1
                       else j * C + q * chunk) + kk * 32
                yield q, kl, col


def _emulate_halo(x, w, padding, pad_value):
    """The staged-halo producer's sums as the kernel forms them: each
    tile's input box loaded channel-blocked (a copy of the chunk's block 0
    after its last where its blocks are odd), each k32 step's A read from
    the box at the tap's offset, its second 16 bytes at the step's leading
    offset, 8-row groups one box row apart, against 32 bytes of the packed
    weight; int64 [B, O, OH, OW]."""
    B, C, H, W = x.shape
    O, _, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    out = k.conv_out_size((H, W), (KH, KW), (1, 1), padding)
    plan = k.halo_plan(C, O, (KH, KW), out, B)
    _, th, tw = plan["out_box"]
    _, bh, bw = plan["box"]
    pitch, chunk, cbs = plan["cb_pitch"], plan["chunk"], plan["chunk"] // 16
    taps = KH * KW
    packed = k.pack_qconv_weight(w).to(torch.int64).numpy()
    packed = np.pad(packed, ((0, 0), (0, 4 * q8.STAGE_K)))
    xv = x.to(torch.int64).numpy()
    xp = np.full((B, C, H + pt + pb + th, W + pl + pr + tw), pad_value,
                 np.int64)
    xp[:, :, pt:pt + H, pl:pl + W] = xv
    # a tap past the last (a slice's tail, against zero weights) reads the
    # last tap's place
    offs = [(min(t, taps - 1) // KW * bw + min(t, taps - 1) % KW) * 16
            for t in range(taps + 9)]
    sbo, patch = bw * 16, 8 * bw * 16
    rows = np.arange(64)
    rowbase = (rows // 8) * sbo + (rows % 8) * 16
    got = np.zeros((B, O, *out), np.int64)
    for b, oh0, ow0 in _halo_tiles(B, *out, th, tw):
        acc = np.zeros((plan["planes"], 64, O), np.int64)
        for q in range(plan["n_chunks"]):
            smem = np.zeros(plan["blocks"] * pitch, np.int64)
            for i in range(plan["blocks"]):
                c0 = q * chunk + 16 * (i if i < cbs else 0)
                box = xp[b, c0:c0 + 16, oh0:oh0 + bh, ow0:ow0 + bw]
                smem[i * pitch:i * pitch + bh * bw * 16] = \
                    box.transpose(1, 2, 0).reshape(-1)
            for qq, kl, col in _k_walk(plan, C, taps):
                if qq != q:
                    continue
                t = kl // chunk
                cb = (kl - t * chunk) // 16
                a = cb * pitch + offs[t]
                lbo = pitch + (offs[t + 1] - offs[t] if cb == cbs - 1 else 0)
                kb = np.arange(32)
                idx = a + (kb // 16) * lbo + kb % 16
                wb = packed[:, col:col + 32]
                for pa in range(plan["planes"]):
                    amat = smem[pa * patch + rowbase[:, None] + idx[None, :]]
                    acc[pa] += amat @ wb.T
        for pa in range(plan["planes"]):
            for r in range(64):
                oh, ow = oh0 + 8 * pa + r // 8, ow0 + r % 8
                if oh < out[0] and ow < out[1]:
                    got[b, :, oh, ow] = acc[pa, r]
    return got


@pytest.mark.parametrize("C,ks,xdt,pad_value", [
    (16, 3, torch.int8, 0), (16, 3, torch.uint8, 131), (48, 3, torch.int8, 5),
    (48, 5, torch.uint8, 0), (32, 3, torch.int8, -7), (80, 3, torch.uint8, 9),
])
def test_emulated_halo_k_walk_equals_plain(C, ks, xdt, pad_value):
    """C = 16 (every step spans two taps) and C = 48, 80 (a tap's third or
    fifth block pairs with the next tap's first) read the right bytes;
    C = 32 is the even case; the padding's zero point on the border."""
    rng = np.random.default_rng(C + ks)
    lo, hi = (0, 256) if xdt == torch.uint8 else (-128, 128)
    x = torch.from_numpy(rng.integers(lo, hi, (1, C, 13, 11))).to(xdt)
    w = torch.from_numpy(rng.integers(-127, 128, (24, C, ks, ks), np.int8))
    padding = ((ks // 2, ks // 2 + 1), (ks // 2, ks // 2))
    got = _emulate_halo(x, w, padding, pad_value)
    want = k.qconv_int8_plain(x, w, padding=padding, pad_value=pad_value)
    np.testing.assert_array_equal(got, want.to(torch.int64).numpy())


@pytest.mark.parametrize("C,kernel,stride,dilation,epilogue,want", [
    (16, (3, 3), (1, 1), None, "requant", "halo"),
    (48, (3, 3), (1, 1), None, "int32", "halo"),
    (64, (5, 5), (1, 1), None, "requant", "halo"),
    (128, (3, 3), (1, 1), None, "int32", "halo"),
    (160, (3, 3), (1, 1), None, "requant", "gather"),  # C > 128, % 128
    (24, (3, 3), (1, 1), None, "requant", "gather"),   # C % 16
    (64, (3, 3), (2, 2), None, "requant", "gather"),   # strided
    (64, (3, 3), (1, 1), (2, 2), "requant", "gather"),  # dilated
    (64, (1, 1), (1, 1), None, "int32", "tma"),
    (32, (1, 1), (1, 1), None, "int32", "tma"),
    (16, (1, 1), (1, 1), None, "int32", "gather"),    # C 16, int32
    (16, (1, 1), (1, 1), None, "requant", "tma"),
    (64, (1, 1), (2, 2), None, "int32", "gather"),
    (16, (3, 3, 3), (1, 1, 1), None, "int32", "halo"),
])
def test_halo_takes_exactly_its_convs(C, kernel, stride, dilation, epilogue,
                                      want):
    """At a 16 x 16 output (the tiles cover it once) with resident weights,
    and a 3-D one."""
    xs = (2, C) + (16,) * len(kernel)
    pad = ((0, 0),) * len(kernel) if kernel[0] == 1 else ((1, 1),) * len(
        kernel)
    assert k.conv_plan(xs, (64, C, *kernel), stride, pad, dilation,
                       epilogue)[0] == want
