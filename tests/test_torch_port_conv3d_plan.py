"""The plans of the 3-D int8 convs' Hopper forms, on the CPU: no kernel and
no model forward.

- `conv_plan` sends each of R3D-18's 20 convs (b16 clips of R3D_CLIP, the
  shapes read off `build_r3d18`'s graph) to the producer its design names:
  the 13 stride-1 3x3x3 convs and the stem (as its space-to-depth
  rewrite, tests/test_torch_port_stem_plan.py) to the staged-halo
  producer, the 3 strided convs and the 3 shortcuts to the gather.
- Each halo plan's output boxes (2 or 4 planes), walked as the kernel
  walks its tiles, cover the output once; its input box holds every
  tap's reads; its K walk (one box or 128-channel chunks) takes every
  128-byte slice of the packed weight once; its shared memory fits a
  block.
- `grouped_mode` / `grouped_plan` name `tile3d` exactly for an undilated
  depthwise 3x3x3 at depth stride 1 or 2 and row and column stride 1 or 2
  (equal), C % 16 == 0, an aligned x, the requant output and zero points
  known before the run; `general` for the int32 output, device zero
  points, dilation, C % 16 != 0 and the rest. Each tile3d box holds its
  tile's reads, its tiles cover the output, and the launch's arguments are
  in the entry point's order.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
    qconv_grouped_int8 as g8, qconv_int8 as k, qmatmul_int8 as q8)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_video import R3D_CLIP, build_r3d18  # noqa: E402

BATCH = 16


def _r3d_convs():
    """R3D-18's convs as (name, x shape, w shape, stride, padding) at b16,
    the shapes carried through the graph's Conv, Relu and Add nodes."""
    model = build_r3d18()
    g = model.graph
    shapes = {g.inputs[0].name: (BATCH, *R3D_CLIP)}
    convs = []
    for n in g.nodes:
        if n.op_type == "Conv":
            x = shapes[n.input[0]]
            w = tuple(g.initializers[n.input[1]].shape)
            stride = tuple(n.attr("strides"))
            p = list(n.attr("pads"))
            padding = tuple((p[i], p[i + 3]) for i in range(3))
            out = k.conv_out_size(x[2:], w[2:], stride, padding)
            shapes[n.output[0]] = (x[0], w[0], *out)
            convs.append((n.name, x, w, stride, padding))
        elif n.op_type in ("Relu", "Add"):
            shapes[n.output[0]] = shapes[n.input[0]]
    return convs


R3D = _r3d_convs()


def test_r3d_has_20_convs_13_of_them_stride_1_3x3x3():
    assert len(R3D) == 20
    s1 = [c for c in R3D if c[3] == (1, 1, 1) and c[2][2:] == (3, 3, 3)]
    assert len(s1) == 13
    assert {c[1][1] for c in s1} == {64, 128, 256, 512}


@pytest.mark.parametrize("i", range(20))
def test_r3d_conv_takes_the_named_producer(i):
    name, xs, ws, stride, padding = R3D[i]
    producer, tile = k.conv_plan(xs, ws, stride, padding)
    halo = stride == (1, 1, 1) and ws[2:] == (3, 3, 3)
    stem = k.stem_s2d(xs[1], ws[2:], stride)
    assert producer == ("halo" if halo or stem else "gather"), name
    if stem:
        # the stem as its space-to-depth rewrite (a stride-1 3x4x4 over 16
        # channels): four output planes a tile, BN 64, its weights resident
        assert (tile.bm, tile.bn, tile.b_resident) == (256, 64, True)
    elif halo:
        # four output planes a tile where they divide the output's depth
        # (layers 1-3), else two (layer4: OD 2); BN 64 for layer1's N and
        # where 128-wide tiles would fill half the SMs or less (layer4: 16
        # x 4 tiles); layer1's weights (N 64, K 1728) stay in shared memory
        bm, bn, resident = {64: (256, 64, True), 128: (256, 128, False),
                            256: (256, 128, False),
                            512: (128, 64, False)}[xs[1]]
        assert (tile.bm, tile.bn, tile.b_resident) == (bm, bn, resident)
        assert tile.stages >= 2
    else:
        assert tile.bm in k.TILE_3D_BM and tile.bn in k.TILE_3D_BN
    # the int32 epilogue (ConvInteger) takes the same producer
    assert k.conv_plan(xs, ws, stride, padding,
                       epilogue="int32")[0] == producer


def _halo_tiles(B, OD, OH, OW, TD):
    """The kernel's walk of the staged-halo producer's M tiles of TD planes
    (columns fastest, then rows, planes, images): each tile's (image, od0,
    oh0, ow0)."""
    TH = TW = k.HALO_ROWS
    n_td, n_th, n_tw = -(-OD // TD), -(-OH // TH), -(-OW // TW)
    for mt in range(B * n_td * n_th * n_tw):
        tw, r = mt % n_tw, mt // n_tw
        th, r = r % n_th, r // n_th
        yield r // n_td, r % n_td * TD, th * TH, tw * TW


HALO_SHAPES = [(c[1], c[2], c[4]) for c in R3D if c[3] == (1, 1, 1)
               and c[2][2:] == (3, 3, 3)] + [
    ((1, 64, 5, 13, 11), (48, 64, 3, 3, 3), ((1, 1),) * 3),
    ((2, 32, 3, 9, 17), (80, 32, 3, 3, 3), ((1, 1),) * 3),
    ((1, 96, 4, 10, 10), (128, 96, 3, 3, 3), ((1, 1),) * 3),
    ((1, 384, 3, 6, 6), (192, 384, 3, 3, 3), ((1, 1),) * 3),
    ((2, 64, 6, 9, 8), (64, 64, 2, 3, 1), ((1, 0), (0, 2), (1, 1))),
]


@pytest.mark.parametrize("xs,ws,padding", HALO_SHAPES)
def test_halo_plan_covers_the_output_and_fits(xs, ws, padding):
    B, C = xs[:2]
    kernel = ws[2:]
    assert k.conv_plan(xs, ws, (1, 1, 1), padding)[0] == "halo"
    out = k.conv_out_size(xs[2:], kernel, (1, 1, 1), padding)
    plan = k.halo_plan(C, ws[0], kernel, out, B)
    assert k.conv_plan(xs, ws, (1, 1, 1), padding)[1] == plan["tile"]
    td = plan["planes"]
    assert plan["tile"].bm == 64 * td
    seen = np.zeros((B, *out), np.int32)
    for b, od0, oh0, ow0 in _halo_tiles(B, *out, td):
        seen[b, od0:od0 + td, oh0:oh0 + 8, ow0:ow0 + 8] += 1
    assert (seen == 1).all()
    # the box (its origin the tile's first voxel less the padding) holds
    # every tap of every voxel of the tile
    box = plan["box"]
    assert all(t + kk - 1 <= n for t, kk, n in zip((td, 8, 8), kernel, box))
    assert plan["cb_pitch"] % 128 == 0
    assert plan["cb_pitch"] >= math.prod(box) * 16
    assert plan["smem"] <= q8.SMEM_LIMIT
    # the K walk: every 128-byte slice of the packed weight once
    Kp = math.prod(kernel) * C
    assert k.pack_qconv_weight(torch.zeros(ws, dtype=torch.int8)).shape \
        == (ws[0], Kp)
    if plan["n_chunks"] == 1:
        cols = [j * q8.STAGE_K for j in range(plan["chunk_k"])]
    else:
        cols = [j * C + q * plan["chunk"] for q in range(plan["n_chunks"])
                for j in range(plan["chunk_k"])]
    assert sorted(cols) == list(range(0, -(-Kp // q8.STAGE_K) * q8.STAGE_K,
                                      q8.STAGE_K))


@pytest.mark.parametrize("C,kernel,stride,dilation,epilogue,want", [
    (64, (3, 3, 3), (1, 1, 1), None, "requant", True),
    (512, (3, 3, 3), (1, 1, 1), None, "requant", True),
    (96, (3, 3, 3), (1, 1, 1), None, "requant", True),
    (384, (3, 3, 3), (1, 1, 1), None, "requant", True),
    (16, (3, 3, 3), (1, 1, 1), None, "requant", True),    # C % 32 == 16
    (24, (3, 3, 3), (1, 1, 1), None, "requant", False),   # C % 16
    (160, (3, 3, 3), (1, 1, 1), None, "requant", False),  # C > 128, % 128
    (64, (3, 3, 3), (2, 2, 2), None, "requant", False),   # strided
    (64, (3, 3, 3), (1, 1, 1), (1, 2, 1), "requant", False),
    (64, (3, 3, 3), (1, 1, 1), None, "int32", True),
    (64, (3, 3), (1, 1), None, "requant", True),          # 2-D
])
def test_halo_takes_exactly_its_convs(C, kernel, stride, dilation, epilogue,
                                      want):
    xs = (2, C) + (6,) * len(kernel)
    pad = ((1, 1),) * len(kernel)
    producer = k.conv_plan(xs, (64, C, *kernel), stride, pad, dilation,
                           epilogue)[0]
    assert (producer == "halo") == want


DW = [  # (x shape, stride)
    ((16, 64, 16, 56, 56), (1, 1, 1)),
    ((16, 64, 16, 56, 56), (1, 2, 2)),
    ((2, 32, 8, 28, 28), (2, 2, 2)),
    ((1, 512, 4, 14, 14), (1, 1, 1)),
    ((2, 16, 5, 7, 7), (1, 1, 1)),
    ((1, 48, 7, 13, 15), (2, 1, 1)),
]


@pytest.mark.parametrize("xs,stride", DW)
def test_tile3d_plan_holds_its_reads_and_covers(xs, stride):
    B, C = xs[:2]
    pad = ((1, 1),) * 3
    plan = g8.grouped_plan(xs, (C, 1, 3, 3, 3), stride, pad, 16)
    assert plan["form"] == "tile3d"
    (td, th, tw), (bd, bh, bw, run) = plan["tile"], plan["box"]
    sd, s = stride[0], stride[1]
    assert bd >= (td - 1) * sd + 3 and bh >= (th - 1) * s + 3
    assert bw >= (tw - 1) * s + 3 and max(bd, bh, bw) <= g8.BOX_MAX
    out = k.conv_out_size(xs[2:], (3, 3, 3), stride, pad)
    grid = plan["grid"]
    assert grid[0] == B and grid[1] * td >= out[0] and grid[2] * th >= out[1]
    assert grid[3] * tw >= out[2] and grid[4] * run >= C
    # the grid holds no tile wholly past the output
    assert (grid[1] - 1) * td < out[0] and (grid[2] - 1) * th < out[1]
    assert plan["buf"] % 128 == 0 and plan["buf"] >= bd * bh * bw * run
    assert bd * bh * bw * run <= g8.TILE3D_BUF
    assert plan["smem"] == 2 * plan["buf"] + 16
    assert plan["threads"] % 32 == 0
    assert plan["threads"] >= (run // 4) * (tw // 2)
    assert plan["threads"] <= g8.TILE_THREADS
    assert plan["tiles"] == math.prod(grid)
    args = g8.tile_args(plan)
    assert args == (th, tw, run, bh, bw, plan["buf"], plan["smem"],
                    plan["threads"], grid[2], grid[3], grid[4], td, bd,
                    grid[1])


@pytest.mark.parametrize("C,Cg,O,kernel,stride,align,dil,int32,dzp,want", [
    (64, 1, 64, (3, 3, 3), (1, 1, 1), 16, None, False, False, "tile3d"),
    (64, 1, 64, (3, 3, 3), (1, 2, 2), 16, None, False, False, "tile3d"),
    (64, 1, 64, (3, 3, 3), (2, 2, 2), 16, None, False, False, "tile3d"),
    (16, 1, 16, (3, 3, 3), (2, 1, 1), 16, None, False, False, "tile3d"),
    (64, 1, 64, (3, 3, 3), (1, 1, 1), 16, None, True, False, "general"),
    (64, 1, 64, (3, 3, 3), (1, 1, 1), 16, None, False, True, "general"),
    (64, 1, 64, (3, 3, 3), (1, 1, 1), 16, (1, 2, 2), False, False,
     "general"),
    (24, 1, 24, (3, 3, 3), (1, 1, 1), 16, None, False, False, "general"),
    (64, 1, 64, (3, 3, 3), (1, 1, 2), 16, None, False, False, "general"),
    (64, 1, 64, (3, 3, 3), (3, 1, 1), 16, None, False, False, "general"),
    (64, 1, 64, (3, 3, 3), (1, 1, 1), 4, None, False, False, "general"),
    (64, 2, 32, (3, 3, 3), (1, 1, 1), 16, None, False, False, "general"),
    (64, 1, 128, (3, 3, 3), (1, 1, 1), 16, None, False, False, "general"),
    (64, 1, 64, (1, 3, 3), (1, 1, 1), 16, None, False, False, "general"),
    (64, 1, 64, (3, 3), (1, 1), 16, None, False, False, "tile"),
])
def test_grouped_mode_names_tile3d(C, Cg, O, kernel, stride, align, dil,
                                   int32, dzp, want):
    assert g8.grouped_mode(C, Cg, O, C // Cg, kernel, stride, align, dil,
                           int32, dzp) == want
    assert want in g8.FORMS
