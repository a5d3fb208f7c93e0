"""int8 grouped convolution (group > 1: MobileNetV2's depthwise convs) with
a fused int32-bias + requant epilogue.

No Pallas kernel stands behind it: for group > 1 the JAX package's
QLinearConv emitter runs XLA's grouped conv with int32 accumulation, then
the bias add and `_requant`
(onnx_rusty_inference_engine_tpu/ops/quantized.py:126-146). On the card no
library call takes an int8 grouped conv, and cuDNN in f32 may pick a
rounding (Winograd, FFT) algorithm, so the port computes it in a kernel of
its own, `csrc/qconv_grouped_int8.cu`: int32 sums, the requant of
`_requant` in registers, channels-last int8 or uint8 in and out, with
ONNX Runtime's QOperator forms (a uint8 x, padding taps holding the x zero
point, an output zero point, dilation in the general form). Its source
note says what bounds it on the H100 and how each form works.

`grouped_plan` picks the kernel's form from the shapes, and for the tile
forms the whole launch: "tile" (2-D depthwise 3x3 at stride 1 or 2, C % 16
== 0, x 16-byte aligned: TMA-staged input tiles, IDP4A, register
blocking), "tile3d" (its 3-D counterpart: depthwise 3x3x3 over x [B, C,
D, H, W], depth stride 1 or 2, row and column stride 1 or 2, staged as
5-D boxes, nine IDP4A a column) or "general" (any other group > 1, a
dilated one, any other 3-D conv (a depth loop over the taps, the depth a
run-time size), a zero point read from device memory, and the int32
output: one thread per output pixel and 4 output channels). `pad_value`
and `y_zp` may be ints or one-element tensors on the card (zero points
computed at run time), which the kernel reads in the run. The kernel's
entry point takes the tile forms' plans as they are and only checks them
against its
limits. `qconv_grouped_int8` is the general form's exact int32 output
(+ bias), for a weight with a zero point.

On the card the wrapper reads a channels-last input as it is (any other is
copied channels-last) and returns a [B, O, OH, OW] view with
`torch.channels_last` strides of the kernel's [B*OH*OW, O] output, as
`qconv_int8_requant` does, so the ops between convs keep the layout.

Both outputs are `torch.library` operators (defined in _ops.py),
`oriet::qconv_grouped_int8_requant` and `oriet::qconv_grouped_int8`: on
the CPU the kernel's plain PyTorch version
(`qconv_grouped_int8_requant_plain`, exact float64 sums through
`F.conv2d(groups=...)`, then `_requant`), on the card the launch, and a
fake implementation giving the result's shape, dtype and strides
(`qconv_int8.conv_fake`) for torch.export. The plan is chosen in the
card's implementation, from the shapes and the input's alignment. The
wrappers raise for a tensor on neither device and call the op. `qconv_grouped_int8_requant.launches`
counts the kernel's launches through both wrappers, `.schedules` counts
them per form, `.forms` per QOperator form (qconv_int8.FORMS).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from ._ops import define
from .qconv_int8 import FORMS as QFORMS
from .qconv_int8 import (CONV_ARGS, ZP_ARGS, _as_3d, _spatial_args, _zp,
                         conv_fake, conv_out_size, conv_sums_plain,
                         nested_padding, op_zero_points)
from .qmatmul_int8 import (ZeroPoint, _requant, as_mult, check_device,
                           check_operand, check_qtype, count_forms,
                           mult_vector, zero_point_arg)

__all__ = ["qconv_grouped_int8_requant", "qconv_grouped_int8_requant_plain",
           "qconv_grouped_int8", "qconv_grouped_int8_plain",
           "pack_qconv_grouped_weight", "grouped_mode", "grouped_plan",
           "input_align", "conv_groups", "tile_args", "FORMS", "RUN"]

# output channels per thread; packed weight columns are padded to it
RUN = 4

# the kernel's forms, the keys of `.schedules`
FORMS = ("tile", "tile3d", "general")

# the tile form: the most threads a block (the kernel's launch bound), the
# bytes one staged input tile may take (two are in flight a block, so three
# blocks fit an SM's 227 KB), the widest C taken whole as one channel run,
# the other channel runs (TMA boxes of 16-byte multiples), the largest TMA
# box side
TILE_THREADS = 256
TILE_BUF = 32 * 1024
TILE_WHOLE = 160
TILE_RUNS = (64, 48, 32, 16)
BOX_MAX = 256
# the tile3d form's staged box (two a block: two blocks fill an SM's 227 KB)
TILE3D_BUF = 48 * 1024

# the largest taps per output (Cg * KH * KW) whose int32 sums cannot
# overflow: every product is at most 128 * 128 in magnitude
MAX_TAPS = (2 ** 31 - 1) // (128 * 128)

Padding = Sequence[Tuple[int, int]]


def conv_groups(x_shape: Sequence[int], w_shape: Sequence[int]) -> int:
    """The group count of a conv of x [B, C, ...] by w [O, Cg, ...]:
    C / Cg; raises where the channels do not split into groups."""
    C, (O, Cg) = x_shape[1], w_shape[:2]
    if Cg <= 0 or C % Cg or O % (C // Cg):
        raise ValueError(f"x {tuple(x_shape)} and w {tuple(w_shape)} are "
                         f"not a grouped conv")
    return C // Cg


def grouped_mode(C: int, Cg: int, O: int, group: int,
                 kernel: Sequence[int], stride: Sequence[int],
                 x_align: int = 16, dilation: Optional[Sequence[int]] = None,
                 int32: bool = False, device_zp: bool = False) -> str:
    """The kernel's form for a conv of C input channels in `group` groups
    of Cg, O output channels, a kernel of kernel = (KH, KW) (3-D: (KD, KH,
    KW)) at `stride` and `dilation`, over an input whose address is a
    multiple of `x_align` bytes: for an undilated depthwise conv with C %
    16 == 0 and x 16-byte aligned on the requant output with its zero
    points known before the run, "tile" where it is a 3x3 at stride 1 or 2
    and "tile3d" where it is a 3x3x3 at depth stride 1 or 2 and row and
    column stride 1 or 2 (the two equal); "general" otherwise (the int32
    output, a zero point in device memory, dilation, any other kernel)."""
    kernel, stride = tuple(kernel), tuple(stride)
    if not (Cg == 1 and O == group and C % 16 == 0 and x_align % 16 == 0
            and tuple(dilation or (1,) * len(kernel)) == (1,) * len(kernel)
            and not int32 and not device_zp):
        return "general"
    if kernel == (3, 3) and stride in ((1, 1), (2, 2)):
        return "tile"
    if (kernel == (3, 3, 3) and stride[0] in (1, 2)
            and stride[1:] in ((1, 1), (2, 2))):
        return "tile3d"
    return "general"


def _tile(B: int, C: int, OH: int, OW: int, s: int) -> dict:
    """The tile form's launch for a depthwise 3x3 at stride s. The channel
    run: C itself up to TILE_WHOLE channels, so that each row of the TMA
    box is one contiguous run of bytes (chip_smoke.py's grouped kernel
    lines time the run TILE_RUNS alone would give beside it), else the one
    of TILE_RUNS that wastes the fewest channels, the widest of those. A
    thread takes 4 channels and 2 columns, so a block's run x columns are
    (run / 4) x (TW / 2) threads, at most TILE_THREADS: TW is the widest
    that splits OW evenly into that many. TH: the most rows whose input
    box (with its halo) fits TILE_BUF, split evenly into OH. The staging
    buffer is the box rounded up to 128 bytes; a block holds two and
    their two 8-byte barriers."""
    runs = ((C,) if C <= TILE_WHOLE else ()) + tuple(TILE_RUNS)
    run = min(runs, key=lambda r: (-(-C // r) * r - C, -r))
    pairs = -(-OW // 2)
    p_max = min(TILE_THREADS // (run // 4), ((BOX_MAX - 3) // s + 1) // 2)
    n_w = -(-pairs // p_max)
    tw = 2 * -(-pairs // n_w)
    bw = (tw - 1) * s + 3
    rows = max(1, min((TILE_BUF // (bw * run) - 3) // s + 1,
                      (BOX_MAX - 3) // s + 1))
    n_h = -(-OH // rows)
    th = -(-OH // n_h)
    bh = (th - 1) * s + 3
    buf = -(-bh * bw * run // 128) * 128
    grid = (B, -(-OH // th), -(-OW // tw), -(-C // run))
    return {"tile": (th, tw), "run": run, "box": (bh, bw, run), "buf": buf,
            "smem": 2 * buf + 16,
            "threads": -(-(run // 4) * (tw // 2) // 32) * 32,
            "grid": grid, "tiles": grid[0] * grid[1] * grid[2] * grid[3]}


@functools.lru_cache(maxsize=256)
def _tile3d(B: int, C: int, OD: int, OH: int, OW: int, sd: int,
            s: int) -> dict:
    """The tile3d form's launch for a depthwise 3x3x3 at depth stride sd
    and row and column stride s. The channel run and the columns as the
    tile form's (`_tile`); then the planes TD and rows TH: of the even
    splits of OD and OH whose input box ((TD-1)*sd+3 planes, (TH-1)*s+3
    rows, the columns' halo, the run) fits TILE3D_BUF, the one whose boxes
    stage the fewest bytes in all (the halo read again, the tiles past the
    output), then the most rows (a thread reads each input row of a plane
    once for its TH rows and the two of the halo)."""
    run = _tile(B, C, OH, OW, s)
    (_, tw), (_, bw, cr) = run["tile"], run["box"]
    best = None
    for n_d in range(1, OD + 1):
        td = -(-OD // n_d)
        if -(-OD // td) != n_d:
            continue
        bd = (td - 1) * sd + 3
        for n_h in range(1, OH + 1):
            th = -(-OH // n_h)
            if -(-OH // th) != n_h:
                continue
            bh = (th - 1) * s + 3
            if bd * bh * bw * cr > TILE3D_BUF or max(bd, bh) > BOX_MAX:
                continue
            key = (n_d * n_h * bd * bh, -th)
            if best is None or key < best[0]:
                best = (key, td, th, bd, bh)
    _, td, th, bd, bh = best
    buf = -(-bd * bh * bw * cr // 128) * 128
    grid = (B, -(-OD // td), -(-OH // th), -(-OW // tw), -(-C // cr))
    return {"tile": (td, th, tw), "run": cr, "box": (bd, bh, bw, cr),
            "buf": buf, "smem": 2 * buf + 16, "threads": run["threads"],
            "grid": grid, "tiles": math.prod(grid)}


def tile_args(plan: dict) -> Tuple[int, ...]:
    """A tile form's plan as the kernel's entry point takes it: TH, TW,
    channel run, box rows and columns, staging buffer bytes, shared
    memory, threads, and row, column and channel tiles an image; for the
    tile3d form then TD, box planes and plane tiles."""
    if plan["form"] == "tile3d":
        (td, th, tw), (bd, bh, bw, run) = plan["tile"], plan["box"]
        return (th, tw, run, bh, bw, plan["buf"], plan["smem"],
                plan["threads"], *plan["grid"][2:], td, bd, plan["grid"][1])
    (th, tw), (bh, bw, run) = plan["tile"], plan["box"]
    return (th, tw, run, bh, bw, plan["buf"], plan["smem"], plan["threads"],
            *plan["grid"][1:])


def grouped_plan(x_shape: Sequence[int], w_shape: Sequence[int],
                 stride: Sequence[int], padding: Padding,
                 x_align: int = 16, dilation: Optional[Sequence[int]] = None,
                 int32: bool = False, device_zp: bool = False) -> dict:
    """How the kernel runs a grouped conv of x [B, C, H, W] by w [O, Cg,
    KH, KW] (or x [B, C, D, H, W] by w [O, Cg, KD, KH, KW]): the form
    (`grouped_mode`, the key `.schedules` counts) and,
    for the tile form, the launch the kernel takes (`tile_args`): the
    output tile (TH, TW), the channel run, the input box (rows, columns,
    channels), the staging buffer, the block's shared memory and threads,
    and the grid of tiles (B, row tiles, column tiles, channel runs),
    which persistent blocks walk; for the tile3d form the same with
    planes first (tile (TD, TH, TW), box (planes, rows, columns,
    channels), grid (B, plane tiles, row, column, channel tiles);
    `_tile3d`). The general form: one 256-thread block per 256 (pixel, 4
    channels) pairs."""
    B, C = x_shape[:2]
    O, Cg = w_shape[:2]
    kernel = tuple(w_shape[2:])
    dilation = tuple(dilation or (1,) * len(kernel))
    group = conv_groups(x_shape, w_shape)
    out = conv_out_size(x_shape[2:], kernel, stride, padding, dilation)
    form = grouped_mode(C, Cg, O, group, kernel, stride, x_align,
                        dilation, int32, device_zp)
    if form == "tile":
        return {"form": form, **_tile(B, C, *out, stride[0])}
    if form == "tile3d":
        return {"form": form, **_tile3d(B, C, *out, stride[0], stride[1])}
    threads = B * math.prod(out) * (-(-O // RUN))
    return {"form": form, "tile": None, "run": None, "box": None,
            "buf": None, "smem": 0, "threads": 256,
            "grid": (-(-threads // 256),), "tiles": None}


def pack_qconv_grouped_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 [O, Cg, KH, KW] (or [O, Cg, KD, KH, KW]) -> int8 [KH*KW*Cg, Op]
    ([KD*KH*KW*Cg, Op]): row (kh, kw, c) ((kd, kh, kw, c)) holds every
    output channel's weight at that tap, Op = O rounded up to RUN, zero
    past O."""
    if w.dtype != torch.int8 or w.dim() not in (4, 5):
        raise ValueError(f"pack_qconv_grouped_weight: want int8 "
                         f"[O,Cg,KH,KW] or [O,Cg,KD,KH,KW], got {w.dtype} "
                         f"{tuple(w.shape)}")
    O, Cg = w.shape[:2]
    rows = math.prod(w.shape[2:]) * Cg
    out = torch.zeros((rows, -(-O // RUN) * RUN), dtype=torch.int8,
                      device=w.device)
    out[:, :O] = w.permute(*range(2, w.dim()), 1, 0).reshape(rows, O)
    return out


def address_align(ptr: int) -> int:
    """The largest power of two up to 16 that divides an address."""
    return min(16, ptr & -ptr) if ptr else 16


# --------------------------------------------------------------------------
# plain version: exact sums, then the fp32 epilogue
# --------------------------------------------------------------------------
def qconv_grouped_int8_requant_plain(x: torch.Tensor, w: torch.Tensor,
                                     mult: torch.Tensor,
                                     bias: Optional[torch.Tensor] = None, *,
                                     stride: Optional[Sequence[int]] = None,
                                     padding: Optional[Padding] = None,
                                     dilation: Optional[Sequence[int]] = None,
                                     pad_value: ZeroPoint = 0,
                                     y_zp: ZeroPoint = 0,
                                     out_dtype: torch.dtype = torch.int8
                                     ) -> torch.Tensor:
    """x int8 or uint8 [B,C,H,W], w int8 [O,C/group,KH,KW], mult f32 [O]
    or scalar, bias int32 [O] -> out_dtype [B,O,OH,OW] (3-D likewise; the
    zero points ints or one-element tensors). The sums are taken
    in float64 (`conv_sums_plain`, padding taps holding pad_value), where
    every partial sum of 8-bit products is an exact integer, so the int32
    result equals the kernel's whatever the order."""
    acc = conv_sums_plain(x, w, stride, padding, dilation, pad_value,
                          groups=conv_groups(x.shape, w.shape))
    return _requant(acc, mult, bias, channel_dim=1, y_zp=y_zp,
                    out_dtype=out_dtype)


def qconv_grouped_int8_plain(x: torch.Tensor, w: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             stride: Optional[Sequence[int]] = None,
                             padding: Optional[Padding] = None,
                             dilation: Optional[Sequence[int]] = None,
                             pad_value: ZeroPoint = 0) -> torch.Tensor:
    """The int32 output's function: the exact sums (+ bias) -> int32
    [B,O,OH,OW] ([B,O,OD,OH,OW])."""
    acc = conv_sums_plain(x, w, stride, padding, dilation, pad_value,
                          groups=conv_groups(x.shape, w.shape))
    if bias is not None:
        acc = acc + bias.to(torch.int32).reshape(
            (1, -1) + (1,) * (x.dim() - 2))
    return acc


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_grouped_int8").qconv_grouped_int8_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 27
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def input_align(x: torch.Tensor) -> int:
    """The alignment of the channels-last bytes the kernel reads for x
    [B, C, H, W] (or [B, C, D, H, W]): x's own where its channels-last view
    is contiguous, else that of the fresh copy the wrapper makes (16)."""
    xl = x.permute(0, *range(2, x.dim()), 1)
    return address_align(xl.data_ptr()) if xl.is_contiguous() else 16


def _count(y, form, flags):
    w_ = qconv_grouped_int8_requant
    w_.launches += 1
    w_.schedules[form] += 1
    count_forms(w_.forms, **flags)
    return y


def _launch(x, w, mult, bias, stride, padding, packed, dilation=None,
            pad_value: ZeroPoint = 0, y_zp: ZeroPoint = 0,
            out_dtype=torch.int8):
    """Check the operands and launch the kernel once on the card, in the
    form `grouped_plan` gives; out_dtype torch.int32 is the int32 output.
    Counts nothing. -> (y, the form, the QOperator forms it took)."""
    fn = "qconv_grouped_int8_requant"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {x.device}")
    if x.dim() not in (4, 5) or w.dim() != x.dim():
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a 2-D or 3-D conv")
    spatial = x.dim() - 2
    dilation = tuple(dilation or (1,) * spatial)
    if len(stride) != spatial or len(padding) != spatial \
            or len(dilation) != spatial:
        raise ValueError(f"{fn}: stride {stride}, padding {padding} and "
                         f"dilation {dilation} of a {spatial}-D conv")
    conv_groups(x.shape, w.shape)
    (B, C, D, H, W), (O, KD, KH, KW), (sd, sh, sw), pads, (dd, dh, dw) = \
        _as_3d(x.shape, w.shape, stride, padding, dilation)
    Cg = w.shape[1]
    if min(p for side in pads for p in side) < 0:
        raise ValueError(f"{fn}: negative padding {padding}")
    (pf, _), (pt, _), (pl, _) = pads
    OD, OH, OW = conv_out_size((D, H, W), (KD, KH, KW), (sd, sh, sw), pads,
                               (dd, dh, dw))
    if packed is None:
        raise ValueError(f"{fn}: on the card the weight must be pre-packed "
                         f"(pack_qconv_grouped_weight)")
    dev = x.device
    if x.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{fn}: x wants torch.int8 or torch.uint8, got "
                         f"{x.dtype}")
    pad_int, pad_dev = zero_point_arg(fn, pad_value, x.dtype, dev)
    check_operand(fn, "packed", packed, torch.int8, dev)
    if tuple(packed.shape) != (KD * KH * KW * Cg, -(-O // RUN) * RUN):
        raise ValueError(f"{fn}: packed weight {tuple(packed.shape)} is not "
                         f"pack_qconv_grouped_weight's layout of w "
                         f"{tuple(w.shape)}")
    int32 = out_dtype == torch.int32
    y_int, y_dev = 0, None
    if not int32:
        mult = mult_vector(mult, O)
        check_operand(fn, "mult", mult, torch.float32, dev, O)
        check_qtype(fn, out_dtype, 0)
        y_int, y_dev = zero_point_arg(fn, y_zp, out_dtype, dev)
    check_operand(fn, "bias", bias, torch.int32, dev, O)
    dims = (B, D, H, W, C, OD, OH, OW, O, Cg, KD, KH, KW, sd, sh, sw, pf, pt,
            pl, dd, dh, dw)
    if (min(dims[:16] + dims[19:]) <= 0 or max(dims) >= 2 ** 31
            or Cg * KD * KH * KW > MAX_TAPS // (
                2 if x.dtype == torch.uint8 else 1)
            or B * OD * OH * OW >= 2 ** 40):
        raise ValueError(f"{fn}: dims out of range {dims}")
    device_zp = pad_dev is not None or y_dev is not None
    plan = grouped_plan(x.shape, w.shape, stride, padding, input_align(x),
                        dilation, int32, device_zp)
    xl = x.permute(0, *range(2, x.dim()), 1)
    if not xl.is_contiguous():
        xl = xl.contiguous()
    tile = None
    if plan["form"] != "general":
        args = tile_args(plan)
        tile = (ctypes.c_int * len(args))(*args)
    y = torch.empty((B * OD * OH * OW, O), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib_fn()(
            xl.data_ptr(), packed.data_ptr(),
            mult.data_ptr() if mult is not None else None,
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            pad_dev.data_ptr() if pad_dev is not None else None,
            y_dev.data_ptr() if y_dev is not None else None,
            *dims, int(x.dtype == torch.uint8), pad_int, y_int,
            int(out_dtype == torch.uint8), int(int32),
            ctypes.addressof(tile) if tile is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch in the {plan['form']} form failed "
                           f"with cudaError {err}")
    padded = any(p for side in pads for p in side)
    flags = dict(uint8_x=x.dtype == torch.uint8,
                 zero_point_pad=padded and (pad_dev is not None
                                            or pad_int != 0),
                 y_zero_point=y_dev is not None or y_int != 0,
                 uint8_y=out_dtype == torch.uint8,
                 dilated=(dd, dh, dw) != (1, 1, 1), int32=int32,
                 device_zero_point=device_zp, **{"3d": spatial == 3})
    out_sizes = (OD, OH, OW)[3 - spatial:]
    return (y.view(B, *out_sizes, O).permute(0, spatial + 1,
                                             *range(1, spatial + 1)),
            plan["form"], flags)


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def _qconv_grouped_int8_requant_cpu(x, w, mult, bias, packed, stride,
                                    padding, dilation, pad_value, y_zp,
                                    out_dtype, zp_x=None, zp_y=None):
    check_qtype("qconv_grouped_int8_requant", out_dtype, y_zp)
    return qconv_grouped_int8_requant_plain(
        x, w, mult, bias, stride=stride, padding=nested_padding(padding),
        dilation=dilation, pad_value=_zp(pad_value, zp_x),
        y_zp=_zp(y_zp, zp_y), out_dtype=out_dtype)


def _qconv_grouped_int8_requant_cuda(x, w, mult, bias, packed, stride,
                                     padding, dilation, pad_value, y_zp,
                                     out_dtype, zp_x=None, zp_y=None):
    return _count(*_launch(x, w, mult, bias, stride, nested_padding(padding),
                           packed, dilation, _zp(pad_value, zp_x),
                           _zp(y_zp, zp_y), out_dtype))


def _qconv_grouped_int8_requant_fake(x, w, mult, bias, packed, stride,
                                     padding, dilation, pad_value, y_zp,
                                     out_dtype, zp_x=None, zp_y=None):
    return conv_fake(x, w, stride, padding, dilation, out_dtype)


_qconv_grouped_int8_requant_op = define(
    "qconv_grouped_int8_requant(Tensor x, Tensor w, Tensor mult, "
    f"Tensor? bias, Tensor? packed, {CONV_ARGS}, int y_zp, "
    f"ScalarType out_dtype, {ZP_ARGS}) -> Tensor",
    _qconv_grouped_int8_requant_cpu, _qconv_grouped_int8_requant_cuda,
    _qconv_grouped_int8_requant_fake)


def _qconv_grouped_int8_cpu(x, w, bias, packed, stride, padding, dilation,
                            pad_value, zp_x=None, zp_y=None):
    return qconv_grouped_int8_plain(x, w, bias, stride=stride,
                                    padding=nested_padding(padding),
                                    dilation=dilation,
                                    pad_value=_zp(pad_value, zp_x))


def _qconv_grouped_int8_cuda(x, w, bias, packed, stride, padding, dilation,
                             pad_value, zp_x=None, zp_y=None):
    return _count(*_launch(x, w, None, bias, stride, nested_padding(padding),
                           packed, dilation, _zp(pad_value, zp_x), 0,
                           torch.int32))


def _qconv_grouped_int8_fake(x, w, bias, packed, stride, padding, dilation,
                             pad_value, zp_x=None, zp_y=None):
    return conv_fake(x, w, stride, padding, dilation, torch.int32)


_qconv_grouped_int8_op = define(
    "qconv_grouped_int8(Tensor x, Tensor w, Tensor? bias, Tensor? packed, "
    f"{CONV_ARGS}, {ZP_ARGS}) -> Tensor",
    _qconv_grouped_int8_cpu, _qconv_grouped_int8_cuda,
    _qconv_grouped_int8_fake)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def qconv_grouped_int8_requant(x: torch.Tensor, w: torch.Tensor,
                               mult: torch.Tensor,
                               bias: Optional[torch.Tensor] = None, *,
                               stride: Optional[Sequence[int]] = None,
                               padding: Optional[Padding] = None,
                               dilation: Optional[Sequence[int]] = None,
                               pad_value: ZeroPoint = 0,
                               y_zp: ZeroPoint = 0,
                               out_dtype: torch.dtype = torch.int8,
                               packed: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Grouped QLinearConv: x int8 or uint8 [B,C,H,W], w int8
    [O,C/group,KH,KW] (3-D: [B,C,D,H,W], [O,C/group,KD,KH,KW]), mult f32
    [O] or scalar (x_s * w_s / y_s), bias int32 [O] or None, padding
    ((top, bottom), (left, right)) whose taps hold pad_value (x's zero
    point), y_zp in out_dtype (int8 or uint8) -> out_dtype [B,O,OH,OW]
    ([B,O,OD,OH,OW]); the zero points ints or one-element tensors on x's
    device.

    On the card `packed` must be `pack_qconv_grouped_weight(w)`, made once
    per weight, and the result is channels-last (see the module note); the
    kernel runs in the form `grouped_plan` gives, counted in `.schedules`
    (`oriet::qconv_grouped_int8_requant`)."""
    _check("qconv_grouped_int8_requant", x, w)
    stride, pads, dilation = _spatial_args(x, stride, padding, dilation)
    px, py, tx, ty = op_zero_points(pad_value, y_zp)
    return _qconv_grouped_int8_requant_op(
        x, w, as_mult(mult, x), bias, packed, stride, pads, dilation, px,
        py, out_dtype, tx, ty)


def qconv_grouped_int8(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: Optional[Sequence[int]] = None,
                       padding: Optional[Padding] = None,
                       dilation: Optional[Sequence[int]] = None,
                       pad_value: ZeroPoint = 0,
                       packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The exact int32 sums (+ bias) of a grouped conv -> int32 [B,O,OH,OW]
    ([B,O,OD,OH,OW]), on the general form; counted on
    `qconv_grouped_int8_requant` (`oriet::qconv_grouped_int8`)."""
    _check("qconv_grouped_int8", x, w)
    stride, pads, dilation = _spatial_args(x, stride, padding, dilation)
    px, _, tx, _ = op_zero_points(pad_value)
    return _qconv_grouped_int8_op(x, w, bias, packed, stride, pads,
                                  dilation, px, tx, None)


def _check(fn: str, x: torch.Tensor, w: torch.Tensor) -> None:
    check_device(fn, x)
    if x.dim() not in (4, 5) or w.dim() != x.dim():
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a 2-D or 3-D conv")
    conv_groups(x.shape, w.shape)


qconv_grouped_int8_requant.launches = 0
qconv_grouped_int8_requant.schedules = dict.fromkeys(FORMS, 0)
qconv_grouped_int8_requant.forms = dict.fromkeys(QFORMS, 0)
