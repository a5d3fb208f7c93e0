"""int8 convolution with a fused int32-bias + requant epilogue, or an exact
int32 output.

Hopper counterpart of the TPU kernel
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8_requant`
(Pallas body `_mm_requant_kernel`) and of its 1x1-conv wrapper
`qconv1x1_int8_requant`. The CUDA source is `csrc/qconv_int8.cu`: one
implicit-GEMM kernel for every group-1 QLinearConv and ConvInteger (1x1,
kxk with padding, strided, dilated; 2-D, and 3-D as x [B, C, D, H, W] by
w [O, C, KD, KH, KW], the depth a run-time size of the same kernel
instances) on the int8 tensor-core mainloop it
shares with the int8 GEMM (`csrc/int8_wgmma.cuh`), reading channels-last
int8 or uint8 activations, accumulating in int32 and leaving only the
output type in device memory. Its source note says what bounds it on the
H100 and what the design does about that.

ONNX Runtime's QOperator forms: a uint8 x goes to the kernel's uint8-A
instance (wgmma's .u8 A against the int8 weight, no shift), an int8 x to
its int8-A one; padding taps hold `pad_value` (the conv's x zero
point; the caller folds -zx * sum w into the bias); the requant epilogue
adds `y_zp` and saturates to int8 or uint8 (`out_dtype`). `qconv_int8`
returns the int32 sums (ConvInteger, and the QLinearConv whose weight has
a zero point), on the producer `conv_plan` gives the conv as for the
requant epilogue. `pad_value` and `y_zp` may
each be an int (known before the run) or a one-element integer tensor on
the operand's device (a zero point the graph computes at run time, e.g.
DynamicQuantizeLinear's): the kernel then reads it from device memory, so
a captured CUDA graph replays with each run's value.

Channels-last between convs: on the card the wrapper returns a
[B, O, OH, OW] tensor with `torch.channels_last` strides (3-D: [B, O, OD,
OH, OW] with `torch.channels_last_3d` strides), a view of the kernel's
[B*OH*OW, O] output, and reads a channels-last input without a copy. Any
other input is copied channels-last first (`channels_last_input`), with
its channels zero-padded to a multiple of 4 where they are not.

The stride-2 stems over C <= 4 channels (SqueezeNet's conv1, the stems of
ResNet-50, MobileNetV2 and R3D-18: `stem_s2d`) run as their space-to-depth
rewrite (`s2d_conv`): each 2 x 2 block of input pixels of 4 channels is one
pixel of 16, so a stride-2 k x k conv over C <= 4 is a stride-1
ceil(k/2) x ceil(k/2) conv over 16 channels (a 3-D stem keeps its depth),
which the staged-halo producer takes. The wrapper writes the rewritten
input with the layout kernel (`space_to_depth`, in place of
`channels_last_input`'s copy; its plain version `space_to_depth_plain`),
and the weight is packed in the rewritten layout (`pack_qconv_weight(w,
stride)`, `s2d_weight`). The plain versions compute the original conv.

`conv_plan` picks how the kernel fetches A and the tile, on either
epilogue (a stem: of its rewritten conv): "halo" (the staged-halo producer: a tile is 2 or 4 patches of 8
x 8 output pixels, stacked along depth in a 3-D conv and along rows in a
2-D one, whose input box with its halo lands by TMA once a tile, each
tap's A a wgmma descriptor into it; `halo_plan`) for a conv at unit stride
and dilation over C % 16 == 0 channels (C <= 128 or C % 128 == 0), a 2-D
one with a kernel larger than 1x1 by a fallback rule on its shape and
epilogue (`halo_2d_wins`): R3D-18's 13 stride-1 3x3x3s, SqueezeNet's
expands of fires 2-5 (and of fires 8-9 on the int32 epilogue), ResNet-50's
and UNet's stride-1 3x3s at 28 x 28 and over; otherwise (`conv_producer`)
"tma" for a 2-D 1x1, stride-1, unpadded conv with C % 16 == 0 (a plain
matrix product; on the int32 epilogue C >= 32), and "gather" (an implicit
im2col by cp.async) for every other.

Each epilogue is a `torch.library` operator, `oriet::qconv_int8_requant`
and `oriet::qconv_int8`: on the CPU the kernel's plain PyTorch versions
(`qconv_int8_requant_plain`, `qconv_int8_plain`: contiguous NCHW results,
the same values), on the card the launch, and a fake implementation that
gives the output's shape, dtype and strides (channels-last on the card,
contiguous on the CPU) from the operands, for torch.export. The schema
holds the padding as two ints per spatial dimension ((top, bottom, left,
right); 3-D: front and back first), and the zero points read from device
memory as two optional tensors. The wrappers keep their signatures, raise
for a tensor on neither device and call the op.
`qconv_int8_requant.launches` counts the kernel's launches through both
wrappers (in the card's implementation), `.producers` per A producer,
`.epilogues` per epilogue, `.forms` the launches of each QOperator form
and of the space-to-depth form (FORMS).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._ops import define
from .qmatmul_int8 import (EPILOGUES, MAX_STAGES, NUM_SMS, SMEM_LIMIT,
                           STAGE_K, Int8Tile, ZeroPoint, _requant, as_mult,
                           check_device, check_operand, check_qtype,
                           count_forms, int8_tile, mult_vector,
                           zero_point_arg)

__all__ = ["qconv_int8_requant", "qconv_int8_requant_plain", "qconv_int8",
           "qconv_int8_plain", "pack_qconv_weight", "conv_channels",
           "conv_producer", "conv_plan", "conv_out_hw", "conv_out_size",
           "channels_last_input", "PRODUCERS", "K_ALIGN", "FORMS",
           "schema_padding", "nested_padding", "conv_fake", "op_zero_points",
           "halo_plan", "halo_tile", "halo_2d_wins",
           "HALO_PLANES", "HALO_ROWS", "stem_s2d", "s2d_conv", "s2d_weight",
           "space_to_depth", "space_to_depth_plain", "conv_input",
           "S2D_CHANNELS"]

# packed weight rows are zero-padded to a multiple of 16 bytes: TMA reads
# rows whose stride is a multiple of 16
K_ALIGN = 16

# producer name -> the id the C entry point takes
PRODUCERS = {"tma": 0, "gather": 1, "halo": 2}

# the staged-halo producer (csrc/int8_wgmma.cuh, A_HALO): a tile's output
# box is 2 or 4 patches of HALO_ROWS x HALO_ROWS outputs (BM 128 or 256:
# one or two patches a consumer warpgroup), depth planes of a 3-D conv or
# 8-row bands of a 2-D one; the most channels of the input box staged at
# once; its tiles' BN
HALO_PLANES = (2, 4)
HALO_ROWS = 8
HALO_CHUNK = 128
HALO_BN = (64, 96, 128)

# the tiles whose kernel instances carry the gather's 3-D form (BM 128, BN
# 64 or 128: csrc/int8_wgmma.cuh, D3_TILE): a 3-D conv takes one of them
TILE_3D_BM = (128,)
TILE_3D_BN = (64, 128)

# the TMA producer's int32-epilogue instances (the 1x1 ConvInteger): BM 128
# only, the one BM csrc/qconv_int8.cu instances (its TMA_INT32_BM; a test
# holds the two equal)
TILE_TMA_INT32_BM = (128,)

# the forms `.forms` counts (a launch may be of several): a uint8 x, padding
# taps holding a non-zero pad value, an output zero point, a uint8 output, a
# dilation, the int32 epilogue, a zero point the kernel reads from device
# memory (computed at run time), a 3-D conv (the QOperator forms), and a
# stem run as its space-to-depth rewrite
FORMS = ("uint8_x", "zero_point_pad", "y_zero_point", "uint8_y", "dilated",
         "int32", "device_zero_point", "3d", "s2d")

# the channels of a stem's space-to-depth pixel: 2 x 2 pixels of 4
S2D_CHANNELS = 16

Padding = Sequence[Tuple[int, int]]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_channels(C: int) -> int:
    """The channels the kernel reads per pixel: C rounded up to a multiple
    of 4, the smallest run cp.async copies."""
    return _round_up(C, 4)


def conv_producer(C: int, KH: int, KW: int, stride: Sequence[int],
                  padding: Padding) -> str:
    """The A producer of a 2-D conv the staged-halo producer does not take
    (`conv_plan`, which keeps the int32 epilogue's C 16 on the gather):
    "tma" for a 1x1, stride-1, unpadded conv over C % 16 == 0 channels on
    either epilogue (A is the channels-last input as a
    [B*H*W, C] matrix, rows of a 16-byte multiple as TMA needs; a 1x1 has
    no padding tap, so the x zero point never enters A), "gather" for every
    other conv. C is the channels the kernel reads (`conv_channels`)."""
    if ((KH, KW) == (1, 1) and tuple(stride) == (1, 1)
            and not any(p for side in padding for p in side)
            and C % 16 == 0):
        return "tma"
    return "gather"


def conv_out_size(size: Sequence[int], kernel: Sequence[int],
                  stride: Sequence[int], padding: Padding,
                  dilation: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The output's spatial sizes ((OH, OW), or (OD, OH, OW)) of a conv
    over an input of spatial `size`."""
    dilation = dilation or (1,) * len(size)
    return tuple((n + lo + hi - (k - 1) * d - 1) // s + 1
                 for n, k, s, (lo, hi), d in zip(size, kernel, stride,
                                                 padding, dilation))


def conv_out_hw(H: int, W: int, KH: int, KW: int, stride: Sequence[int],
                padding: Padding, dilation: Sequence[int] = (1, 1)
                ) -> Tuple[int, int]:
    """The output's (OH, OW)."""
    return conv_out_size((H, W), (KH, KW), stride, padding, dilation)


def stem_s2d(C: int, kernel: Sequence[int], stride: Sequence[int],
             dilation: Optional[Sequence[int]] = None) -> bool:
    """Whether a group-1 conv over C channels runs as its space-to-depth
    rewrite (`s2d_conv`): the kernel reads C as 4 channels
    (`conv_channels`), a 2-D or 3-D conv at stride 2 in H and W (1 in
    depth) and dilation 1, its kernel wider than 1 in H and W. The stems
    of SqueezeNet 1.0 (7x7), ResNet-50 (7x7), MobileNetV2 (3x3) and
    R3D-18 (3x7x7)."""
    spatial = len(kernel)
    ones = (1,) * spatial
    return (spatial in (2, 3) and conv_channels(C) == 4
            and tuple(stride)[-2:] == (2, 2)
            and tuple(stride)[:-2] == ones[:-2]
            and tuple(dilation or ones) == ones and min(kernel[-2:]) > 1)


def s2d_conv(x_shape: Sequence[int], w_shape: Sequence[int],
             stride: Sequence[int], padding: Padding,
             dilation: Optional[Sequence[int]] = None) -> Optional[dict]:
    """None for a conv `stem_s2d` does not take; else the stride-1 conv
    over S2D_CHANNELS channels it runs as, with the same output:

      x [B, 16, (D,) Hs, Ws]: pixel (i, j) channel (2 sh + sw) * 4 + c is x
        channel c at row 2 i + sh - mh, column 2 j + sw - mw (the pad value
        where that lies outside x, or c >= C);
      w [O, 16, (KD,) ceil(KH/2), ceil(KW/2)]: tap (q, r) channel (2 sh +
        sw) * 4 + c is w's tap (2 q + sh, 2 r + sw) of channel c (0 past
        KH, KW or C: `s2d_weight`);
      stride 1, padding (top, bottom) = (ph // 2, what keeps OH) in rows
        (likewise in columns; depth as given), dilation 1.

    `lead` (mh, mw) is ph % 2 and pw % 2: an odd padding's last row
    (column) is one half of the rewritten input's first pixel row, which
    the layout writes with the pad value, so the kernel's own padding
    covers whole pixels, and the weight's layout does not depend on the
    padding. Hs and Ws stop at the last pixel row and column a window
    reads. Every x row the conv reads lands in a pixel; the halves of a
    pixel that lie past x are padding or meet zero weights."""
    kernel = tuple(w_shape[2:])
    if not stem_s2d(x_shape[1], kernel, stride, dilation):
        return None
    spatial = len(kernel)
    out = conv_out_size(x_shape[2:], kernel, stride, padding)
    lead, size, taps, pads = [], [], [], []
    for n, kk, (lo, _), o in zip(x_shape[-2:], kernel[-2:], padding[-2:],
                                 out[-2:]):
        k2 = -(-kk // 2)
        read = o - 1 + k2 - lo // 2  # pixel rows the windows reach
        ns = min(-(-(n + lo % 2) // 2), read)
        if ns < 1:
            return None
        lead.append(lo % 2)
        size.append(ns)
        taps.append(k2)
        pads.append((lo // 2, read - ns))
    mid = tuple(x_shape[2:-2])
    return {"x": (x_shape[0], S2D_CHANNELS, *mid, *size),
            "w": (w_shape[0], S2D_CHANNELS, *kernel[:-2], *taps),
            "stride": (1,) * spatial,
            "padding": (*(tuple(p) for p in padding[:-2]), *pads),
            "dilation": (1,) * spatial, "lead": tuple(lead)}


def s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """A stem's weight [O, C, (KD,) KH, KW] (C <= 4) as its space-to-depth
    rewrite's [O, 16, (KD,) ceil(KH/2), ceil(KW/2)] (`s2d_conv`)."""
    O, C = w.shape[:2]
    mid, (KH, KW) = tuple(w.shape[2:-2]), tuple(w.shape[-2:])
    KHs, KWs = -(-KH // 2), -(-KW // 2)
    wp = w.new_zeros((O, 4, *mid, 2 * KHs, 2 * KWs))
    wp[:, :C, ..., :KH, :KW] = w
    nd = len(mid)
    # [O, c, mid, q, sh, r, sw] -> [O, sh, sw, c, mid, q, r]
    wp = wp.reshape(O, 4, *mid, KHs, 2, KWs, 2).permute(
        0, 3 + nd, 5 + nd, 1, *range(2, 2 + nd), 2 + nd, 4 + nd)
    return wp.reshape(O, S2D_CHANNELS, *mid, KHs, KWs)


def halo_tile(planes: int, spatial: int) -> Tuple[int, int, int]:
    """The output box of a staged-halo tile of `planes` patches (planes,
    rows, columns): the patches stacked along depth in a 3-D conv, along
    rows in a 2-D one (depth 1)."""
    if spatial == 2:
        return 1, planes * HALO_ROWS, HALO_ROWS
    return planes, HALO_ROWS, HALO_ROWS


def halo_plan(C: int, N: int, kernel: Sequence[int], out: Sequence[int],
              B: int) -> dict:
    """The staged-halo producer's launch for a conv over C channels (C % 16
    == 0, C <= 128 or C % 128 == 0) to N outputs with a kernel of (KH, KW)
    or (KD, KH, KW) and B images of `out` = (OH, OW) or (OD, OH, OW)
    outputs, as the C entry point derives it: the tile's patches (4 where
    they cover the output's depth (3-D) or rows (2-D) with no more waste
    than 2 and the tile fits, so that each weight slice in shared memory
    serves two products and the weights leave L2 half as often; else 2)
    and its output box (`out_box`: planes, rows, columns; `halo_tile`), the
    input box (depth, rows, columns) with its halo, one 16-channel block of
    it `cb_pitch` bytes (a multiple of 128), the channels staged at once
    (`chunk`: C, or HALO_CHUNK) and the chunks, the 128-byte K slices of
    one chunk, the box's bytes (its 16-channel blocks, and where a chunk
    has an odd number of them a second copy of the first: the k32 step
    that spans two taps reads it), and the tile: BM 64 x patches, BN the
    narrowest of HALO_BN that holds N (64, 96: SqueezeNet's conv1, 128),
    64 where 128-wide tiles would leave half the SMs idle (at most
    NUM_SMS / 2 tiles: R3D-18's layer4), 128 for a wider N, the weights
    resident where their N tile's K slices fit beside two box slots (each
    block keeps one N tile: the kernel's grid is a multiple of N's tiles,
    and at most the tiles), else a ring of the most stages that fits; the patches that give resident
    weights are taken over 4 patches on a ring; and the block's shared
    memory (`halo_smem`). A 3-D conv of one output plane and a kernel one
    deep is a 2-D one, as the C entry point runs it."""
    if len(kernel) == 3 and kernel[0] == 1 and out[0] == 1:
        kernel, out = kernel[1:], out[1:]
    spatial = len(kernel)
    out3 = (1,) * (3 - spatial) + tuple(out)
    along = out3[0] if spatial == 3 else out3[1]
    unit = 1 if spatial == 3 else HALO_ROWS
    four = -(-along // (4 * unit)) * 4 <= -(-along // (2 * unit)) * 2
    plans = []
    for planes in (HALO_PLANES[::-1] if four else HALO_PLANES[:1]):
        m_tiles = B * math.prod(-(-o // t) for o, t in zip(
            out3, halo_tile(planes, spatial)))
        narrow = (N > HALO_BN[0]
                  and 2 * m_tiles * -(-N // HALO_BN[-1]) <= NUM_SMS)
        plans.append(_halo_plan(C, N, kernel, planes, narrow))
    fits = [p for p in plans if p["tile"].stages >= 2] or plans
    return next((p for p in fits if p["tile"].b_resident), fits[0])


def _halo_plan(C: int, N: int, kernel: Sequence[int], planes: int,
               narrow: bool = False) -> dict:
    taps = math.prod(kernel)
    tile = halo_tile(planes, len(kernel))
    kernel3 = (1,) * (3 - len(kernel)) + tuple(kernel)
    box = tuple(t + k - 1 for t, k in zip(tile, kernel3))
    cb_pitch = _round_up(math.prod(box) * 16, 128)
    chunk = min(C, HALO_CHUNK)
    n_chunks = C // chunk
    chunk_k = -(-taps * C // STAGE_K) if n_chunks == 1 else taps
    blocks = chunk // 16 + chunk // 16 % 2
    box_bytes = blocks * cb_pitch
    bn = HALO_BN[0] if narrow else next((b for b in HALO_BN if b >= N),
                                        HALO_BN[-1])
    num_k = -(-taps * C // STAGE_K)
    resident = (halo_smem(bn, 2, num_k, box_bytes, chunk_k) <= SMEM_LIMIT
                and -(-N // bn) <= NUM_SMS)
    if resident:
        stages = 2
    else:
        fit = [s for s in range(2, MAX_STAGES + 1)
               if halo_smem(bn, s, 0, box_bytes, chunk_k) <= SMEM_LIMIT]
        stages = fit[-1] if fit else 0
    return {"planes": planes, "box": box, "cb_pitch": cb_pitch,
            "chunk": chunk, "n_chunks": n_chunks, "chunk_k": chunk_k,
            "blocks": blocks, "box_bytes": box_bytes, "out_box": tile,
            "tile": Int8Tile(planes * 64, bn, stages, resident),
            "smem": halo_smem(bn, stages, num_k if resident else 0,
                              box_bytes, chunk_k)}


def halo_smem(bn: int, stages: int, resident_k: int, box_bytes: int,
              chunk_k: int) -> int:
    """The staged-halo producer's dynamic shared memory
    (csrc/int8_wgmma.cuh::halo_smem_bytes): 1024 bytes to align, the
    weights' ring of `stages` slots of bn x 128 bytes (or their
    `resident_k` slices), two input box slots, the requant staging tile
    (128 rows of bn + 16 bytes), the barriers, and the A descriptor of
    each k32 step of a chunk (4 a K slice, 8 bytes each)."""
    return (1024 + (resident_k or stages) * bn * STAGE_K + 2 * box_bytes
            + 128 * (bn + 16) + 16 * stages + 8 + 32 + 32 * chunk_k)


def _halo_ok(C: int, kernel, stride, dilation) -> bool:
    """Whether a conv is the staged-halo producer's: 2-D with more than one
    tap, or 3-D; unit stride and dilation, C % 16 == 0 with C <= 128 or C %
    128 == 0, and two box slots and a two-stage ring fit a block."""
    ones = (1,) * len(kernel)
    if (len(kernel) not in (2, 3) or tuple(stride) != ones
            or tuple(dilation or ones) != ones or C % 16
            or (C > HALO_CHUNK and C % HALO_CHUNK) or max(kernel) > 64
            or (len(kernel) == 2 and math.prod(kernel) == 1)):
        return False
    return _halo_plan(C, HALO_BN[-1], kernel, 2)["tile"].stages >= 2


def conv_plan(x_shape: Sequence[int], w_shape: Sequence[int],
              stride: Sequence[int], padding: Padding,
              dilation: Optional[Sequence[int]] = None,
              epilogue: str = "requant"):
    """(producer, tile) for a conv of x [B, C, H, W] by w [O, C, KH, KW]
    (or x [B, C, D, H, W] by w [O, C, KD, KH, KW]) on either epilogue: what
    the wrapper passes the kernel. A conv at unit stride and dilation over C
    % 16 == 0 channels (C <= 128 or C % 128 == 0), 3-D, or 2-D with a
    kernel larger than 1x1, takes the staged-halo producer (`halo_plan`'s
    tile), the 2-D one by the fallback rule (`halo_2d_wins`): only where
    its weights stay resident in shared memory, and N fits one 128-wide N
    tile or, on the int32 epilogue, fills whole ones. So SqueezeNet's
    expands of fires 2-5 (N 64 and 128), ResNet-50's stride-1 3x3s of
    layers 1 and 2 and UNet's six take it on either epilogue, and the
    expands of fires 8-9 (N 256) on the int32 one; the gather keeps
    conv1, the expands of fires 6-7 (N 192) on either epilogue and of
    fires 8-9 on the requant one, and ResNet-50's layers 3 and 4 (a ring
    of weights). Every other 3-D conv takes the gather producer, on a tile
    of TILE_3D_BM x TILE_3D_BN; every other 2-D conv `conv_producer`'s (the
    TMA producer's int32 instances on BM TILE_TMA_INT32_BM), except that on
    the int32 epilogue a 1x1 over C 16 (one 16-byte K slice) stays on the
    gather: SqueezeNet's expand1x1 of fires 2-3 measured 2-5% slower on
    TMA on the H100 (PERF.md §6, the 2-D staged-halo findings).

    A stem (`stem_s2d`) is planned as its space-to-depth rewrite
    (`s2d_conv`), a stride-1 conv over 16 channels by the same rules: the
    four stems of SqueezeNet, ResNet-50, MobileNetV2 (N 96, 64, 32: one
    resident N tile) and R3D-18 (3-D) on the staged-halo producer; a 2-D
    stem the fallback rule refuses (N > 128 on the requant epilogue) on
    the gather at 16-byte runs."""
    geo = s2d_conv(x_shape, w_shape, stride, padding, dilation)
    if geo is not None:
        x_shape, w_shape, stride, padding, dilation = (
            geo[f] for f in ("x", "w", "stride", "padding", "dilation"))
    B, C = x_shape[:2]
    O, kernel = w_shape[0], tuple(w_shape[2:])
    out = conv_out_size(x_shape[2:], kernel, stride, padding, dilation)
    Cp = conv_channels(C)
    M, K = B * math.prod(out), _round_up(math.prod(kernel) * Cp, K_ALIGN)
    if _halo_ok(Cp, kernel, stride, dilation):
        plan = halo_plan(Cp, O, kernel, out, B)
        if len(kernel) == 3 or halo_2d_wins(plan, O, epilogue):
            return "halo", plan["tile"]
    if len(kernel) != 2:  # the instances with the gather's 3-D form
        bn = next((b for b in TILE_3D_BN if b >= O), TILE_3D_BN[-1])
        return "gather", int8_tile(M, O, K, bms=TILE_3D_BM, bns=(bn,))
    producer = conv_producer(Cp, *kernel, stride, padding)
    if producer == "tma" and epilogue == "int32":
        if Cp == 16:  # measured slower on TMA than on the gather
            return "gather", int8_tile(M, O, K)
        return producer, int8_tile(M, O, K, bms=TILE_TMA_INT32_BM)
    return producer, int8_tile(M, O, K)


def halo_2d_wins(plan: dict, N: int, epilogue: str) -> bool:
    """The fallback rule of a 2-D conv to N outputs the staged-halo
    producer can take, on its shape and epilogue as measured on the H100
    against the gather (PERF.md §6, the 2-D staged-halo findings): it does
    where its weights stay resident and N fits one of its N tiles, or on
    the int32 epilogue N fills whole ones (N % 128 == 0: N 256 measured
    faster there; N 192, and N 256 on the requant epilogue in three of its
    four SqueezeNet shapes and forms, slower); the gather takes the rest."""
    return plan["tile"].b_resident and (
        N <= HALO_BN[-1] or (epilogue == "int32" and N % HALO_BN[-1] == 0))


def pack_qconv_weight(w: torch.Tensor,
                      stride: Optional[Sequence[int]] = None,
                      dilation: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """int8 [O, C, KH, KW] (or [O, C, KD, KH, KW]) -> int8 [O, Kp]: row o
    holds output channel o's taps in (kh, kw, c) order ((kd, kh, kw, c))
    over Cp = conv_channels(C) channels (zero past C), the order of K in
    the kernel's implicit GEMM, zero-padded to Kp = KH*KW*Cp (KD*KH*KW*Cp)
    rounded up to K_ALIGN. Given the conv's stride (and dilation), a
    stem's weight (`stem_s2d`) is packed as its space-to-depth rewrite's
    (`s2d_weight`: [O, 16, (KD,) ceil(KH/2), ceil(KW/2)]), which is what
    the kernel reads for that conv; without them, as the conv it is."""
    if w.dtype != torch.int8 or w.dim() not in (4, 5):
        raise ValueError(f"pack_qconv_weight: want int8 [O,C,KH,KW] or "
                         f"[O,C,KD,KH,KW], got {w.dtype} {tuple(w.shape)}")
    if stride is not None and stem_s2d(w.shape[1], tuple(w.shape[2:]),
                                       stride, dilation):
        w = s2d_weight(w)
    O, C = w.shape[:2]
    kernel = tuple(w.shape[2:])
    Cp = conv_channels(C)
    taps = torch.zeros((O, *kernel, Cp), dtype=torch.int8, device=w.device)
    taps[..., :C] = w.permute(0, *range(2, w.dim()), 1)
    K = math.prod(kernel) * Cp
    out = torch.zeros((O, _round_up(K, K_ALIGN)), dtype=torch.int8,
                      device=w.device)
    out[:, :K] = taps.reshape(O, K)
    return out


# --------------------------------------------------------------------------
# plain versions: exact int32 accumulation, then the fp32 epilogue
# --------------------------------------------------------------------------
def conv_sums_plain(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                    padding: Padding, dilation: Optional[Sequence[int]] = None,
                    pad_value: ZeroPoint = 0, groups: int = 1) -> torch.Tensor:
    """sum over each window of x (int8 or uint8 [B,C,H,W] or [B,C,D,H,W],
    padded with pad_value) times w (int8 [O,C/groups,KH,KW] or
    [O,C/groups,KD,KH,KW]) -> int32 [B,O,OH,OW] ([B,O,OD,OH,OW]). The sums
    are taken in float64, where every partial sum of 8-bit products
    (|.| < 256*128*K) is an exact integer, so the result equals the
    kernels'. A tensor pad_value (one element, on x's device) is taken out
    of x before zero padding and its sum with each output channel's weights
    added back: the same exact sums, with no host read."""
    spatial = x.dim() - 2
    padding = padding or ((0, 0),) * spatial
    flat = [p for lo_hi in reversed(list(padding)) for p in lo_hi]
    xd, wd = x.to(torch.float64), w.to(torch.float64)
    pv = None
    if isinstance(pad_value, torch.Tensor):
        pv = pad_value.to(torch.float64).reshape(())
        xd, pad_value = xd - pv, 0
    xd = F.pad(xd, flat, value=float(pad_value))
    conv = F.conv3d if spatial == 3 else F.conv2d
    # cuDNN may pick an inexact (FFT) algorithm; PyTorch's own conv is a
    # float64 GEMM, exact here
    with torch.backends.cudnn.flags(enabled=False):
        acc = conv(xd, wd, stride=tuple(stride or (1,) * spatial),
                   dilation=tuple(dilation or (1,) * spatial), groups=groups)
    if pv is not None:
        acc = acc + pv * wd.sum(dim=tuple(range(1, w.dim()))).reshape(
            (1, -1) + (1,) * spatial)
    return acc.to(torch.int32)


def qconv_int8_plain(x: torch.Tensor, w: torch.Tensor, *,
                     stride: Optional[Sequence[int]] = None,
                     padding: Optional[Padding] = None,
                     dilation: Optional[Sequence[int]] = None,
                     pad_value: ZeroPoint = 0) -> torch.Tensor:
    """The int32 epilogue's function: x int8 or uint8 [B,C,H,W], w int8
    [O,C,KH,KW] (3-D: [B,C,D,H,W], [O,C,KD,KH,KW]) -> int32 [B,O,OH,OW]
    ([B,O,OD,OH,OW]), padding taps holding pad_value."""
    return conv_sums_plain(x, w, stride, padding, dilation, pad_value)


def qconv_int8_requant_plain(x: torch.Tensor, w: torch.Tensor,
                             mult: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             stride: Optional[Sequence[int]] = None,
                             padding: Optional[Padding] = None,
                             dilation: Optional[Sequence[int]] = None,
                             pad_value: ZeroPoint = 0, y_zp: ZeroPoint = 0,
                             out_dtype: torch.dtype = torch.int8
                             ) -> torch.Tensor:
    """x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW], mult f32 [O] or
    scalar, bias int32 [O] -> out_dtype [B,O,OH,OW] (3-D likewise): the
    exact sums (padding taps holding pad_value) + bias, * mult, rounded half
    to even, + y_zp, saturated."""
    acc = conv_sums_plain(x, w, stride, padding, dilation, pad_value)
    return _requant(acc, mult, bias, channel_dim=1, y_zp=y_zp,
                    out_dtype=out_dtype)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_int8").qconv_int8_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 32
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def channels_last_input(x: torch.Tensor) -> torch.Tensor:
    """x int8 or uint8 [B, C, H, W] (or [B, C, D, H, W]) as the kernel
    reads it: [B, H, W, Cp] ([B, D, H, W, Cp]) contiguous, Cp =
    conv_channels(C), 16-byte aligned. A channels-last (channels_last_3d),
    aligned x with Cp == C is returned as a view; any other is copied."""
    C = x.shape[1]
    Cp = conv_channels(C)
    xl = x.permute(0, *range(2, x.dim()), 1)
    if Cp == C:
        if xl.is_contiguous() and xl.data_ptr() % 16 == 0:
            return xl
        return xl.contiguous()  # a new allocation: aligned
    out = torch.zeros((*xl.shape[:-1], Cp), dtype=x.dtype, device=x.device)
    out[..., :C] = xl
    return out


def _pad_fill(x: torch.Tensor, pad_value: ZeroPoint):
    """The pad value as x's type takes it: an int, or a one-element tensor
    on x's device saturated to x's range (as the kernels saturate it)."""
    if not isinstance(pad_value, torch.Tensor):
        return int(pad_value)
    lo = 0 if x.dtype == torch.uint8 else -128
    return pad_value.reshape(()).to(torch.int32).clamp(lo, lo + 255).to(
        x.dtype)


def space_to_depth_plain(x: torch.Tensor, geo: dict,
                         pad_value: ZeroPoint = 0) -> torch.Tensor:
    """The plain version of the layout kernel: a stem's x int8 or uint8
    [B, C, (D,) H, W] (C <= 4; any strides) as its space-to-depth rewrite
    (`s2d_conv`'s `geo`) [B, (D,) Hs, Ws, 16] contiguous: x padded with
    pad_value to 4 channels, mh rows and mw columns before and up to 2 Hs
    rows and 2 Ws columns, then each 2 x 2 pixel block's channels stacked
    in (row, column, channel) order."""
    B, C = x.shape[:2]
    mid, (H, W) = tuple(x.shape[2:-2]), tuple(x.shape[-2:])
    (mh, mw), (Hs, Ws) = geo["lead"], geo["x"][-2:]
    buf = torch.empty((B, 4, *mid, 2 * Hs, 2 * Ws), dtype=x.dtype,
                      device=x.device)
    buf.fill_(_pad_fill(x, pad_value))
    h, w = min(H, 2 * Hs - mh), min(W, 2 * Ws - mw)
    buf[:, :C, ..., mh:mh + h, mw:mw + w] = x[..., :h, :w]
    nd = len(mid)
    # [B, c, mid, i, sh, j, sw] -> [B, mid, i, j, sh, sw, c]
    buf = buf.reshape(B, 4, *mid, Hs, 2, Ws, 2).permute(
        0, *range(2, 2 + nd), 2 + nd, 4 + nd, 3 + nd, 5 + nd, 1)
    return buf.reshape(B, *mid, Hs, Ws, S2D_CHANNELS)


def _s2d_fn():
    fn = _build.load("qconv_int8").qconv_s2d_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def space_to_depth(x: torch.Tensor, geo: dict,
                   pad_value: ZeroPoint = 0) -> torch.Tensor:
    """A stem's x as its space-to-depth rewrite reads it (the layout of
    `space_to_depth_plain`, 16-byte aligned): on the card the layout
    kernel (csrc/qconv_int8.cu, qconv_s2d_launch: one pass, x NCHW or
    channels-last, a pad value in device memory read there), on the CPU
    the plain version."""
    if x.device.type == "cpu":
        return space_to_depth_plain(x, geo, pad_value)
    if x.device.type != "cuda":
        raise ValueError(f"space_to_depth: no kernel for {x.device}")
    if x.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"space_to_depth: x wants torch.int8 or "
                         f"torch.uint8, got {x.dtype}")
    pad_int, pad_dev = zero_point_arg("space_to_depth", pad_value, x.dtype,
                                      x.device)
    x5 = x if x.dim() == 5 else x.unsqueeze(2)
    B, C, D, H, W = x5.shape
    (mh, mw), (Hs, Ws) = geo["lead"], geo["x"][-2:]
    y = torch.empty((B, *x.shape[2:-2], Hs, Ws, S2D_CHANNELS),
                    dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _s2d_fn()(
            x5.data_ptr(), y.data_ptr(),
            pad_dev.data_ptr() if pad_dev is not None else None,
            B, C, D, H, W, *x5.stride(), Hs, Ws, mh, mw,
            int(x.dtype == torch.uint8), pad_int & 0xFF,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"space_to_depth: launch failed with cudaError "
                           f"{err}")
    return y


def conv_input(x: torch.Tensor, w_shape: Sequence[int],
               stride: Sequence[int], padding: Padding,
               dilation: Optional[Sequence[int]] = None,
               pad_value: ZeroPoint = 0) -> torch.Tensor:
    """The tensor the kernel reads for a conv of x by a weight of
    `w_shape`: a stem's space-to-depth rewrite (`space_to_depth`), else
    `channels_last_input(x)`."""
    geo = s2d_conv(x.shape, w_shape, stride, padding, dilation)
    if geo is None:
        return channels_last_input(x)
    return space_to_depth(x, geo, pad_value)


def _as_3d(x_shape, w_shape, stride, padding, dilation):
    """A 2-D or 3-D conv's sizes as the kernel takes them, 2-D as depth 1:
    ((B, C, D, H, W), (O, KD, KH, KW), strides, padding pairs and
    dilations over (depth, height, width))."""
    lead = 5 - len(x_shape)
    return ((*x_shape[:2], *(1,) * lead, *x_shape[2:]),
            (w_shape[0], *(1,) * lead, *w_shape[2:]),
            (*(1,) * lead, *(int(s) for s in stride)),
            (*((0, 0),) * lead, *((int(lo), int(hi)) for lo, hi in padding)),
            (*(1,) * lead, *(int(d) for d in dilation)))


def _launch(fn: str, x, w, packed, epilogue: str, mult, bias, stride,
            padding, dilation, pad_value: ZeroPoint, y_zp: ZeroPoint = 0,
            out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Check the operands, launch one epilogue of the kernel on the card on
    the producer and tile `conv_plan` gives, and count the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {x.device}")
    if x.dim() not in (4, 5) or w.dim() != x.dim() or x.shape[1] != w.shape[1]:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a group-1 2-D or 3-D conv")
    spatial = x.dim() - 2
    if len(stride) != spatial or len(padding) != spatial \
            or len(dilation) != spatial:
        raise ValueError(f"{fn}: stride {stride}, padding {padding} and "
                         f"dilation {dilation} of a {spatial}-D conv")
    if min(p for side in padding for p in side) < 0:
        raise ValueError(f"{fn}: negative padding {padding}")
    # a stem runs as its space-to-depth rewrite: the sizes the kernel takes
    geo = s2d_conv(x.shape, w.shape, stride, padding, dilation)
    sizes = ((x.shape, w.shape, stride, padding, dilation) if geo is None
             else [geo[f] for f in ("x", "w", "stride", "padding",
                                    "dilation")])
    (B, C, D, H, W), (O, KD, KH, KW), (sd, sh, sw), pads, (dd, dh, dw) = \
        _as_3d(*sizes)
    (pf, _), (pt, _), (pl, _) = pads
    OD, OH, OW = conv_out_size((D, H, W), (KD, KH, KW), (sd, sh, sw), pads,
                               (dd, dh, dw))
    if packed is None:
        raise ValueError(f"{fn}: on the card the weight must be pre-packed "
                         f"(pack_qconv_weight)")
    dev = x.device
    if x.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{fn}: x wants torch.int8 or torch.uint8, got "
                         f"{x.dtype}")
    pad_int, pad_dev = zero_point_arg(fn, pad_value, x.dtype, dev)
    check_operand(fn, "packed", packed, torch.int8, dev)
    Cp = conv_channels(C)
    Kp = _round_up(KD * KH * KW * Cp, K_ALIGN)
    if tuple(packed.shape) != (O, Kp):
        raise ValueError(f"{fn}: packed weight {tuple(packed.shape)} is not "
                         f"pack_qconv_weight's layout of w {tuple(w.shape)}"
                         f" at stride {tuple(stride)}")
    y_int, y_dev = 0, None
    if epilogue == "requant":
        mult = mult_vector(mult, O)
        check_operand(fn, "mult", mult, torch.float32, dev, O)
        check_operand(fn, "bias", bias, torch.int32, dev, O)
        check_qtype(fn, out_dtype, 0)
        y_int, y_dev = zero_point_arg(fn, y_zp, out_dtype, dev)
    dims = (B, D, H, W, Cp, OD, OH, OW, O, KD, KH, KW, sd, sh, sw, pf, pt, pl,
            dd, dh, dw, Kp)
    M = B * OD * OH * OW
    if (min(dims[:15] + dims[18:]) <= 0 or min(dims[15:18]) < 0
            or max(dims) >= 2 ** 31 or M >= 2 ** 31):
        raise ValueError(f"{fn}: dims out of range {dims}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{fn}: packed weight not 16-byte aligned")
    producer, tile = conv_plan(x.shape, w.shape, stride, padding, dilation,
                               epilogue)
    x_cl = conv_input(x, w.shape, stride, padding, dilation, pad_value)
    y = torch.empty((M, O), device=dev, dtype=(
        torch.int32 if epilogue == "int32" else out_dtype))
    with torch.cuda.device(dev):
        err = _lib_fn()(
            x_cl.data_ptr(), packed.data_ptr(),
            mult.data_ptr() if mult is not None else None,
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            pad_dev.data_ptr() if pad_dev is not None else None,
            y_dev.data_ptr() if y_dev is not None else None,
            *dims, PRODUCERS[producer], EPILOGUES[epilogue],
            int(x.dtype == torch.uint8), pad_int & 0xFF, y_int,
            int(out_dtype == torch.uint8), *tile,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch with the {producer} producer and "
                           f"the {epilogue} epilogue on {tile} failed with "
                           f"cudaError {err}")
    w_ = qconv_int8_requant
    w_.launches += 1
    w_.producers[producer] += 1
    w_.epilogues[epilogue] += 1
    padded = any(p for side in padding for p in side)
    count_forms(w_.forms, uint8_x=x.dtype == torch.uint8,
                zero_point_pad=padded and (pad_dev is not None or pad_int != 0),
                y_zero_point=y_dev is not None or y_int != 0,
                uint8_y=epilogue == "requant" and out_dtype == torch.uint8,
                dilated=(dd, dh, dw) != (1, 1, 1), int32=epilogue == "int32",
                device_zero_point=pad_dev is not None or y_dev is not None,
                s2d=geo is not None, **{"3d": spatial == 3})
    out_sizes = (OD, OH, OW)[3 - spatial:]
    return y.view(B, *out_sizes, O).permute(0, spatial + 1,
                                            *range(1, spatial + 1))


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def schema_padding(padding: Padding) -> list:
    """((top, bottom), (left, right)) (3-D: ((front, back), (top, bottom),
    (left, right))) as the ops' flat ints."""
    return [int(p) for side in padding for p in side]


def nested_padding(pads: Sequence[int]) -> Padding:
    """The ops' flat ints back as ((top, bottom), (left, right)) (3-D: with
    (front, back) first)."""
    return tuple((pads[i], pads[i + 1]) for i in range(0, len(pads), 2))


def conv_fake(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              pads: Sequence[int], dilation: Sequence[int],
              dtype: torch.dtype) -> torch.Tensor:
    """The result the conv ops give, as an empty tensor: [B, O, OH, OW]
    ([B, O, OD, OH, OW]), on the card a channels-last view of a
    [B*OH*OW, O] matrix (what the kernels write), on the CPU contiguous
    (what the plain versions give)."""
    B, O, spatial = x.shape[0], w.shape[0], x.dim() - 2
    out = conv_out_size(x.shape[2:], w.shape[2:], stride,
                        nested_padding(pads), dilation)
    if x.device.type == "cuda":
        return x.new_empty((B * math.prod(out), O), dtype=dtype).view(
            B, *out, O).permute(0, spatial + 1, *range(1, spatial + 1))
    return x.new_empty((B, O, *out), dtype=dtype)


# the schema of the convs' ops, after the name: padding is (top, bottom,
# left, right), with (front, back) first for a 3-D conv
CONV_ARGS = ("int[] stride, int[] padding, int[] dilation, int pad_value")
# the zero points in device memory, after the rest: where given, the kernel
# reads x's (the pad value) and y's from them in place of the ints
ZP_ARGS = "Tensor? zp_x=None, Tensor? zp_y=None"


def _zp(value: int, t: Optional[torch.Tensor]) -> ZeroPoint:
    """The ops' zero point: the tensor where given, else the int."""
    return t if t is not None else value


def _qconv_int8_requant_cpu(x, w, mult, bias, packed, stride, padding,
                            dilation, pad_value, y_zp, out_dtype, zp_x=None,
                            zp_y=None):
    check_qtype("qconv_int8_requant", out_dtype, y_zp)
    return qconv_int8_requant_plain(
        x, w, mult, bias, stride=stride, padding=nested_padding(padding),
        dilation=dilation, pad_value=_zp(pad_value, zp_x),
        y_zp=_zp(y_zp, zp_y), out_dtype=out_dtype)


def _qconv_int8_requant_cuda(x, w, mult, bias, packed, stride, padding,
                             dilation, pad_value, y_zp, out_dtype, zp_x=None,
                             zp_y=None):
    return _launch("qconv_int8_requant", x, w, packed, "requant", mult,
                   bias, stride, nested_padding(padding), dilation,
                   _zp(pad_value, zp_x), _zp(y_zp, zp_y), out_dtype)


def _qconv_int8_requant_fake(x, w, mult, bias, packed, stride, padding,
                             dilation, pad_value, y_zp, out_dtype, zp_x=None,
                             zp_y=None):
    return conv_fake(x, w, stride, padding, dilation, out_dtype)


_qconv_int8_requant_op = define(
    "qconv_int8_requant(Tensor x, Tensor w, Tensor mult, Tensor? bias, "
    f"Tensor? packed, {CONV_ARGS}, int y_zp, ScalarType out_dtype, "
    f"{ZP_ARGS}) -> Tensor",
    _qconv_int8_requant_cpu, _qconv_int8_requant_cuda,
    _qconv_int8_requant_fake)


def _qconv_int8_cpu(x, w, packed, stride, padding, dilation, pad_value,
                    zp_x=None, zp_y=None):
    return qconv_int8_plain(x, w, stride=stride,
                            padding=nested_padding(padding),
                            dilation=dilation,
                            pad_value=_zp(pad_value, zp_x))


def _qconv_int8_cuda(x, w, packed, stride, padding, dilation, pad_value,
                     zp_x=None, zp_y=None):
    return _launch("qconv_int8", x, w, packed, "int32", None, None, stride,
                   nested_padding(padding), dilation, _zp(pad_value, zp_x))


def _qconv_int8_fake(x, w, packed, stride, padding, dilation, pad_value,
                     zp_x=None, zp_y=None):
    return conv_fake(x, w, stride, padding, dilation, torch.int32)


_qconv_int8_op = define(
    f"qconv_int8(Tensor x, Tensor w, Tensor? packed, {CONV_ARGS}, "
    f"{ZP_ARGS}) -> Tensor",
    _qconv_int8_cpu, _qconv_int8_cuda, _qconv_int8_fake)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def _check_conv(fn: str, x: torch.Tensor, w: torch.Tensor) -> None:
    check_device(fn, x)
    if x.dim() not in (4, 5) or w.dim() != x.dim():
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a 2-D or 3-D conv")


def op_zero_points(pad_value: ZeroPoint, y_zp: ZeroPoint = 0):
    """The conv ops' zero-point arguments: (pad_value, y_zp) as ints, and
    (zp_x, zp_y) the tensors among them (None for an int)."""
    def split(z):
        return (0, z) if isinstance(z, torch.Tensor) else (int(z), None)

    (px, tx), (py, ty) = split(pad_value), split(y_zp)
    return px, py, tx, ty


def _spatial_args(x: torch.Tensor, stride, padding, dilation):
    """stride, padding and dilation as the ops' int lists: ones, zeros and
    ones over x's spatial dims where not given."""
    spatial = x.dim() - 2
    return ([int(s) for s in (stride or (1,) * spatial)],
            schema_padding(padding or ((0, 0),) * spatial),
            [int(d) for d in (dilation or (1,) * spatial)])


def qconv_int8_requant(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: Optional[Sequence[int]] = None,
                       padding: Optional[Padding] = None,
                       dilation: Optional[Sequence[int]] = None,
                       pad_value: ZeroPoint = 0, y_zp: ZeroPoint = 0,
                       out_dtype: torch.dtype = torch.int8,
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group-1 QLinearConv: x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW]
    (3-D: [B,C,D,H,W], [O,C,KD,KH,KW], stride, padding and dilation of
    three), mult f32 [O] or scalar (x_s * w_s / y_s), bias int32 [O] or
    None, padding ((top, bottom), (left, right)) whose taps hold pad_value
    (x's zero point), y_zp in out_dtype (int8 or uint8) -> out_dtype
    [B,O,OH,OW] ([B,O,OD,OH,OW]) (`oriet::qconv_int8_requant`). pad_value
    and y_zp: ints, or one-element tensors on x's device that the kernel
    reads in the run.

    On the card `packed` must be `pack_qconv_weight(w)`, made once per
    weight, and the result is channels-last (see the module note)."""
    _check_conv("qconv_int8_requant", x, w)
    stride, pads, dilation = _spatial_args(x, stride, padding, dilation)
    px, py, tx, ty = op_zero_points(pad_value, y_zp)
    return _qconv_int8_requant_op(
        x, w, as_mult(mult, x), bias, packed, stride, pads, dilation, px,
        py, out_dtype, tx, ty)


def qconv_int8(x: torch.Tensor, w: torch.Tensor, *,
               stride: Optional[Sequence[int]] = None,
               padding: Optional[Padding] = None,
               dilation: Optional[Sequence[int]] = None,
               pad_value: ZeroPoint = 0,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int32 epilogue: x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW]
    (or 3-D) -> the exact int32 sums [B,O,OH,OW] ([B,O,OD,OH,OW]), padding
    taps holding pad_value (an int, or a one-element tensor on x's device)
    (`oriet::qconv_int8`). On the card `packed` is `pack_qconv_weight(w)`;
    counted on `qconv_int8_requant` (the same kernel, int32 epilogue)."""
    _check_conv("qconv_int8", x, w)
    stride, pads, dilation = _spatial_args(x, stride, padding, dilation)
    px, _, tx, _ = op_zero_points(pad_value)
    return _qconv_int8_op(x, w, packed, stride, pads, dilation, px, tx,
                          None)


qconv_int8_requant.launches = 0
qconv_int8_requant.producers = dict.fromkeys(PRODUCERS, 0)
qconv_int8_requant.epilogues = dict.fromkeys(EPILOGUES, 0)
qconv_int8_requant.forms = dict.fromkeys(FORMS, 0)
