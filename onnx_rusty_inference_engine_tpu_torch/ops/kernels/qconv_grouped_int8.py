"""int8 grouped convolution (group > 1: MobileNetV2's depthwise convs) with
a fused int32-bias + requant epilogue.

No Pallas kernel stands behind it: for group > 1 the JAX package's
QLinearConv emitter runs XLA's grouped conv with int32 accumulation, then
the bias add and `_requant`
(onnx_rusty_inference_engine_tpu/ops/quantized.py:126-146). On the card no
library call takes an int8 grouped conv, and cuDNN in f32 may pick a
rounding (Winograd, FFT) algorithm, so the port computes it in a kernel of
its own: `csrc/qconv_grouped_int8.cu`, a direct convolution over
channels-last int8, one thread per output pixel and run of 4 output
channels, int32 sums, the requant of `_requant` in registers, a
channels-last int8 output. Its source note says what bounds it on the
H100.

On the card the wrapper reads a channels-last input as it is (any other is
copied channels-last) and returns a [B, O, OH, OW] view with
`torch.channels_last` strides of the kernel's [B*OH*OW, O] output, as
`qconv_int8_requant` does, so the ops between convs keep the layout.
`grouped_mode` picks the kernel's form from the shapes: "depthwise" (one
input channel per output channel, C % 4 == 0: char4 loads) or "general"
(any other group > 1).

The wrapper takes a tensor on the CPU to the kernel's plain PyTorch
version (`qconv_grouped_int8_requant_plain`, exact float64 sums through
`F.conv2d(groups=...)`, then `_requant`), and launches the kernel for a
tensor on the card, or raises. `qconv_grouped_int8_requant.launches`
counts the kernel's launches, `.schedules` counts them per form.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .qmatmul_int8 import _requant, check_operand, mult_vector

__all__ = ["qconv_grouped_int8_requant", "qconv_grouped_int8_requant_plain",
           "pack_qconv_grouped_weight", "grouped_mode", "conv_groups",
           "MODES", "RUN"]

# output channels per thread; packed weight columns are padded to it
RUN = 4

# form name -> the mode id the C entry point takes
MODES = {"depthwise": 0, "general": 1}

# the largest taps per output (Cg * KH * KW) whose int32 sums cannot
# overflow: every product is at most 128 * 128 in magnitude
MAX_TAPS = (2 ** 31 - 1) // (128 * 128)

Padding = Sequence[Tuple[int, int]]


def conv_groups(x_shape: Sequence[int], w_shape: Sequence[int]) -> int:
    """The group count of a conv of x [B, C, H, W] by w [O, Cg, KH, KW]:
    C / Cg; raises where the channels do not split into groups."""
    C, (O, Cg) = x_shape[1], w_shape[:2]
    if Cg <= 0 or C % Cg or O % (C // Cg):
        raise ValueError(f"x {tuple(x_shape)} and w {tuple(w_shape)} are "
                         f"not a grouped conv")
    return C // Cg


def grouped_mode(C: int, Cg: int, O: int, group: int,
                 x_aligned: bool = True) -> str:
    """The kernel's form for a conv of C input channels in `group` groups
    of Cg, O output channels: "depthwise" for one input channel per output
    channel with C % 4 == 0 and x 4-byte aligned, "general" otherwise."""
    if Cg == 1 and O == group and C % 4 == 0 and x_aligned:
        return "depthwise"
    return "general"


def pack_qconv_grouped_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 [O, Cg, KH, KW] -> int8 [KH*KW*Cg, Op]: row (kh, kw, c) holds
    every output channel's weight at that tap, Op = O rounded up to RUN,
    zero past O."""
    if w.dtype != torch.int8 or w.dim() != 4:
        raise ValueError(f"pack_qconv_grouped_weight: want int8 "
                         f"[O,Cg,KH,KW], got {w.dtype} {tuple(w.shape)}")
    O, Cg, KH, KW = w.shape
    out = torch.zeros((KH * KW * Cg, -(-O // RUN) * RUN), dtype=torch.int8,
                      device=w.device)
    out[:, :O] = w.permute(2, 3, 1, 0).reshape(KH * KW * Cg, O)
    return out


def _out_hw(H: int, W: int, KH: int, KW: int, stride: Sequence[int],
            padding: Padding) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = padding
    return ((H + pt + pb - KH) // stride[0] + 1,
            (W + pl + pr - KW) // stride[1] + 1)


# --------------------------------------------------------------------------
# plain version: exact sums, then the fp32 epilogue
# --------------------------------------------------------------------------
def qconv_grouped_int8_requant_plain(x: torch.Tensor, w: torch.Tensor,
                                     mult: torch.Tensor,
                                     bias: Optional[torch.Tensor] = None, *,
                                     stride: Sequence[int] = (1, 1),
                                     padding: Padding = ((0, 0), (0, 0))
                                     ) -> torch.Tensor:
    """x int8 [B,C,H,W], w int8 [O,C/group,KH,KW], mult f32 [O] or scalar,
    bias int32 [O] -> int8 [B,O,OH,OW]. The sums are taken in float64,
    where every partial sum of int8 products is an exact integer, so the
    int32 result equals the kernel's whatever the order."""
    group = conv_groups(x.shape, w.shape)
    (pt, pb), (pl, pr) = padding
    xd = F.pad(x.to(torch.float64), (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, w.to(torch.float64), stride=tuple(stride),
                       groups=group)
    return _requant(acc.to(torch.int32), mult, bias, channel_dim=1)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_grouped_int8").qconv_grouped_int8_requant_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def qconv_grouped_int8_requant(x: torch.Tensor, w: torch.Tensor,
                               mult: torch.Tensor,
                               bias: Optional[torch.Tensor] = None, *,
                               stride: Sequence[int] = (1, 1),
                               padding: Padding = ((0, 0), (0, 0)),
                               packed: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Symmetric grouped int8 QLinearConv: x int8 [B,C,H,W], w int8
    [O,C/group,KH,KW], mult f32 [O] or scalar (x_s * w_s / y_s), bias int32
    [O] or None, padding ((top, bottom), (left, right)) -> int8
    [B,O,OH,OW].

    On the card `packed` must be `pack_qconv_grouped_weight(w)`, made once
    per weight, and the result is channels-last (see the module note)."""
    if x.device.type == "cpu":
        return qconv_grouped_int8_requant_plain(x, w, mult, bias,
                                                stride=stride,
                                                padding=padding)
    fn = "qconv_grouped_int8_requant"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {x.device}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a 2-D conv")
    group = conv_groups(x.shape, w.shape)
    B, C, H, W = x.shape
    O, Cg, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"{fn}: negative padding {padding}")
    sh, sw = (int(s) for s in stride)
    OH, OW = _out_hw(H, W, KH, KW, (sh, sw), padding)
    if packed is None:
        raise ValueError(f"{fn}: on the card the weight must be pre-packed "
                         f"(pack_qconv_grouped_weight)")
    dev = x.device
    if x.dtype != torch.int8:
        raise ValueError(f"{fn}: x wants torch.int8, got {x.dtype}")
    check_operand(fn, "packed", packed, torch.int8, dev)
    if tuple(packed.shape) != (KH * KW * Cg, -(-O // RUN) * RUN):
        raise ValueError(f"{fn}: packed weight {tuple(packed.shape)} is not "
                         f"pack_qconv_grouped_weight's layout of w "
                         f"{tuple(w.shape)}")
    mult = mult_vector(mult, O)
    check_operand(fn, "mult", mult, torch.float32, dev, O)
    check_operand(fn, "bias", bias, torch.int32, dev, O)
    dims = (B, H, W, C, OH, OW, O, Cg, KH, KW, sh, sw, pt, pl)
    if (min(dims[:12]) <= 0 or max(dims) >= 2 ** 31
            or Cg * KH * KW > MAX_TAPS or B * OH * OW >= 2 ** 40):
        raise ValueError(f"{fn}: dims out of range {dims}")
    xl = x.permute(0, 2, 3, 1)
    if not xl.is_contiguous():
        xl = xl.contiguous()
    mode = grouped_mode(C, Cg, O, group, xl.data_ptr() % 4 == 0)
    y = torch.empty((B * OH * OW, O), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _lib_fn()(
            xl.data_ptr(), packed.data_ptr(), mult.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            *dims, MODES[mode], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch in {mode} mode failed with "
                           f"cudaError {err}")
    qconv_grouped_int8_requant.launches += 1
    qconv_grouped_int8_requant.schedules[mode] += 1
    return y.view(B, OH, OW, O).permute(0, 3, 1, 2)


qconv_grouped_int8_requant.launches = 0
qconv_grouped_int8_requant.schedules = dict.fromkeys(MODES, 0)
