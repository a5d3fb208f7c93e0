"""int8 convolution with a fused int32-bias + requant epilogue.

Hopper counterpart of the TPU kernel
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8_requant`
(Pallas body `_mm_requant_kernel`) and of its 1x1-conv wrapper
`qconv1x1_int8_requant`. The CUDA source is `csrc/qconv_int8.cu`: one
implicit-GEMM kernel for every symmetric, group-1 QLinearConv (1x1, kxk with
padding, strided) on the int8 tensor-core mainloop it shares with the int8
GEMM (`csrc/int8_wgmma.cuh`), reading channels-last int8 activations,
accumulating in int32 and leaving only int8 in device memory. Its source
note says what bounds it on the H100 and what the design does about that.

Channels-last between convs: on the card the wrapper returns a
[B, O, OH, OW] tensor with `torch.channels_last` strides, a view of the
kernel's [B*OH*OW, O] output, and reads a channels-last input without a
copy. Any other input is copied channels-last first (`channels_last_input`),
with its channels zero-padded to a multiple of 4 where they are not.

`conv_plan` picks how the kernel fetches A (`conv_producer`) and the tile:
"tma" for a 1x1, stride-1, unpadded conv with C % 16 == 0 (a plain matrix
product), "gather" (an implicit im2col by cp.async) for every other.

The wrapper takes a tensor on the CPU to the kernel's plain PyTorch
version (`qconv_int8_requant_plain`, a contiguous NCHW result: the same
values), and launches the kernel for a tensor on the card, or raises.
`qconv_int8_requant.launches` counts the kernel's launches,
`qconv_int8_requant.producers` counts them per A producer.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .qmatmul_int8 import _requant, check_operand, int8_tile, mult_vector

__all__ = ["qconv_int8_requant", "qconv_int8_requant_plain",
           "pack_qconv_weight", "conv_channels", "conv_producer", "conv_plan",
           "channels_last_input", "PRODUCERS", "K_ALIGN"]

# packed weight rows are zero-padded to a multiple of 16 bytes: TMA reads
# rows whose stride is a multiple of 16
K_ALIGN = 16

# producer name -> the id the C entry point takes
PRODUCERS = {"tma": 0, "gather": 1}

Padding = Sequence[Tuple[int, int]]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_channels(C: int) -> int:
    """The channels the kernel reads per pixel: C rounded up to a multiple
    of 4, the smallest run cp.async copies."""
    return _round_up(C, 4)


def conv_producer(C: int, KH: int, KW: int, stride: Sequence[int],
                  padding: Padding) -> str:
    """"tma" for a 1x1, stride-1, unpadded conv over C % 16 == 0 channels
    (A is the channels-last input as a [B*H*W, C] matrix, rows of a
    16-byte multiple as TMA needs), "gather" for every other conv. C is the
    channels the kernel reads (`conv_channels`)."""
    if ((KH, KW) == (1, 1) and tuple(stride) == (1, 1)
            and not any(p for side in padding for p in side)
            and C % 16 == 0):
        return "tma"
    return "gather"


def conv_plan(x_shape: Sequence[int], w_shape: Sequence[int],
              stride: Sequence[int], padding: Padding):
    """(producer, tile) for a conv of x [B, C, H, W] by w [O, C, KH, KW]:
    what the wrapper passes the kernel."""
    B, C, H, W = x_shape
    O, _, KH, KW = w_shape
    (pt, pb), (pl, pr) = padding
    OH = (H + pt + pb - KH) // stride[0] + 1
    OW = (W + pl + pr - KW) // stride[1] + 1
    Cp = conv_channels(C)
    tile = int8_tile(B * OH * OW, O, _round_up(KH * KW * Cp, K_ALIGN))
    return conv_producer(Cp, KH, KW, stride, padding), tile


def pack_qconv_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, KH, KW] -> int8 [O, Kp]: row o holds output channel o's
    taps in (kh, kw, c) order over Cp = conv_channels(C) channels (zero past
    C), the order of K in the kernel's implicit GEMM, zero-padded to Kp =
    KH*KW*Cp rounded up to K_ALIGN."""
    if w.dtype != torch.int8 or w.dim() != 4:
        raise ValueError(f"pack_qconv_weight: want int8 [O,C,KH,KW], got "
                         f"{w.dtype} {tuple(w.shape)}")
    O, C, KH, KW = w.shape
    Cp = conv_channels(C)
    taps = torch.zeros((O, KH, KW, Cp), dtype=torch.int8, device=w.device)
    taps[..., :C] = w.permute(0, 2, 3, 1)
    K = KH * KW * Cp
    out = torch.zeros((O, _round_up(K, K_ALIGN)), dtype=torch.int8,
                      device=w.device)
    out[:, :K] = taps.reshape(O, K)
    return out


# --------------------------------------------------------------------------
# plain version: exact int32 accumulation, then the fp32 epilogue
# --------------------------------------------------------------------------
def qconv_int8_requant_plain(x: torch.Tensor, w: torch.Tensor,
                             mult: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             stride: Sequence[int] = (1, 1),
                             padding: Padding = ((0, 0), (0, 0))
                             ) -> torch.Tensor:
    """x int8 [B,C,H,W], w int8 [O,C,KH,KW], mult f32 [O] or scalar, bias
    int32 [O] -> int8 [B,O,OH,OW]. The sums are taken in float64, where
    every partial sum of int8 products (|.| < 127*127*K) is an exact
    integer, so the int32 result equals the kernel's."""
    (pt, pb), (pl, pr) = padding
    xd = F.pad(x.to(torch.float64), (pl, pr, pt, pb))
    # cuDNN may pick an inexact (FFT) algorithm; PyTorch's own conv is a
    # float64 GEMM, exact here
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, w.to(torch.float64), stride=tuple(stride))
    return _requant(acc.to(torch.int32), mult, bias, channel_dim=1)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_int8").qconv_int8_requant_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 19
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def channels_last_input(x: torch.Tensor) -> torch.Tensor:
    """x int8 [B, C, H, W] as the kernel reads it: [B, H, W, Cp]
    contiguous, Cp = conv_channels(C), 16-byte aligned. A channels-last,
    aligned x with Cp == C is returned as a view; any other is copied."""
    B, C, H, W = x.shape
    Cp = conv_channels(C)
    xl = x.permute(0, 2, 3, 1)
    if Cp == C:
        if xl.is_contiguous() and xl.data_ptr() % 16 == 0:
            return xl
        return xl.contiguous()  # a new allocation: aligned
    out = torch.zeros((B, H, W, Cp), dtype=torch.int8, device=x.device)
    out[..., :C] = xl
    return out


def qconv_int8_requant(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: Sequence[int] = (1, 1),
                       padding: Padding = ((0, 0), (0, 0)),
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric, group-1 int8 QLinearConv: x int8 [B,C,H,W], w int8
    [O,C,KH,KW], mult f32 [O] or scalar (x_s * w_s / y_s), bias int32 [O] or
    None, padding ((top, bottom), (left, right)) -> int8 [B,O,OH,OW].

    On the card `packed` must be `pack_qconv_weight(w)`, made once per
    weight, and the result is channels-last (see the module note)."""
    if x.device.type == "cpu":
        return qconv_int8_requant_plain(x, w, mult, bias, stride=stride,
                                        padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"qconv_int8_requant: no kernel for {x.device}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"qconv_int8_requant: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not a group-1 2-D conv")
    B, C, H, W = x.shape
    O, _, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"qconv_int8_requant: negative padding {padding}")
    sh, sw = (int(s) for s in stride)
    OH = (H + pt + pb - KH) // sh + 1
    OW = (W + pl + pr - KW) // sw + 1
    if packed is None:
        raise ValueError("qconv_int8_requant: on the card the weight must "
                         "be pre-packed (pack_qconv_weight)")
    fn = "qconv_int8_requant"
    dev = x.device
    if x.dtype != torch.int8:
        raise ValueError(f"{fn}: x wants torch.int8, got {x.dtype}")
    check_operand(fn, "packed", packed, torch.int8, dev)
    Cp = conv_channels(C)
    Kp = _round_up(KH * KW * Cp, K_ALIGN)
    if tuple(packed.shape) != (O, Kp):
        raise ValueError(f"qconv_int8_requant: packed weight "
                         f"{tuple(packed.shape)} is not pack_qconv_weight's "
                         f"layout of w {tuple(w.shape)}")
    mult = mult_vector(mult, O)
    check_operand(fn, "mult", mult, torch.float32, dev, O)
    check_operand(fn, "bias", bias, torch.int32, dev, O)
    dims = (B, H, W, Cp, OH, OW, O, KH, KW, sh, sw, pt, pl, Kp)
    M = B * OH * OW
    if (min(dims[:11] + dims[13:]) <= 0 or min(dims[11:13]) < 0
            or max(dims) >= 2 ** 31 or M >= 2 ** 31):
        raise ValueError(f"qconv_int8_requant: dims out of range {dims}")
    if packed.data_ptr() % 16:
        raise ValueError("qconv_int8_requant: packed weight not 16-byte "
                         "aligned")
    producer, tile = conv_plan(x.shape, w.shape, (sh, sw), padding)
    x_cl = channels_last_input(x)
    y = torch.empty((M, O), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _lib_fn()(
            x_cl.data_ptr(), packed.data_ptr(), mult.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            *dims, PRODUCERS[producer], *tile,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv_int8_requant: launch with the {producer} "
                           f"producer on {tile} failed with cudaError {err}")
    qconv_int8_requant.launches += 1
    qconv_int8_requant.producers[producer] += 1
    return y.view(B, OH, OW, O).permute(0, 3, 1, 2)


qconv_int8_requant.launches = 0
qconv_int8_requant.producers = dict.fromkeys(PRODUCERS, 0)
