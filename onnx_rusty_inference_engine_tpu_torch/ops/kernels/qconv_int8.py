"""int8 convolution with a fused int32-bias + requant epilogue, or an exact
int32 output.

Hopper counterpart of the TPU kernel
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8_requant`
(Pallas body `_mm_requant_kernel`) and of its 1x1-conv wrapper
`qconv1x1_int8_requant`. The CUDA source is `csrc/qconv_int8.cu`: one
implicit-GEMM kernel for every group-1 QLinearConv and ConvInteger (1x1,
kxk with padding, strided, dilated) on the int8 tensor-core mainloop it
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
a zero point), always on the gather producer.

Channels-last between convs: on the card the wrapper returns a
[B, O, OH, OW] tensor with `torch.channels_last` strides, a view of the
kernel's [B*OH*OW, O] output, and reads a channels-last input without a
copy. Any other input is copied channels-last first (`channels_last_input`),
with its channels zero-padded to a multiple of 4 where they are not.

`conv_plan` picks how the kernel fetches A (`conv_producer`) and the tile:
"tma" for a 1x1, stride-1, unpadded conv with C % 16 == 0 (a plain matrix
product) on the requant epilogue, "gather" (an implicit im2col by cp.async)
for every other.

Each epilogue is a `torch.library` operator, `oriet::qconv_int8_requant`
and `oriet::qconv_int8`: on the CPU the kernel's plain PyTorch versions
(`qconv_int8_requant_plain`, `qconv_int8_plain`: contiguous NCHW results,
the same values), on the card the launch, and a fake implementation that
gives the output's shape, dtype and strides (channels-last on the card,
contiguous on the CPU) from the operands, for torch.export. The schema
holds the padding as four ints (top, bottom, left, right). The wrappers
keep their signatures, raise for a tensor on neither device and call the
op. `qconv_int8_requant.launches` counts the kernel's launches through
both wrappers (in the card's implementation), `.producers` per A
producer, `.epilogues` per epilogue, `.forms` the launches of each
QOperator form (FORMS).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._ops import define
from .qmatmul_int8 import (EPILOGUES, _requant, as_mult, check_device,
                           check_operand, check_qtype, count_forms, int8_tile,
                           mult_vector)

__all__ = ["qconv_int8_requant", "qconv_int8_requant_plain", "qconv_int8",
           "qconv_int8_plain", "pack_qconv_weight", "conv_channels",
           "conv_producer", "conv_plan", "conv_out_hw", "channels_last_input",
           "PRODUCERS", "K_ALIGN", "FORMS", "schema_padding",
           "nested_padding", "conv_fake"]

# packed weight rows are zero-padded to a multiple of 16 bytes: TMA reads
# rows whose stride is a multiple of 16
K_ALIGN = 16

# producer name -> the id the C entry point takes
PRODUCERS = {"tma": 0, "gather": 1}

# the QOperator forms `.forms` counts (a launch may be of several): a uint8
# x, padding taps holding a non-zero pad value, an output zero point, a
# uint8 output, a dilation, the int32 epilogue
FORMS = ("uint8_x", "zero_point_pad", "y_zero_point", "uint8_y", "dilated",
         "int32")

Padding = Sequence[Tuple[int, int]]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def conv_channels(C: int) -> int:
    """The channels the kernel reads per pixel: C rounded up to a multiple
    of 4, the smallest run cp.async copies."""
    return _round_up(C, 4)


def conv_producer(C: int, KH: int, KW: int, stride: Sequence[int],
                  padding: Padding, epilogue: str = "requant") -> str:
    """"tma" for a 1x1, stride-1, unpadded conv over C % 16 == 0 channels
    on the requant epilogue (A is the channels-last input as a [B*H*W, C]
    matrix, rows of a 16-byte multiple as TMA needs), "gather" for every
    other conv. C is the channels the kernel reads (`conv_channels`)."""
    if ((KH, KW) == (1, 1) and tuple(stride) == (1, 1)
            and not any(p for side in padding for p in side)
            and C % 16 == 0 and epilogue == "requant"):
        return "tma"
    return "gather"


def conv_out_hw(H: int, W: int, KH: int, KW: int, stride: Sequence[int],
                padding: Padding, dilation: Sequence[int] = (1, 1)
                ) -> Tuple[int, int]:
    """The output's (OH, OW)."""
    (pt, pb), (pl, pr) = padding
    return ((H + pt + pb - (KH - 1) * dilation[0] - 1) // stride[0] + 1,
            (W + pl + pr - (KW - 1) * dilation[1] - 1) // stride[1] + 1)


def conv_plan(x_shape: Sequence[int], w_shape: Sequence[int],
              stride: Sequence[int], padding: Padding,
              dilation: Sequence[int] = (1, 1), epilogue: str = "requant"):
    """(producer, tile) for a conv of x [B, C, H, W] by w [O, C, KH, KW]:
    what the wrapper passes the kernel."""
    B, C, H, W = x_shape
    O, _, KH, KW = w_shape
    OH, OW = conv_out_hw(H, W, KH, KW, stride, padding, dilation)
    Cp = conv_channels(C)
    tile = int8_tile(B * OH * OW, O, _round_up(KH * KW * Cp, K_ALIGN))
    return conv_producer(Cp, KH, KW, stride, padding, epilogue), tile


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
# plain versions: exact int32 accumulation, then the fp32 epilogue
# --------------------------------------------------------------------------
def conv_sums_plain(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                    padding: Padding, dilation: Sequence[int] = (1, 1),
                    pad_value: int = 0, groups: int = 1) -> torch.Tensor:
    """sum over each window of x (int8 or uint8 [B,C,H,W], padded with
    pad_value) times w (int8 [O,C/groups,KH,KW]) -> int32 [B,O,OH,OW]. The
    sums are taken in float64, where every partial sum of 8-bit products
    (|.| < 256*128*K) is an exact integer, so the result equals the
    kernels'."""
    (pt, pb), (pl, pr) = padding
    xd = F.pad(x.to(torch.float64), (pl, pr, pt, pb), value=float(pad_value))
    # cuDNN may pick an inexact (FFT) algorithm; PyTorch's own conv is a
    # float64 GEMM, exact here
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xd, w.to(torch.float64), stride=tuple(stride),
                       dilation=tuple(dilation), groups=groups)
    return acc.to(torch.int32)


def qconv_int8_plain(x: torch.Tensor, w: torch.Tensor, *,
                     stride: Sequence[int] = (1, 1),
                     padding: Padding = ((0, 0), (0, 0)),
                     dilation: Sequence[int] = (1, 1),
                     pad_value: int = 0) -> torch.Tensor:
    """The int32 epilogue's function: x int8 or uint8 [B,C,H,W], w int8
    [O,C,KH,KW] -> int32 [B,O,OH,OW], padding taps holding pad_value."""
    return conv_sums_plain(x, w, stride, padding, dilation, pad_value)


def qconv_int8_requant_plain(x: torch.Tensor, w: torch.Tensor,
                             mult: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             stride: Sequence[int] = (1, 1),
                             padding: Padding = ((0, 0), (0, 0)),
                             dilation: Sequence[int] = (1, 1),
                             pad_value: int = 0, y_zp: int = 0,
                             out_dtype: torch.dtype = torch.int8
                             ) -> torch.Tensor:
    """x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW], mult f32 [O] or
    scalar, bias int32 [O] -> out_dtype [B,O,OH,OW]: the exact sums (padding
    taps holding pad_value) + bias, * mult, rounded half to even, + y_zp,
    saturated."""
    acc = conv_sums_plain(x, w, stride, padding, dilation, pad_value)
    return _requant(acc, mult, bias, channel_dim=1, y_zp=y_zp,
                    out_dtype=out_dtype)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_int8").qconv_int8_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 26
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def channels_last_input(x: torch.Tensor) -> torch.Tensor:
    """x int8 or uint8 [B, C, H, W] as the kernel reads it: [B, H, W, Cp]
    contiguous, Cp = conv_channels(C), 16-byte aligned. A channels-last,
    aligned x with Cp == C is returned as a view; any other is copied."""
    B, C, H, W = x.shape
    Cp = conv_channels(C)
    xl = x.permute(0, 2, 3, 1)
    if Cp == C:
        if xl.is_contiguous() and xl.data_ptr() % 16 == 0:
            return xl
        return xl.contiguous()  # a new allocation: aligned
    out = torch.zeros((B, H, W, Cp), dtype=x.dtype, device=x.device)
    out[..., :C] = xl
    return out


def _launch(fn: str, x, w, packed, epilogue: str, mult, bias, stride,
            padding, dilation, pad_value: int, y_zp: int = 0,
            out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Check the operands, launch one epilogue of the kernel on the card on
    the producer and tile `conv_plan` gives, and count the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {x.device}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a group-1 2-D conv")
    B, C, H, W = x.shape
    O, _, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"{fn}: negative padding {padding}")
    sh, sw = (int(s) for s in stride)
    dh, dw = (int(d) for d in dilation)
    OH, OW = conv_out_hw(H, W, KH, KW, (sh, sw), padding, (dh, dw))
    if packed is None:
        raise ValueError(f"{fn}: on the card the weight must be pre-packed "
                         f"(pack_qconv_weight)")
    dev = x.device
    if x.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{fn}: x wants torch.int8 or torch.uint8, got "
                         f"{x.dtype}")
    info = torch.iinfo(x.dtype)
    if not info.min <= pad_value <= info.max:
        raise ValueError(f"{fn}: pad_value {pad_value} outside {x.dtype}")
    check_operand(fn, "packed", packed, torch.int8, dev)
    Cp = conv_channels(C)
    Kp = _round_up(KH * KW * Cp, K_ALIGN)
    if tuple(packed.shape) != (O, Kp):
        raise ValueError(f"{fn}: packed weight {tuple(packed.shape)} is not "
                         f"pack_qconv_weight's layout of w {tuple(w.shape)}")
    if epilogue == "requant":
        mult = mult_vector(mult, O)
        check_operand(fn, "mult", mult, torch.float32, dev, O)
        check_operand(fn, "bias", bias, torch.int32, dev, O)
        check_qtype(fn, out_dtype, y_zp)
    dims = (B, H, W, Cp, OH, OW, O, KH, KW, sh, sw, pt, pl, dh, dw, Kp)
    M = B * OH * OW
    if (min(dims[:11] + dims[13:]) <= 0 or min(dims[11:13]) < 0
            or max(dims) >= 2 ** 31 or M >= 2 ** 31):
        raise ValueError(f"{fn}: dims out of range {dims}")
    if packed.data_ptr() % 16:
        raise ValueError(f"{fn}: packed weight not 16-byte aligned")
    producer, tile = conv_plan(x.shape, w.shape, (sh, sw), padding,
                               (dh, dw), epilogue)
    x_cl = channels_last_input(x)
    y = torch.empty((M, O), device=dev, dtype=(
        torch.int32 if epilogue == "int32" else out_dtype))
    with torch.cuda.device(dev):
        err = _lib_fn()(
            x_cl.data_ptr(), packed.data_ptr(),
            mult.data_ptr() if mult is not None else None,
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            *dims, PRODUCERS[producer], EPILOGUES[epilogue],
            int(x.dtype == torch.uint8), pad_value & 0xFF, y_zp, int(out_dtype == torch.uint8), *tile,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch with the {producer} producer and "
                           f"the {epilogue} epilogue on {tile} failed with "
                           f"cudaError {err}")
    w_ = qconv_int8_requant
    w_.launches += 1
    w_.producers[producer] += 1
    w_.epilogues[epilogue] += 1
    count_forms(w_.forms, uint8_x=x.dtype == torch.uint8,
                zero_point_pad=pad_value != 0 and any((pt, pb, pl, pr)),
                y_zero_point=y_zp != 0,
                uint8_y=epilogue == "requant" and out_dtype == torch.uint8,
                dilated=(dh, dw) != (1, 1), int32=epilogue == "int32")
    return y.view(B, OH, OW, O).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def schema_padding(padding: Padding) -> list:
    """((top, bottom), (left, right)) as the ops' four ints."""
    (pt, pb), (pl, pr) = padding
    return [int(pt), int(pb), int(pl), int(pr)]


def nested_padding(pads: Sequence[int]) -> Padding:
    """The ops' four ints back as ((top, bottom), (left, right))."""
    return ((pads[0], pads[1]), (pads[2], pads[3]))


def conv_fake(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              pads: Sequence[int], dilation: Sequence[int],
              dtype: torch.dtype) -> torch.Tensor:
    """The result the conv ops give, as an empty tensor: [B, O, OH, OW],
    on the card a channels-last view of a [B*OH*OW, O] matrix (what the
    kernels write), on the CPU contiguous (what the plain versions
    give)."""
    B, _, H, W = x.shape
    O, _, KH, KW = w.shape
    OH, OW = conv_out_hw(H, W, KH, KW, stride, nested_padding(pads),
                         dilation)
    if x.device.type == "cuda":
        return x.new_empty((B * OH * OW, O), dtype=dtype).view(
            B, OH, OW, O).permute(0, 3, 1, 2)
    return x.new_empty((B, O, OH, OW), dtype=dtype)


# the schema of the convs' ops, after the name: padding is (top, bottom,
# left, right)
CONV_ARGS = ("int[] stride, int[] padding, int[] dilation, int pad_value")


def _qconv_int8_requant_cpu(x, w, mult, bias, packed, stride, padding,
                            dilation, pad_value, y_zp, out_dtype):
    check_qtype("qconv_int8_requant", out_dtype, y_zp)
    return qconv_int8_requant_plain(
        x, w, mult, bias, stride=stride, padding=nested_padding(padding),
        dilation=dilation, pad_value=pad_value, y_zp=y_zp,
        out_dtype=out_dtype)


def _qconv_int8_requant_cuda(x, w, mult, bias, packed, stride, padding,
                             dilation, pad_value, y_zp, out_dtype):
    return _launch("qconv_int8_requant", x, w, packed, "requant", mult,
                   bias, stride, nested_padding(padding), dilation,
                   pad_value, y_zp, out_dtype)


def _qconv_int8_requant_fake(x, w, mult, bias, packed, stride, padding,
                             dilation, pad_value, y_zp, out_dtype):
    return conv_fake(x, w, stride, padding, dilation, out_dtype)


_qconv_int8_requant_op = define(
    "qconv_int8_requant(Tensor x, Tensor w, Tensor mult, Tensor? bias, "
    f"Tensor? packed, {CONV_ARGS}, int y_zp, ScalarType out_dtype) -> Tensor",
    _qconv_int8_requant_cpu, _qconv_int8_requant_cuda,
    _qconv_int8_requant_fake)


def _qconv_int8_cpu(x, w, packed, stride, padding, dilation, pad_value):
    return qconv_int8_plain(x, w, stride=stride,
                            padding=nested_padding(padding),
                            dilation=dilation, pad_value=pad_value)


def _qconv_int8_cuda(x, w, packed, stride, padding, dilation, pad_value):
    return _launch("qconv_int8", x, w, packed, "int32", None, None, stride,
                   nested_padding(padding), dilation, pad_value)


def _qconv_int8_fake(x, w, packed, stride, padding, dilation, pad_value):
    return conv_fake(x, w, stride, padding, dilation, torch.int32)


_qconv_int8_op = define(
    f"qconv_int8(Tensor x, Tensor w, Tensor? packed, {CONV_ARGS}) -> Tensor",
    _qconv_int8_cpu, _qconv_int8_cuda, _qconv_int8_fake)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def _check_conv(fn: str, x: torch.Tensor, w: torch.Tensor) -> None:
    check_device(fn, x)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"are not a 2-D conv")


def qconv_int8_requant(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: Sequence[int] = (1, 1),
                       padding: Padding = ((0, 0), (0, 0)),
                       dilation: Sequence[int] = (1, 1), pad_value: int = 0,
                       y_zp: int = 0, out_dtype: torch.dtype = torch.int8,
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group-1 QLinearConv: x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW],
    mult f32 [O] or scalar (x_s * w_s / y_s), bias int32 [O] or None,
    padding ((top, bottom), (left, right)) whose taps hold pad_value (x's
    zero point), y_zp in out_dtype (int8 or uint8) -> out_dtype
    [B,O,OH,OW] (`oriet::qconv_int8_requant`).

    On the card `packed` must be `pack_qconv_weight(w)`, made once per
    weight, and the result is channels-last (see the module note)."""
    _check_conv("qconv_int8_requant", x, w)
    return _qconv_int8_requant_op(
        x, w, as_mult(mult, x), bias, packed, [int(s) for s in stride],
        schema_padding(padding), [int(d) for d in dilation], int(pad_value),
        int(y_zp), out_dtype)


def qconv_int8(x: torch.Tensor, w: torch.Tensor, *,
               stride: Sequence[int] = (1, 1),
               padding: Padding = ((0, 0), (0, 0)),
               dilation: Sequence[int] = (1, 1), pad_value: int = 0,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int32 epilogue: x int8 or uint8 [B,C,H,W], w int8 [O,C,KH,KW]
    -> the exact int32 sums [B,O,OH,OW], padding taps holding pad_value
    (`oriet::qconv_int8`). On the card `packed` is
    `pack_qconv_weight(w)`; counted on `qconv_int8_requant` (the same
    kernel, int32 epilogue)."""
    _check_conv("qconv_int8", x, w)
    return _qconv_int8_op(x, w, packed, [int(s) for s in stride],
                          schema_padding(padding),
                          [int(d) for d in dilation], int(pad_value))


qconv_int8_requant.launches = 0
qconv_int8_requant.producers = dict.fromkeys(PRODUCERS, 0)
qconv_int8_requant.epilogues = dict.fromkeys(EPILOGUES, 0)
qconv_int8_requant.forms = dict.fromkeys(FORMS, 0)
