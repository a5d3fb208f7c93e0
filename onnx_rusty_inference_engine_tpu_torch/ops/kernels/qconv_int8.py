"""int8 convolution / matrix product with a fused int32-bias + requant epilogue.

Hopper counterpart of the TPU kernel
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8_requant`
(Pallas body `_mm_requant_kernel`) and of its 1x1-conv wrapper
`qconv1x1_int8_requant`. The CUDA source is `csrc/qconv_int8.cu`: one
implicit-GEMM kernel for every symmetric, group-1 QLinearConv (1x1, kxk with
padding, strided), reading channels-last int8 activations, accumulating in
int32 and leaving only int8 in device memory. Its source note says what
bounds it on the H100 and what the design does about that.

Each wrapper takes a tensor on the CPU to the kernel's plain PyTorch version
(`*_plain`), and launches the kernel for a tensor on the card, or raises.
`qconv_int8_requant.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["qconv_int8_requant", "qconv_int8_requant_plain",
           "qmatmul_int8_requant", "qmatmul_int8_requant_plain",
           "pack_qconv_weight", "K_ALIGN"]

# packed weight rows are zero-padded to a multiple of the kernel's K stage
# (BK in csrc/qconv_int8.cu)
K_ALIGN = 32

Padding = Sequence[Tuple[int, int]]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_qconv_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, KH, KW] -> int8 [O, Kp]: row o holds output channel o's
    taps in (kh, kw, c) order, the order of K in the kernel's implicit GEMM,
    zero-padded to Kp = K rounded up to K_ALIGN."""
    if w.dtype != torch.int8 or w.dim() != 4:
        raise ValueError(f"pack_qconv_weight: want int8 [O,C,KH,KW], got "
                         f"{w.dtype} {tuple(w.shape)}")
    O, C, KH, KW = w.shape
    K = KH * KW * C
    out = torch.zeros((O, _round_up(K, K_ALIGN)), dtype=torch.int8,
                      device=w.device)
    out[:, :K] = w.permute(0, 2, 3, 1).reshape(O, K)
    return out


# --------------------------------------------------------------------------
# plain versions: exact int32 accumulation, then the fp32 epilogue
# --------------------------------------------------------------------------
def _requant(acc: torch.Tensor, mult: torch.Tensor,
             bias: Optional[torch.Tensor], channel_dim: int) -> torch.Tensor:
    """`_mm_requant_kernel`'s epilogue: (acc + bias) as f32, * mult, round
    half to even, saturate to int8. mult / bias run along `channel_dim`."""
    shape = [1] * acc.dim()
    shape[channel_dim] = -1
    if bias is not None:
        acc = acc + bias.to(torch.int32).reshape(shape)
    mult = mult.to(torch.float32)
    if mult.numel() > 1:
        mult = mult.reshape(shape)
    y = torch.round(acc.to(torch.float32) * mult)
    return y.clamp(-128, 127).to(torch.int8)


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


def qmatmul_int8_requant_plain(a: torch.Tensor, b: torch.Tensor,
                               mult: torch.Tensor,
                               bias: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] (+ bias) * mult -> int8 [M,N]."""
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    return _requant(acc, mult, bias, channel_dim=-1)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qconv_int8").qconv_int8_requant_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(what: str, t: Optional[torch.Tensor], dtype: torch.dtype,
                device: torch.device, numel: Optional[int] = None) -> None:
    if t is None:
        return
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: want contiguous {dtype} on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what}: want {numel} elements, got "
                         f"{tuple(t.shape)}")


def _mult_vector(mult: torch.Tensor, n: int) -> torch.Tensor:
    mult = mult.to(torch.float32).reshape(-1)
    if mult.numel() == 1:
        mult = mult.expand(n)
    return mult.contiguous()


def _launch(x_cl, packed, mult, bias, y, *, B, H, W, C, OH, OW, N, KH, KW,
            stride, pads_tl, plane) -> None:
    dims = (B, H, W, C, OH, OW, N, KH, KW, stride[0], stride[1],
            pads_tl[0], pads_tl[1], packed.shape[1])
    if (min(dims[:11] + dims[13:]) <= 0 or min(dims[11:13]) < 0
            or max(dims) >= 2 ** 31):
        raise ValueError(f"qconv_int8_requant: dims out of range {dims}")
    if packed.data_ptr() % 16:
        raise ValueError("qconv_int8_requant: packed weight not 16-byte aligned")
    with torch.cuda.device(x_cl.device):
        stream = torch.cuda.current_stream(x_cl.device).cuda_stream
        err = _lib_fn()(
            x_cl.data_ptr(), packed.data_ptr(), mult.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            *dims, plane, stream)
    if err != 0:
        raise RuntimeError(f"qconv_int8_requant: launch failed with "
                           f"cudaError {err}")
    qconv_int8_requant.launches += 1


def qconv_int8_requant(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: Sequence[int] = (1, 1),
                       padding: Padding = ((0, 0), (0, 0)),
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric, group-1 int8 QLinearConv: x int8 [B,C,H,W] (NCHW), w int8
    [O,C,KH,KW], mult f32 [O] or scalar (x_s * w_s / y_s), bias int32 [O] or
    None, padding ((top, bottom), (left, right)) -> int8 [B,O,OH,OW].

    On the card `packed` must be `pack_qconv_weight(w)`, made once per
    weight; the activations are turned channels-last for the kernel."""
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
    dev = x.device
    _check_cuda("x", x, torch.int8, dev)
    _check_cuda("packed", packed, torch.int8, dev)
    if tuple(packed.shape) != (O, _round_up(KH * KW * C, K_ALIGN)):
        raise ValueError(f"qconv_int8_requant: packed weight "
                         f"{tuple(packed.shape)} is not pack_qconv_weight's "
                         f"layout of w {tuple(w.shape)}")
    mult = _mult_vector(mult, O)
    _check_cuda("mult", mult, torch.float32, dev, O)
    _check_cuda("bias", bias, torch.int32, dev, O)
    x_cl = x.permute(0, 2, 3, 1).contiguous()
    y = torch.empty((B, O, OH, OW), dtype=torch.int8, device=dev)
    _launch(x_cl, packed, mult, bias, y, B=B, H=H, W=W, C=C, OH=OH, OW=OW,
            N=O, KH=KH, KW=KW, stride=(sh, sw), pads_tl=(pt, pl),
            plane=OH * OW)
    return y


qconv_int8_requant.launches = 0


def qmatmul_int8_requant(a: torch.Tensor, b: torch.Tensor, mult: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] + bias, * mult -> int8 [M,N]: the TPU
    kernel's own signature, run as the 1x1 case of the conv kernel. The
    weight is packed on every call; QLinearConv pre-packs instead."""
    if a.device.type == "cpu":
        return qmatmul_int8_requant_plain(a, b, mult, bias)
    if a.device.type != "cuda":
        raise ValueError(f"qmatmul_int8_requant: no kernel for {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qmatmul_int8_requant: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    dev = a.device
    _check_cuda("a", a, torch.int8, dev)
    _check_cuda("b", b.contiguous(), torch.int8, dev)
    packed = pack_qconv_weight(b.t().reshape(N, K, 1, 1))
    mult = _mult_vector(mult, N)
    _check_cuda("mult", mult, torch.float32, dev, N)
    _check_cuda("bias", bias, torch.int32, dev, N)
    y = torch.empty((M, N), dtype=torch.int8, device=dev)
    _launch(a, packed, mult, bias, y, B=M, H=1, W=1, C=K, OH=1, OW=1, N=N,
            KH=1, KW=1, stride=(1, 1), pads_tl=(0, 0), plane=1)
    return y
