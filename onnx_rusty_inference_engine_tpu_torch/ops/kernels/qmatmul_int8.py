"""int8 x int8 -> int32 matrix product, with no epilogue.

Hopper counterpart of the TPU kernel
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8`
(Pallas body `_mm_kernel`), which the QLinearMatMul emitter runs for
symmetric zero points. The CUDA source is `csrc/qmatmul_int8.cu`: int8
tensor-core products (`mma.sync` m16n8k32) over tiles staged through
shared memory, exact int32 sums. Its source note says what bounds the
kernel on the H100 and what the design does about that.

The weight is re-laid once, when an Engine is built
(`weights.prepack_int8_weights`), into the K-contiguous rows the kernel
reads (`pack_qmatmul_weight`). The activations are read as they come: the
kernel masks the ragged edges, so no call pads or copies them.

The wrapper takes a tensor on the CPU to the kernel's plain PyTorch version
(`qmatmul_int8_plain`), and launches the kernel for a tensor on the card,
or raises. `qmatmul_int8.launches` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["qmatmul_int8", "qmatmul_int8_plain", "pack_qmatmul_weight",
           "K_ALIGN"]

# packed weight rows are zero-padded to a multiple of the kernel's K stage
# (BK in csrc/qmatmul_int8.cu)
K_ALIGN = 64
# the largest K whose sums cannot leave int32: every product is at most
# 128 * 128 in magnitude
MAX_K = (2 ** 31 - 1) // (128 * 128)


def pack_qmatmul_weight(b: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] -> int8 [N, Kp]: row n holds column n of b, zero-padded
    to Kp = K rounded up to K_ALIGN."""
    if b.dtype != torch.int8 or b.dim() != 2:
        raise ValueError(f"pack_qmatmul_weight: want int8 [K,N], got "
                         f"{b.dtype} {tuple(b.shape)}")
    K, N = b.shape
    out = torch.zeros((N, -(-K // K_ALIGN) * K_ALIGN), dtype=torch.int8,
                      device=b.device)
    out[:, :K] = b.t()
    return out


def qmatmul_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N]. The sums are taken in
    float64, where every partial sum of int8 products (|.| <= 128 * 128 * K
    < 2^53) is an exact integer, so the result equals the kernel's."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _lib_fn():
    fn = _build.load("qmatmul_int8").qmatmul_int8_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, t: torch.Tensor, dev) -> None:
    if t.device != dev or t.dtype != torch.int8 or not t.is_contiguous():
        raise ValueError(f"qmatmul_int8: {what} wants contiguous int8 on "
                         f"{dev}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def qmatmul_int8(a: torch.Tensor, b: torch.Tensor, *,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N], exact.

    On the card `packed` must be `pack_qmatmul_weight(b)`, made once per
    weight; the kernel reads it and not b."""
    if a.device.type == "cpu":
        return qmatmul_int8_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"qmatmul_int8: no kernel for {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qmatmul_int8: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if packed is None:
        raise ValueError("qmatmul_int8: on the card the weight must be "
                         "pre-packed (pack_qmatmul_weight)")
    dev = a.device
    _check("a", a, dev)
    _check("packed", packed, dev)
    Kp = -(-K // K_ALIGN) * K_ALIGN
    if tuple(packed.shape) != (N, Kp):
        raise ValueError(f"qmatmul_int8: packed weight {tuple(packed.shape)} "
                         f"is not pack_qmatmul_weight's layout of b "
                         f"{tuple(b.shape)}")
    if not 0 < K <= MAX_K or M >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"qmatmul_int8: M={M}, K={K}, N={N} out of range "
                         f"(int32 sums need 0 < K <= {MAX_K})")
    if packed.data_ptr() % 16:
        raise ValueError("qmatmul_int8: packed weight not 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out  # nothing to launch
    with torch.cuda.device(dev):
        err = _lib_fn()(a.data_ptr(), packed.data_ptr(), out.data_ptr(), M, N,
                        K, Kp, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qmatmul_int8: launch failed with cudaError {err}")
    qmatmul_int8.launches += 1
    return out


qmatmul_int8.launches = 0
