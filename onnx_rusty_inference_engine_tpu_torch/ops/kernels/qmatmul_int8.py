"""int8 x int8 matrix product: exact int32 out, or a fused bias + requant
to int8.

Hopper counterpart of the TPU kernels
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py::qmatmul_int8`
(Pallas body `_mm_kernel`) and, in its 2-D form, `qmatmul_int8_requant`
(body `_mm_requant_kernel`). The CUDA source is `csrc/qmatmul_int8.cu` on
the int8 tensor-core mainloop of `csrc/int8_wgmma.cuh` (wgmma fed by TMA
through a ring of shared-memory slots), with two epilogues: `qmatmul_int8`
returns the exact int32 product, `qmatmul_int8_requant` adds the int32 bias,
multiplies by the f32 multiplier, rounds half to even, adds the output zero
point and saturates to the output type (int8 or uint8), so that only that
type leaves the kernel. The source notes say what bounds the
kernel on the H100 and what the design does about that.

`int8_tile` picks the tile and the ring depth from the shape, in Python,
for this kernel and for the conv kernel of `qconv_int8.py`, which shares
the mainloop; the C entry points refuse a choice that does not fit.

The weight is re-laid once, when an Engine is built
(`weights.prepack_int8_weights`), into the K-contiguous rows the kernel
reads (`pack_qmatmul_weight`). The activations are read as they come when
K is a multiple of 16 (TMA's row stride), and copied into a zero-padded
buffer otherwise.

MatMulInteger (ops/quantized.py) reaches the int32 epilogue through
`matmul_integer_int8`, which takes an activation of any rank [..., K] to
the 2-D product and back.

Each epilogue is a `torch.library` operator, `oriet::qmatmul_int8` and
`oriet::qmatmul_int8_requant`, with three implementations: on the CPU the
kernel's plain PyTorch version (`*_plain`), on the card the launch, and a
fake one that gives the output's shape, dtype and strides from the
operands alone, so that torch.export can trace a graph that runs the
kernel (export_aot.py) and the profiler puts the launch under its op. The
wrappers keep their signatures, check the device (a tensor on neither the
CPU nor the card raises) and call the op; `matmul_integer_int8` is a
reshape around `oriet::qmatmul_int8`. `qmatmul_int8.launches` counts the
kernel's launches through every wrapper (inside the card's
implementation, so that a loaded program's eager call counts too),
`qmatmul_int8.epilogues` counts them per epilogue, `.forms` those with an
output zero point (`y_zero_point`), a uint8 output (`uint8_y`) or an
output zero point the kernel reads from device memory
(`device_zero_point`: `y_zp` given as a one-element tensor, a zero point
the graph computes at run time; a captured CUDA graph then replays with
each run's value).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _build
from ._ops import define

__all__ = ["qmatmul_int8", "qmatmul_int8_plain", "qmatmul_int8_requant",
           "qmatmul_int8_requant_plain", "pack_qmatmul_weight", "int8_tile",
           "Int8Tile", "EPILOGUES", "K_ALIGN", "MAX_K",
           "matmul_integer_int8", "as_int8", "colsum_key", "folded_bias_key",
           "ones_key", "QTYPES", "FORMS", "check_device", "as_mult",
           "zero_point_arg", "ZeroPoint"]

# packed weight rows are zero-padded to a multiple of 16 bytes: TMA reads
# rows whose stride is a multiple of 16
K_ALIGN = 16
# the largest K whose sums cannot leave int32: every product is at most
# 128 * 128 in magnitude
MAX_K = (2 ** 31 - 1) // (128 * 128)

# epilogue name -> the id the C entry point takes
EPILOGUES = {"int32": 0, "requant": 1}

# the requant epilogue's output types
QTYPES = (torch.int8, torch.uint8)

# a zero point: known before the run, or a one-element tensor on the device
ZeroPoint = Union[int, torch.Tensor]

# the forms `.forms` counts (a launch may be of several)
FORMS = ("y_zero_point", "uint8_y", "device_zero_point")

# the kernel's tile (csrc/int8_wgmma.cuh): BN is one wgmma N, BM 64 rows per
# consumer warpgroup, each ring slot 128 K bytes of both operands
BN_CHOICES = (16, 32, 48, 64, 96, 128, 192, 256)
STAGE_K = 128
MAX_STAGES = 6
SMEM_LIMIT = 232448  # the dynamic shared memory an H100 block can opt into
NUM_SMS = 132        # H100 SXM
# a tile's fixed cost in units of output elements (int8_tile's model):
# 128 x 192 at BERT-base's N = 768 and 128-row tiles for SqueezeNet's convs
# measured fastest (experiments/int8_ablation.py on an H100)
TILE_OVERHEAD = 3 * 64 * 64


# the most shared memory a resident B (all K slices of its one N tile) takes
B_RESIDENT_MAX = 96 * 1024


class Int8Tile(NamedTuple):
    bm: int
    bn: int
    stages: int
    b_resident: bool = False  # B loaded once per block, the ring carries A


def smem_bytes(bm: int, bn: int, stages: int, resident_k: int = 0) -> int:
    """The kernel's dynamic shared memory for a tile: 1024 bytes to align
    the ring, `stages` slots of (bm + bn) x 128 bytes (bm x 128 with B
    resident, its `resident_k` 128-byte K slices of bn rows after them), the
    requant epilogue's int8 staging tile (bm rows of bn + 16 bytes), two
    mbarriers a slot and one for B (csrc/int8_wgmma.cuh::smem_bytes)."""
    slot = (bm + (0 if resident_k else bn)) * STAGE_K
    return (1024 + stages * slot + resident_k * bn * STAGE_K
            + bm * (bn + 16) + 16 * stages + 8)


def tile_smem(tile: Int8Tile, K: int) -> int:
    """smem_bytes of `tile` for a product over K."""
    resident_k = -(-K // STAGE_K) if tile.b_resident else 0
    return smem_bytes(tile.bm, tile.bn, tile.stages, resident_k)


def int8_tile(M: int, N: int, K: int, bms: Sequence[int] = (64, 128),
              bns: Optional[Sequence[int]] = None) -> Int8Tile:
    """The tile for an int8 product [M, K] x [K, N]. (BM, BN) minimizes the
    time each SM spends, modelled as ceil(tiles / NUM_SMS) waves of a
    tile's work BM * BN plus a fixed TILE_OVERHEAD (a tile's epilogue,
    barriers and its B slice), over BM 64 or 128 and BN the narrowest wgmma
    N that covers N (up to 256), or, for N > 256, BN 128, 192 or 256; the
    larger tile on a tie. So a product whose tiles fill the SMs once
    (BERT-base's N = 768 at M = 4096: 128 tiles of 128 x 192) is not cut
    into a second, part-empty wave. Where N fits one tile and all of B's
    K slices fit in B_RESIDENT_MAX, B is resident (loaded once per block;
    every block reading the same weights from L2 for every tile bounds the
    narrow convs otherwise). The ring is the deepest of at most MAX_STAGES
    slots that fits in shared memory, in half of it for BN <= 64 (two such
    blocks share an SM). The kernel is persistent, so the ring runs on
    across tiles and K does not bound its depth. `bms` and `bns`, where
    given, are the only (BM, BN) the choice may take (the 3-D conv's
    instances, qconv_int8.conv_plan)."""
    if bns is None:
        bns = ([next(c for c in BN_CHOICES if c >= N)]
               if N <= BN_CHOICES[-1] else [128, 192, 256])

    def work(tile):
        bm, bn = tile
        tiles = -(-M // bm) * -(-N // bn)
        return (-(-tiles // NUM_SMS) * (bm * bn + TILE_OVERHEAD), -bm * bn)

    bm, bn = min(((bm, bn) for bm in bms for bn in bns), key=work)
    budget = SMEM_LIMIT // 2 if bn <= 64 else SMEM_LIMIT
    num_k = -(-K // STAGE_K)
    resident = N <= bn and num_k * bn * STAGE_K <= B_RESIDENT_MAX
    fixed = smem_bytes(bm, bn, 0, resident_k=num_k if resident else 0)
    slot = (bm + (0 if resident else bn)) * STAGE_K
    fit = (budget - fixed) // (slot + 16)
    return Int8Tile(bm, bn, max(2, min(MAX_STAGES, fit)), resident)


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


def as_int8(t: torch.Tensor) -> torch.Tensor:
    """An int8 or uint8 tensor as int8: uint8 shifted by -128 (its top bit
    flipped), int8 as it is. One elementwise pass for uint8."""
    if t.dtype == torch.uint8:
        return torch.bitwise_xor(t, 0x80).view(torch.int8)
    return t


def folded_bias_key(node_output: str) -> str:
    """The key under which `weights.prepack_int8_weights` keeps a
    QLinearConv's or QLinearMatMul's int32 bias with its input zero point
    folded in (bias - zx * `colsum_key`'s sums)."""
    return f"{node_output}::bias"


def ones_key(name: str) -> str:
    """The key under which `weights.prepack_int8_weights` keeps the packed
    all-ones weight (one output per group) whose sums, the window sums of x,
    a conv weight's zero point multiplies."""
    return f"{name}::ones"


def colsum_key(name: str) -> str:
    """The key under which `weights.prepack_int8_weights` keeps the int32
    sums of an int8 weight (of its `as_int8` form) over its contraction
    axis, one per output: a [K, N] matrix's column sums, a conv weight's
    sums per output channel. The zero-point corrections read them."""
    return f"{name}::colsum"


# --------------------------------------------------------------------------
# plain versions: exact int32 accumulation, then the fp32 epilogue
# --------------------------------------------------------------------------
def qmatmul_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N]. The sums are taken in
    float64, where every partial sum of int8 products (|.| <= 128 * 128 * K
    < 2^53) is an exact integer, so the result equals the kernel's."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _requant(acc: torch.Tensor, mult: torch.Tensor,
             bias: Optional[torch.Tensor], channel_dim: int, y_zp=0,
             out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """`_mm_requant_kernel`'s epilogue with ONNX's output zero point, in the
    JAX emitter's `_requant` order: (acc + bias) as f32, * mult, round half
    to even, + y_zp, saturate to `out_dtype` (int8 or uint8). mult / bias
    run along `channel_dim`. y_zp: an int, or a one-element tensor on acc's
    device (a zero point computed at run time)."""
    shape = [1] * acc.dim()
    shape[channel_dim] = -1
    if bias is not None:
        acc = acc + bias.to(torch.int32).reshape(shape)
    mult = mult.to(torch.float32)
    if mult.numel() > 1:
        mult = mult.reshape(shape)
    y = torch.round(acc.to(torch.float32) * mult)
    if isinstance(y_zp, torch.Tensor):
        y = y + y_zp.to(torch.float32).reshape(())
    elif y_zp:
        y = y + float(y_zp)
    info = torch.iinfo(out_dtype)
    return y.clamp(info.min, info.max).to(out_dtype)


def qmatmul_int8_requant_plain(a: torch.Tensor, b: torch.Tensor,
                               mult: torch.Tensor,
                               bias: Optional[torch.Tensor] = None, *,
                               y_zp=0,
                               out_dtype: torch.dtype = torch.int8
                               ) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] (+ bias) * mult (+ y_zp) -> out_dtype
    [M,N]."""
    acc = (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    return _requant(acc, mult, bias, channel_dim=-1, y_zp=y_zp,
                    out_dtype=out_dtype)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
def _lib_fn():
    fn = _build.load("qmatmul_int8").qmatmul_int8_launch
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_operand(fn: str, what: str, t: Optional[torch.Tensor],
                  dtype: torch.dtype, dev, numel: Optional[int] = None) -> None:
    """Raise unless t (where given) is a contiguous `dtype` tensor on
    `dev` with `numel` elements."""
    if t is None:
        return
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {what} wants contiguous {dtype} on {dev}, "
                         f"got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{fn}: {what} wants {numel} elements, got "
                         f"{tuple(t.shape)}")


def mult_vector(mult: torch.Tensor, n: int) -> torch.Tensor:
    """The requant multiplier as the f32 [n] vector the kernels read: a
    scalar (or one-element) multiplier is broadcast."""
    mult = mult.to(torch.float32).reshape(-1)
    if mult.numel() == 1:
        mult = mult.expand(n)
    return mult.contiguous()


def check_qtype(fn: str, out_dtype: torch.dtype, y_zp: int) -> None:
    """Raise unless out_dtype is int8 or uint8 and y_zp lies in its range."""
    if out_dtype not in QTYPES:
        raise ValueError(f"{fn}: out_dtype {out_dtype} (the requant "
                         f"epilogue gives int8 or uint8)")
    info = torch.iinfo(out_dtype)
    if not info.min <= y_zp <= info.max:
        raise ValueError(f"{fn}: y_zp {y_zp} outside {out_dtype}")


def check_device(fn: str, t: torch.Tensor) -> None:
    """Raise unless t lies on the CPU (the plain version) or the card (the
    kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for {t.device}")


def as_mult(mult, like: torch.Tensor) -> torch.Tensor:
    """The requant multiplier as a tensor on `like`'s device (the ops'
    schema takes a tensor; a Python number becomes a 0-d f32 tensor)."""
    if isinstance(mult, torch.Tensor):
        return mult
    return torch.tensor(float(mult), dtype=torch.float32, device=like.device)


def zero_point_arg(fn: str, zp: ZeroPoint, dtype: torch.dtype, dev
                   ) -> Tuple[int, Optional[torch.Tensor]]:
    """A zero point as the kernels take it: (the launch's int, None) for
    one known before the run, range-checked against `dtype`; (0, an int32
    one-element tensor on `dev`) for one in device memory, which the
    kernel reads (and saturates to `dtype`'s range) in the run."""
    if isinstance(zp, torch.Tensor):
        if zp.numel() != 1 or zp.device != dev or zp.is_floating_point():
            raise ValueError(f"{fn}: a zero point in device memory wants one "
                             f"integer element on {dev}, got {zp.dtype} "
                             f"{tuple(zp.shape)} on {zp.device}")
        return 0, zp.to(torch.int32).reshape(1).contiguous()
    info = torch.iinfo(dtype)
    if not info.min <= zp <= info.max:
        raise ValueError(f"{fn}: zero point {zp} outside {dtype}")
    return int(zp), None


def count_forms(counter: dict, **on: bool) -> None:
    """Add one to each of `counter`'s forms that is on for a launch."""
    for form, flag in on.items():
        if flag:
            counter[form] += 1


def _launch(fn: str, a: torch.Tensor, b: torch.Tensor,
            packed: Optional[torch.Tensor], epilogue: str,
            mult: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None, y_zp=0,
            out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Check the operands, launch one epilogue of the kernel on the tile
    `int8_tile` picks, and count the launch. y_zp: an int, or a
    one-element tensor the kernel reads in the run."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{fn}: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if packed is None:
        raise ValueError(f"{fn}: on the card the weight must be pre-packed "
                         f"(pack_qmatmul_weight)")
    dev = a.device
    check_operand(fn, "a", a, torch.int8, dev)
    check_operand(fn, "packed", packed, torch.int8, dev)
    Kp = -(-K // K_ALIGN) * K_ALIGN
    if tuple(packed.shape) != (N, Kp):
        raise ValueError(f"{fn}: packed weight {tuple(packed.shape)} is not "
                         f"pack_qmatmul_weight's layout of b {tuple(b.shape)}")
    if not 0 < K <= MAX_K or M >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"{fn}: M={M}, K={K}, N={N} out of range (int32 "
                         f"sums need 0 < K <= {MAX_K})")
    if packed.data_ptr() % 16:
        raise ValueError(f"{fn}: packed weight not 16-byte aligned")
    y_dev = None
    if epilogue == "requant":
        mult = mult_vector(mult, N)
        check_operand(fn, "mult", mult, torch.float32, dev, N)
        check_operand(fn, "bias", bias, torch.int32, dev, N)
        check_qtype(fn, out_dtype, 0)
        y_zp, y_dev = zero_point_arg(fn, y_zp, out_dtype, dev)
    out = torch.empty((M, N), device=dev, dtype=(
        torch.int32 if epilogue == "int32" else out_dtype))
    if M == 0 or N == 0:
        return out  # nothing to launch
    if Kp != K or a.data_ptr() % 16:  # TMA's rows: 16-byte stride and base
        a_pad = torch.zeros((M, Kp), dtype=torch.int8, device=dev)
        a_pad[:, :K] = a
        a = a_pad
    tile = int8_tile(M, N, Kp)
    with torch.cuda.device(dev):
        err = _lib_fn()(
            a.data_ptr(), packed.data_ptr(), out.data_ptr(),
            mult.data_ptr() if mult is not None else None,
            bias.data_ptr() if bias is not None else None, M, N, Kp,
            EPILOGUES[epilogue], y_zp, int(out_dtype == torch.uint8),
            y_dev.data_ptr() if y_dev is not None else None, *tile,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launch with the {epilogue} epilogue on "
                           f"{tile} failed with cudaError {err}")
    qmatmul_int8.launches += 1
    qmatmul_int8.epilogues[epilogue] += 1
    if epilogue == "requant":
        count_forms(qmatmul_int8.forms,
                    y_zero_point=y_dev is not None or y_zp != 0,
                    uint8_y=out_dtype == torch.uint8,
                    device_zero_point=y_dev is not None)
    return out


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def _qmatmul_int8_cpu(a, b, packed):
    return qmatmul_int8_plain(a, b)


def _qmatmul_int8_cuda(a, b, packed):
    return _launch("qmatmul_int8", a, b, packed, "int32")


def _qmatmul_int8_fake(a, b, packed):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32)


_qmatmul_int8_op = define(
    "qmatmul_int8(Tensor a, Tensor b, Tensor? packed) -> Tensor",
    _qmatmul_int8_cpu, _qmatmul_int8_cuda, _qmatmul_int8_fake)


def _qmatmul_int8_requant_cpu(a, b, mult, bias, packed, y_zp, out_dtype,
                              zp_y=None):
    check_qtype("qmatmul_int8_requant", out_dtype, y_zp)
    return qmatmul_int8_requant_plain(
        a, b, mult, bias, y_zp=zp_y if zp_y is not None else y_zp,
        out_dtype=out_dtype)


def _qmatmul_int8_requant_cuda(a, b, mult, bias, packed, y_zp, out_dtype,
                               zp_y=None):
    return _launch("qmatmul_int8_requant", a, b, packed, "requant", mult,
                   bias, zp_y if zp_y is not None else y_zp, out_dtype)


def _qmatmul_int8_requant_fake(a, b, mult, bias, packed, y_zp, out_dtype,
                               zp_y=None):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


_qmatmul_int8_requant_op = define(
    "qmatmul_int8_requant(Tensor a, Tensor b, Tensor mult, Tensor? bias, "
    "Tensor? packed, int y_zp, ScalarType out_dtype, Tensor? zp_y=None) "
    "-> Tensor",
    _qmatmul_int8_requant_cpu, _qmatmul_int8_requant_cuda,
    _qmatmul_int8_requant_fake)


def _check_2d(fn: str, a: torch.Tensor, b: torch.Tensor) -> None:
    check_device(fn, a)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{fn}: shapes {tuple(a.shape)} @ {tuple(b.shape)}")


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def qmatmul_int8(a: torch.Tensor, b: torch.Tensor, *,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N], exact
    (`oriet::qmatmul_int8`).

    On the card `packed` must be `pack_qmatmul_weight(b)`, made once per
    weight; the kernel reads it and not b."""
    _check_2d("qmatmul_int8", a, b)
    return _qmatmul_int8_op(a, b, packed)


qmatmul_int8.launches = 0
qmatmul_int8.epilogues = dict.fromkeys(EPILOGUES, 0)
qmatmul_int8.forms = dict.fromkeys(FORMS, 0)


def matmul_integer_int8(a: torch.Tensor, b: torch.Tensor, *,
                        packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """int8 a [..., K] @ int8 b [K, N] -> int32 [..., N], exact: the
    leading dims of a flattened into the rows of one `qmatmul_int8`
    (int32 epilogue). On the card `packed` is `pack_qmatmul_weight(b)`; a
    shape the kernel refuses raises with its shape."""
    if a.dim() < 1 or b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"matmul_integer_int8: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} (the kernel takes a [..., K] @ "
                         f"a 2-D b [K, N])")
    check_device("matmul_integer_int8", a)
    K, N = b.shape
    acc = qmatmul_int8(a.reshape(-1, K).contiguous(), b, packed=packed)
    return acc.reshape(*a.shape[:-1], N)


def qmatmul_int8_requant(a: torch.Tensor, b: torch.Tensor, mult: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         y_zp=0, out_dtype: torch.dtype = torch.int8,
                         packed: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """int8 [M,K] @ int8 [K,N] + bias, * mult, + y_zp -> out_dtype (int8 or
    uint8) [M,N]: the TPU kernel's signature with ONNX's output zero point,
    mult f32 [N] or scalar, bias int32 [N] or None, y_zp an int or a
    one-element integer tensor on a's device that the kernel reads in the
    run (`oriet::qmatmul_int8_requant`).

    On the card `packed` must be `pack_qmatmul_weight(b)`; the launch is
    counted on `qmatmul_int8` (the same kernel, requant epilogue)."""
    _check_2d("qmatmul_int8_requant", a, b)
    if isinstance(y_zp, torch.Tensor):
        return _qmatmul_int8_requant_op(a, b, as_mult(mult, a), bias, packed,
                                        0, out_dtype, y_zp)
    return _qmatmul_int8_requant_op(a, b, as_mult(mult, a), bias, packed,
                                    int(y_zp), out_dtype)
