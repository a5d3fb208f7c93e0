"""int4 weight-only matrix products, planar and interleaved, and the
nibble-unpack probe.

Hopper counterparts of the TPU kernels in
`onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul_int4.py`:
`qmatmul_int4_planar` (Pallas body `_int4_mm_planar_kernel`; the layout of
`quant.pack_int4_planar`) and `qmatmul_int4_bf16` (body `_int4_mm_kernel`;
the interleaved ORT MatMulNBits layout of `quant.pack_int4`). The CUDA
source of both is `csrc/qmatmul_int4.cu`, templated on the layout: the
weights stay packed (uint8 nibble pairs) in device memory and are unpacked
in registers by the shared device functions in `csrc/nibble.cuh`; the
source note says what bounds each schedule on the H100 and what its design
does about that.

Both take A as f32 or as bf16 (the bf16 Engine's activations; the kernel
rounds f32 A to bf16 itself, so the same values give the same result in
either type). Three schedules (`int4_schedule` picks one from the shape
before the launch): `small_m` streams the weights for decode-sized M,
`mma` runs on the bf16 tensor cores for prefill-sized M, and `general`
takes every other shape (odd quant blocks, unaligned operands). The C entry point refuses a
schedule whose constraints do not hold; the wrapper then raises.

`nibble_probe` runs one of those unpack functions alone over a uint8
array: the port of `experiments/cast_probe.py::mk`, the TPU probe of the
same unpack.

Each product is a `torch.library` operator, `oriet::qmatmul_int4_planar`
and `oriet::qmatmul_int4_bf16`: on the CPU the kernel's plain PyTorch
version (`*_plain`), on the card the launch (the schedule is picked there,
from the shapes and the operands' alignment), and a fake implementation
giving the f32 [M, n] result for torch.export. The wrappers check the
device and the layout and call the op. `nibble_probe` gets no op: no graph
calls it, it only probes the unpack on its own.
`qmatmul_int4_planar.launches`, `qmatmul_int4_bf16.launches` and
`nibble_probe.launches` count launches; `qmatmul_int4_planar.schedules` and
`qmatmul_int4_bf16.schedules` count them per schedule, their `.a_dtypes`
per type of A.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.fp32 import matmul_fp32_exact
from . import _build
from ._ops import define
from .qmatmul_int8 import check_device

__all__ = ["planar_layout", "qmatmul_int4_planar", "qmatmul_int4_planar_plain",
           "interleaved_layout", "qmatmul_int4_bf16", "qmatmul_int4_bf16_plain",
           "int4_schedule", "SCHEDULES", "A_DTYPES", "SMALL_M_MAX",
           "NIBBLE_VARIANTS", "nibble_probe", "nibble_probe_plain"]

# schedule name -> the id the C entry points take
SCHEDULES = {"general": 0, "small_m": 1, "mma": 2}
# A's dtype, by name -> (torch dtype, the id the C entry points take)
A_DTYPES = {"float32": (torch.float32, 0), "bfloat16": (torch.bfloat16, 1)}
# The largest M that goes to small_m: the crossover with mma that
# chip_smoke.py's M sweep measured on an H100 (PERF.md): at M = 16 small_m
# still wins in the planar layout but not in the interleaved one. small_m
# itself takes up to 16 rows.
SMALL_M_MAX = 8
# small_m stages A[M, K] as f32 in one block's shared memory, M rounded up
# to 8 or 16 rows, beside its 8 warps' partial sums (rows x 32 f32 each):
# at most the 227 KB an H100 block can opt into.
SMALL_M_SMEM = 232448


def int4_schedule(M: int, K: int, nblk: int, blk: int, *,
                  aligned: bool = True) -> str:
    """The schedule for an int4 product of A [M, K] with nblk quant blocks
    of blk packed bytes each (planar (nbh, bs), interleaved (nb, qbh)):
    "small_m" for M <= SMALL_M_MAX, "mma" above it (and for a small M
    whose A does not fit small_m's shared memory), and "general" where
    quant blocks are not a multiple of 16 bytes or A or the packed weights
    are not 16-byte aligned. The C entry points check the same
    constraints."""
    if not aligned or blk % 16:
        return "general"
    rows = 8 if M <= 8 else 16
    if M <= SMALL_M_MAX and (rows * K + 8 * rows * 32) * 4 <= SMALL_M_SMEM:
        return "small_m"
    return "mma"


def planar_layout(K: int, block_size: int = 256) -> Tuple[int, int]:
    """The planar pack/kernel layout contract for a [K, N] weight:
    (nbh, bs) where bs is the per-half quant block width (block_size
    shrunk by powers of 2 until it divides K//2) and nbh = (K//2) / bs is
    the number of blocks per half. Scales are stored [2*nbh, N] k-major:
    lo-half rows then hi-half rows."""
    Kh = K // 2
    bs = max(1, min(block_size, Kh))
    while Kh % bs:
        bs //= 2
    return Kh // bs, bs


def _unpack_planes(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 (e.g. [Nw, Kh]) -> the (lo, hi) nibble planes minus 8, as
    exact floats of the same shape."""
    p = packed.to(torch.int32)
    return (((p & 0xF) - 8).to(torch.float32),
            ((p >> 4) - 8).to(torch.float32))


def qmatmul_int4_planar_plain(a: torch.Tensor, packed: torch.Tensor,
                              scales: torch.Tensor, *, qblock: int = 256,
                              n: Optional[int] = None) -> torch.Tensor:
    """The TPU kernel's arithmetic: A rounded to bf16, each quant block's
    dot in f32 (exact products, f32 sums), then acc + dlo * s_lo + dhi *
    s_hi block after block. a f32 or bf16 [M, K], packed uint8 [Nw, K/2],
    scales f32 [2*nbh, Nw] -> f32 [M, n] (n defaults to Nw)."""
    M, K = a.shape
    Nw, Kh = packed.shape
    nbh, bs = planar_layout(K, qblock)
    ab = a.to(torch.bfloat16).to(torch.float32)
    lo, hi = _unpack_planes(packed)
    # [nbh, M, bs] @ [nbh, bs, Nw] -> per-block dots [nbh, M, Nw]
    blocks = lambda x, rows: x.reshape(rows, nbh, bs).transpose(0, 1)  # noqa: E731
    with matmul_fp32_exact():
        dlo = torch.bmm(blocks(ab[:, :Kh], M), blocks(lo, Nw).transpose(1, 2))
        dhi = torch.bmm(blocks(ab[:, Kh:], M), blocks(hi, Nw).transpose(1, 2))
    s = scales.to(torch.float32)
    acc = torch.zeros((M, Nw), dtype=torch.float32, device=a.device)
    for t in range(nbh):
        acc = acc + dlo[t] * s[t] + dhi[t] * s[nbh + t]
    return acc if n is None else acc[:, :n]


def interleaved_layout(K: int, packed_cols: int, n_blocks: int) -> int:
    """The interleaved layout's half-K bytes per quant block (qbh) for a
    [K, N] weight packed into [Nw, packed_cols] bytes with scales
    [Nw, n_blocks]; raises where no kernel block schedule fits: K odd, a
    packed width other than K/2, or quant blocks that do not tile K in
    whole bytes (an odd block splits a nibble pair between two scales)."""
    if (K <= 0 or K % 2 or packed_cols != K // 2 or n_blocks <= 0
            or K % n_blocks or (K // n_blocks) % 2):
        raise ValueError(f"qmatmul_int4_bf16: K={K} with {packed_cols} "
                         f"packed bytes per row and {n_blocks} quant blocks "
                         f"is not an interleaved int4 layout")
    return K // 2 // n_blocks


def qmatmul_int4_bf16_plain(a: torch.Tensor, packed: torch.Tensor,
                            scales: torch.Tensor, *,
                            n: Optional[int] = None) -> torch.Tensor:
    """The TPU kernel `_int4_mm_kernel`'s arithmetic: A rounded to bf16;
    per quant block t the f32 dot of A's even lanes with the low nibbles
    plus that of its odd lanes with the high nibbles (exact products, f32
    sums); then acc + dot * s[:, t] block after block. a f32 or bf16 [M,
    K], packed uint8 [Nw, K/2], scales f32 [Nw, nb] -> f32 [M, n] (n
    defaults to Nw)."""
    M, K = a.shape
    Nw, Kh = packed.shape
    nb = scales.shape[1]
    qbh = interleaved_layout(K, Kh, nb)
    ab = a.to(torch.bfloat16).to(torch.float32)
    lo, hi = _unpack_planes(packed)
    # [nb, M, qbh] @ [nb, qbh, Nw] -> per-block dots [nb, M, Nw]
    blocks = lambda x, rows: x.reshape(rows, nb, qbh).transpose(0, 1)  # noqa: E731
    with matmul_fp32_exact():
        dlo = torch.bmm(blocks(ab[:, 0::2], M), blocks(lo, Nw).transpose(1, 2))
        dhi = torch.bmm(blocks(ab[:, 1::2], M), blocks(hi, Nw).transpose(1, 2))
    s = scales.to(torch.float32)
    acc = torch.zeros((M, Nw), dtype=torch.float32, device=a.device)
    for t in range(nb):
        acc = acc + (dlo[t] + dhi[t]) * s[:, t]
    return acc if n is None else acc[:, :n]


def _check(fn: str, what: str, t: torch.Tensor, dtype: torch.dtype,
           dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {what} wants contiguous "
                         f"{dtype} on {dev}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def _fn(name: str, argtypes):
    fn = getattr(_build.load("qmatmul_int4"), name)
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def _int4_fake(a, packed, scales, n):
    return a.new_empty((a.shape[0], n), dtype=torch.float32)


def _planar_cpu(a, packed, scales, qblock, n):
    return qmatmul_int4_planar_plain(a, packed, scales, qblock=qblock,
                                     n=n).contiguous()


def _planar_cuda(a, packed, scales, qblock, n):
    nbh, bs = planar_layout(a.shape[1], qblock)
    return _launch(qmatmul_int4_planar, a, packed, scales, n, nbh, bs)


def _planar_fake(a, packed, scales, qblock, n):
    return _int4_fake(a, packed, scales, n)


_planar_op = define(
    "qmatmul_int4_planar(Tensor a, Tensor packed, Tensor scales, "
    "int qblock, int n) -> Tensor", _planar_cpu, _planar_cuda, _planar_fake)


def _interleaved_cpu(a, packed, scales, n):
    return qmatmul_int4_bf16_plain(a, packed, scales, n=n).contiguous()


def _interleaved_cuda(a, packed, scales, n):
    qbh = interleaved_layout(a.shape[1], packed.shape[1], scales.shape[1])
    return _launch(qmatmul_int4_bf16, a, packed, scales, n, scales.shape[1],
                   qbh)


def _interleaved_fake(a, packed, scales, n):
    return _int4_fake(a, packed, scales, n)


_interleaved_op = define(
    "qmatmul_int4_bf16(Tensor a, Tensor packed, Tensor scales, int n) "
    "-> Tensor", _interleaved_cpu, _interleaved_cuda, _interleaved_fake)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def qmatmul_int4_planar(a: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, *, qblock: int = 256,
                        n: Optional[int] = None) -> torch.Tensor:
    """Planar-packed int4 matmul: a f32 or bf16 [M, K] @ the [K, N] weight
    that `quant.pack_int4_planar(w, qblock)` packed into `packed` uint8
    [Nw, K/2] and `scales` f32 [2*nbh, Nw] -> f32 [M, n] (n <= Nw, default
    Nw; `oriet::qmatmul_int4_planar`)."""
    check_device("qmatmul_int4_planar", a)
    if a.device.type == "cpu":  # the plain version takes any shape it can
        return _planar_op(a, packed, scales, int(qblock),
                          packed.shape[0] if n is None else int(n))
    if a.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"qmatmul_int4_planar: want a [M,K], packed "
                         f"[Nw,K/2], scales [2*nbh,Nw]; got {tuple(a.shape)}, "
                         f"{tuple(packed.shape)}, {tuple(scales.shape)}")
    K = a.shape[1]
    Nw, Kh = packed.shape
    n = Nw if n is None else int(n)
    nbh, bs = planar_layout(K, qblock)
    if K % 2 or Kh != K // 2 or tuple(scales.shape) != (2 * nbh, Nw) \
            or not 0 < n <= Nw:
        raise ValueError(f"qmatmul_int4_planar: K={K}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)}, n={n} do not fit the planar "
                         f"layout (nbh={nbh}, bs={bs})")
    return _planar_op(a, packed, scales, int(qblock), n)


qmatmul_int4_planar.launches = 0
qmatmul_int4_planar.schedules = dict.fromkeys(SCHEDULES, 0)
qmatmul_int4_planar.a_dtypes = dict.fromkeys(A_DTYPES, 0)


def _launch(wrapper, a: torch.Tensor, packed: torch.Tensor,
            scales: torch.Tensor, n: int, nblk: int, blk: int,
            schedule: Optional[str] = None) -> torch.Tensor:
    """Check the operands and launch `wrapper`'s kernel (its C entry point
    is `<name>_launch`) on `schedule` (default: int4_schedule's pick) for
    A's dtype, and count the launch: out f32 [M, n]."""
    name = wrapper.__name__
    M, K = a.shape
    Nw = packed.shape[0]
    if max(M, K, Nw) >= 2 ** 31:
        raise ValueError(f"{name}: dims out of range {M, K, Nw}")
    dev = a.device
    a_dtype = next((k for k, (dt, _) in A_DTYPES.items() if dt == a.dtype),
                   "float32")
    _check(name, "a", a, A_DTYPES[a_dtype][0], dev)
    _check(name, "packed", packed, torch.uint8, dev)
    _check(name, "scales", scales, torch.float32, dev)
    if schedule is None:
        schedule = int4_schedule(M, K, nblk, blk, aligned=(
            a.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0))
    out = torch.empty((M, n), dtype=torch.float32, device=dev)
    fn = _fn(f"{name}_launch",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), M, K, n, Nw, nblk, blk, SCHEDULES[schedule],
                 A_DTYPES[a_dtype][1], _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: launch on schedule {schedule} with "
                           f"{a_dtype} A failed with cudaError {err}")
    wrapper.launches += 1
    wrapper.schedules[schedule] += 1
    wrapper.a_dtypes[a_dtype] += 1
    return out


def qmatmul_int4_bf16(a: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, *, n: Optional[int] = None
                      ) -> torch.Tensor:
    """Interleaved-packed int4 matmul: a f32 or bf16 [M, K] @ the [K, N]
    weight that `quant.pack_int4(w, qblock)` packed into `packed` uint8
    [Nw, K/2] and `scales` f32 [Nw, K/qblock] -> f32 [M, n] (n <= Nw,
    default Nw; `oriet::qmatmul_int4_bf16`)."""
    check_device("qmatmul_int4_bf16", a)
    if a.device.type == "cpu":  # the plain version takes any shape it can
        return _interleaved_op(a, packed, scales,
                               packed.shape[0] if n is None else int(n))
    if a.dim() != 2 or packed.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"qmatmul_int4_bf16: want a [M,K], packed "
                         f"[Nw,K/2], scales [Nw,nb]; got {tuple(a.shape)}, "
                         f"{tuple(packed.shape)}, {tuple(scales.shape)}")
    K = a.shape[1]
    Nw, Kh = packed.shape
    nb = scales.shape[1]
    qbh = interleaved_layout(K, Kh, nb)
    n = Nw if n is None else int(n)
    if scales.shape[0] != Nw or not 0 < n <= Nw:
        raise ValueError(f"qmatmul_int4_bf16: packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, n={n} do not fit "
                         f"the interleaved layout")
    return _interleaved_op(a, packed, scales, n)


qmatmul_int4_bf16.launches = 0
qmatmul_int4_bf16.schedules = dict.fromkeys(SCHEDULES, 0)
qmatmul_int4_bf16.a_dtypes = dict.fromkeys(A_DTYPES, 0)


# the unpack device functions of csrc/nibble.cuh, by the schedule that uses
# them: int (general), f32 (small_m), bf16_pairs (mma, interleaved),
# bf16_planes (mma, planar)
NIBBLE_VARIANTS = ("int", "f32", "bf16_pairs", "bf16_planes")


def nibble_probe_plain(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 -> (low nibble - 8, high nibble - 8) as f32, elementwise."""
    return _unpack_planes(p)


def nibble_probe(p: torch.Tensor, variant: str = "int"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One of the int4 kernels' in-register unpacks (csrc/nibble.cuh, see
    NIBBLE_VARIANTS) applied to every byte of p: uint8 -> (lo, hi) f32,
    each of p's shape. Every variant gives the plain version's values."""
    if variant not in NIBBLE_VARIANTS:
        raise ValueError(f"nibble_probe: variant {variant!r} is not one of "
                         f"{NIBBLE_VARIANTS}")
    if p.device.type == "cpu":
        return nibble_probe_plain(p)
    if p.device.type != "cuda":
        raise ValueError(f"nibble_probe: no kernel for {p.device}")
    if p.dtype != torch.uint8 or not p.is_contiguous():
        raise ValueError(f"nibble_probe: want contiguous uint8, got {p.dtype} "
                         f"(contiguous={p.is_contiguous()})")
    lo = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    hi = torch.empty_like(lo)
    fn = _fn("nibble_probe_launch", [ctypes.c_void_p] * 3
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), lo.data_ptr(), hi.data_ptr(), p.numel(),
                 NIBBLE_VARIANTS.index(variant), _stream(p.device))
    if err != 0:
        raise RuntimeError(f"nibble_probe: launch failed with cudaError {err}")
    nibble_probe.launches += 1
    return lo, hi


nibble_probe.launches = 0
