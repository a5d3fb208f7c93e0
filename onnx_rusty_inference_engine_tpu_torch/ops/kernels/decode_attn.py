"""Fused single-token (decode) attention over an int8 KV cache.

Hopper counterparts of the TPU kernels
`onnx_rusty_inference_engine_tpu/ops/kernels/decode_attn.py::
decode_attention_int8` (Pallas body `_decode_attn_kernel`) and
`::decode_attention_int8_mxu` (`_decode_attn_i8_kernel`). The CUDA source is
`csrc/decode_attn.cu`; its note says what bounds the kernels on the H100 and
what their design does about that.

Both take the TPU kernels' arguments: q [B*H, 1, hd] already scaled by
k_scale[h] / sqrt(hd), the int8 cache k8 / v8 [B*Hkv, L, hd] and an additive
bias [B, 1, L]; query head h reads kv head h // (H // Hkv). They return f32
[B*H, 1, hd]; the caller applies v_scale[h] (ops/fused.py).

`decode_attention_int8` computes in f32: its plain version is the JAX
emitter's fp32 fallback (onnx_rusty_inference_engine_tpu/ops/fused.py) with
the scales folded as the kernel receives them. The TPU kernel rounded q and
p to bf16 for its dots; this one does not. `decode_attention_int8_mxu`
keeps the TPU kernel's int8 x int8 arithmetic step for step.

Each kernel is a `torch.library` operator, `oriet::decode_attention_int8`
and `oriet::decode_attention_int8_mxu`: on the CPU the kernel's plain
PyTorch version (`*_plain`), on the card the launch (the cluster size is
picked there, from the shapes), and a fake implementation giving the f32
[B*H, 1, hd] result for torch.export. The wrappers raise for a tensor on
neither device and call the op. Each wrapper's `.launches` counts its
kernel's launches (in the card's implementation).

Two plain functions describe what a launch does: `attn_split` picks the
cluster size C (the CTAs that split one (batch, kv group)'s cache rows), and
`attn_live_chunks` says which cache rows the kernel loads: it skips a row
only where the plain version's term is provably exactly 0.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.fp32 import matmul_fp32_exact
from . import _build
from ._ops import define
from .qmatmul_int8 import check_device

__all__ = ["decode_attention_int8", "decode_attention_int8_plain",
           "decode_attention_int8_mxu", "decode_attention_int8_mxu_plain",
           "attn_split", "attn_live_chunks"]

SMS = 132              # the H100 SXM's streaming multiprocessors
MAX_CLUSTER = 8        # the portable thread block cluster size
NK = 4                 # 16-byte K (and V) loads a kernel thread has in flight
SCORES_MAX_BYTES = 128 * 1024  # a CTA's scores in shared memory, at most


def _lanes_per_row(hd: int) -> int:
    """Lanes that read one cache row, 16 bytes each (a power of two)."""
    lanes = 1
    while 16 * lanes < hd:
        lanes *= 2
    return lanes


def attn_split(B: int, H: int, Hkv: int, L: int, hd: int) -> int:
    """The kernel's cluster size C in {1, 2, 4, 8}: the CTAs that split one
    (batch, kv group)'s L cache rows into contiguous chunks of ceil(L / C).

    C doubles while B * Hkv * C CTAs leave some of the card's SMS idle (or
    the rep scores of a chunk would not fit in shared memory), as long as
    the halved chunk still holds one warp's rows: the rows a warp loads in
    one batch of NK 16-byte loads a lane. Every chunk is then non-empty."""
    if min(B, H, Hkv, L, hd) <= 0 or H % Hkv:
        raise ValueError(f"attn_split: B={B}, H={H}, Hkv={Hkv}, L={L}, "
                         f"hd={hd}")
    rep = H // Hkv
    warp_rows = NK * 32 // _lanes_per_row(hd)
    c = 1
    while (c < MAX_CLUSTER and -(-L // (2 * c)) >= warp_rows
           and (B * Hkv * c < SMS
                or rep * -(-L // c) * 4 > SCORES_MAX_BYTES)):
        c *= 2
    return c


def attn_live_chunks(q: torch.Tensor, bias: torch.Tensor, *, n_q_heads: int,
                     n_kv_heads: int, mxu: bool = False) -> torch.Tensor:
    """bool [B, Hkv, L]: whether cache row l of a (batch, kv group) may add
    a non-zero term. The kernel decides row by row (each row a chunk of
    one), and loads the K and V rows of live ones only.

    Bq bounds |score - bias| for the group's query rows: 128 * max_r
    |q_r|_1 (the f32 form; int8 keys lie in [-128, 127]), or 128 * max_r
    (|q8_r|_1 * sq) (the int8 x int8 form, its q scale sq and q8 as the
    plain version makes them). With M the batch row's largest bias, row l
    is dead when

        bias[l] + Bq < M - Bq - 128 - 2^-22 (|bias[l]| + |M| + 2 Bq):

    its scores sit more than 128 below the row's max (the row holding M
    scores at least M - Bq), the margin 2^-22 (...) covering the
    f32 rounding of score + bias and of s - max, so expf(s - max) is 0.0f
    and the plain version's term is exactly 0 (p8 = 0 in the int8 form).
    Evaluated in f32 in the kernel's order; |q_r|_1 in float64 rounded to
    f32, as the kernel sums it."""
    BH, one, hd = q.shape
    B, L = bias.shape[0], bias.shape[-1]
    H, Hkv = int(n_q_heads), int(n_kv_heads)
    rep = H // Hkv
    if BH != B * H or H % Hkv or one != 1:
        raise ValueError(f"attn_live_chunks: q {tuple(q.shape)}, bias "
                         f"{tuple(bias.shape)}, H={H}, Hkv={Hkv}")
    qg = q.reshape(B, Hkv, rep, hd).to(torch.float32)
    if mxu:
        q127 = torch.tensor(127.0, dtype=torch.float32, device=q.device)
        sq = qg.abs().amax(dim=(2, 3)).clamp_min(1e-9) / q127     # [B, Hkv]
        q8 = torch.round(qg / sq[..., None, None])
        bq = q8.abs().sum(-1).amax(-1) * sq                       # exact sums
    else:
        bq = qg.double().abs().sum(-1).to(torch.float32).amax(-1)
    bq = (bq * 128.0)[..., None]                                  # [B, Hkv, 1]
    b = bias.reshape(B, 1, L).to(torch.float32)
    m = b.amax(-1, keepdim=True)                                  # [B, 1, 1]
    lhs = b + bq
    eps = ((b.abs() + m.abs()) + bq * 2.0) * 2.0 ** -22
    rhs = ((m - bq) - 128.0) - eps
    return ~(lhs < rhs)


def _dims(q, k8, n_q_heads: int):
    BH, one, hd = q.shape
    H = int(n_q_heads)
    BHkv, L, hd2 = k8.shape
    if one != 1 or hd2 != hd or BH % H:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, k8 "
                         f"{tuple(k8.shape)}, n_q_heads={H} do not fit "
                         f"q [B*H,1,hd], k8 [B*Hkv,L,hd]")
    B = BH // H
    if BHkv % B or H % (BHkv // B):
        raise ValueError(f"decode attention: {BHkv} kv rows for batch {B} "
                         f"and {H} query heads")
    return B, H, BHkv // B, L, hd


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """exp(s - max) / sum over the last dim, as jax.nn.softmax writes it."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def decode_attention_int8_plain(q: torch.Tensor, k8: torch.Tensor,
                                v8: torch.Tensor, bias: torch.Tensor, *,
                                n_q_heads: int) -> torch.Tensor:
    """softmax(q . k8^T + bias) . v8 in f32 -> f32 [B*H, 1, hd]."""
    B, H, Hkv, L, hd = _dims(q, k8, n_q_heads)
    rep = H // Hkv
    k = k8.reshape(B, Hkv, L, hd).to(torch.float32)
    v = v8.reshape(B, Hkv, L, hd).to(torch.float32)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    with matmul_fp32_exact():
        s = torch.matmul(q.reshape(B, H, 1, hd).to(torch.float32),
                         k.transpose(-1, -2)) + bias.reshape(B, 1, 1, L)
        out = torch.matmul(_softmax(s), v)
    return out.reshape(B * H, 1, hd)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued float tensors (float64 sums of int8
    products are exact), back in f32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def decode_attention_int8_mxu_plain(q: torch.Tensor, k8: torch.Tensor,
                                    v8: torch.Tensor, bias: torch.Tensor, *,
                                    n_q_heads: int) -> torch.Tensor:
    """The int8 x int8 form: per (batch, kv group) q scale amax/127, exact
    int scores, f32 softmax, per-group prob scale pmax/127, exact int
    p8 . v8 -> f32 [B*H, 1, hd]."""
    B, H, Hkv, L, hd = _dims(q, k8, n_q_heads)
    rep = H // Hkv
    # divisions by a tensor on q's device: true divisions on the card too
    # (a CPU scalar divisor becomes a multiply by its reciprocal there)
    q127 = torch.tensor(127.0, dtype=torch.float32, device=q.device)
    qg = q.reshape(B, Hkv, rep, hd).to(torch.float32)
    sq = qg.abs().amax(dim=(2, 3), keepdim=True).clamp_min(1e-9) / q127
    q8 = torch.round(qg / sq)
    k = k8.reshape(B, Hkv, L, hd)
    s = _int_dot(q8, k.transpose(-1, -2)) * sq + bias.reshape(B, 1, 1, L)
    p = _softmax(s)
    sp = p.amax(dim=(2, 3), keepdim=True).clamp_min(1e-9) / q127
    p8 = torch.round(p / sp)
    out = _int_dot(p8, v8.reshape(B, Hkv, L, hd)) * sp
    return out.reshape(B * H, 1, hd)


def _launch(name: str, q, k8, v8, bias, n_q_heads: int, *,
            split: int | None = None,
            rows_read: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel `name` on the card; `split` overrides attn_split's C,
    and an int32 [1] `rows_read` on the card gets the K rows it loaded
    added."""
    B, H, Hkv, L, hd = _dims(q, k8, n_q_heads)
    C = attn_split(B, H, Hkv, L, hd) if split is None else int(split)
    dev = q.device
    for what, t, dtype, shape in (("q", q, torch.float32, (B * H, 1, hd)),
                                  ("k8", k8, torch.int8, (B * Hkv, L, hd)),
                                  ("v8", v8, torch.int8, (B * Hkv, L, hd)),
                                  ("bias", bias, torch.float32, (B, 1, L))):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name}: {what} wants contiguous {dtype} "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} (contiguous="
                             f"{t.is_contiguous()})")
    if hd > 256 or max(B * H * C, L * hd) >= 2 ** 31:
        raise ValueError(f"{name}: hd={hd} (at most 256) or sizes out of "
                         f"range")
    if rows_read is not None and (rows_read.device != dev
                                  or rows_read.dtype != torch.int32):
        raise ValueError(f"{name}: rows_read wants int32 on {dev}")
    out = torch.empty((B * H, 1, hd), dtype=torch.float32, device=dev)
    fn = getattr(_build.load("decode_attn"), f"{name}_launch")
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, Hkv, L, hd, C,
                 None if rows_read is None else rows_read.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err} "
                           f"(cluster {C}; shared memory holds the "
                           f"{H // Hkv} x ceil(L / C) scores of a CTA)")
    return out


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------
def _attn_cpu(q, k8, v8, bias, n_q_heads):
    return decode_attention_int8_plain(q, k8, v8, bias, n_q_heads=n_q_heads)


def _attn_cuda(q, k8, v8, bias, n_q_heads):
    out = _launch("decode_attention_int8", q, k8, v8, bias, n_q_heads)
    decode_attention_int8.launches += 1
    return out


def _attn_mxu_cpu(q, k8, v8, bias, n_q_heads):
    return decode_attention_int8_mxu_plain(q, k8, v8, bias,
                                           n_q_heads=n_q_heads)


def _attn_mxu_cuda(q, k8, v8, bias, n_q_heads):
    out = _launch("decode_attention_int8_mxu", q, k8, v8, bias, n_q_heads)
    decode_attention_int8_mxu.launches += 1
    return out


def _attn_fake(q, k8, v8, bias, n_q_heads):
    return q.new_empty(q.shape, dtype=torch.float32)


_ATTN_SCHEMA = ("(Tensor q, Tensor k8, Tensor v8, Tensor bias, int n_q_heads)"
                " -> Tensor")
_attn_op = define("decode_attention_int8" + _ATTN_SCHEMA, _attn_cpu,
                  _attn_cuda, _attn_fake)
_attn_mxu_op = define("decode_attention_int8_mxu" + _ATTN_SCHEMA,
                      _attn_mxu_cpu, _attn_mxu_cuda, _attn_fake)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def decode_attention_int8(q: torch.Tensor, k8: torch.Tensor,
                          v8: torch.Tensor, bias: torch.Tensor, *,
                          n_q_heads: int) -> torch.Tensor:
    """Fused decode attention in f32 -> f32 [B*H, 1, hd]
    (`oriet::decode_attention_int8`)."""
    check_device("decode_attention_int8", q)
    return _attn_op(q, k8, v8, bias, int(n_q_heads))


decode_attention_int8.launches = 0


def decode_attention_int8_mxu(q: torch.Tensor, k8: torch.Tensor,
                              v8: torch.Tensor, bias: torch.Tensor, *,
                              n_q_heads: int) -> torch.Tensor:
    """int8 x int8 fused decode attention -> f32 [B*H, 1, hd]
    (`oriet::decode_attention_int8_mxu`)."""
    check_device("decode_attention_int8_mxu", q)
    return _attn_mxu_op(q, k8, v8, bias, int(n_q_heads))


decode_attention_int8_mxu.launches = 0
