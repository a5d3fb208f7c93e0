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

Each wrapper takes a tensor on the CPU to the kernel's plain PyTorch version
(`*_plain`), and launches the kernel for a tensor on the card, or raises.
Each wrapper's `.launches` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..standard import matmul_fp32_exact
from . import _build

__all__ = ["decode_attention_int8", "decode_attention_int8_plain",
           "decode_attention_int8_mxu", "decode_attention_int8_mxu_plain"]


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


def _launch(name: str, q, k8, v8, bias, n_q_heads: int) -> torch.Tensor:
    B, H, Hkv, L, hd = _dims(q, k8, n_q_heads)
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
    if hd > 256 or max(B * H, L * hd) >= 2 ** 31:
        raise ValueError(f"{name}: hd={hd} (at most 256) or sizes out of "
                         f"range")
    out = torch.empty((B * H, 1, hd), dtype=torch.float32, device=dev)
    fn = getattr(_build.load("decode_attn"), f"{name}_launch")
    if fn.argtypes is None:  # untyped, ctypes would pass 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, Hkv, L, hd,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError {err}")
    return out


def decode_attention_int8(q: torch.Tensor, k8: torch.Tensor,
                          v8: torch.Tensor, bias: torch.Tensor, *,
                          n_q_heads: int) -> torch.Tensor:
    """Fused decode attention in f32 -> f32 [B*H, 1, hd]."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k8, v8, bias,
                                           n_q_heads=n_q_heads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: no kernel for {q.device}")
    out = _launch("decode_attention_int8", q, k8, v8, bias, n_q_heads)
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0


def decode_attention_int8_mxu(q: torch.Tensor, k8: torch.Tensor,
                              v8: torch.Tensor, bias: torch.Tensor, *,
                              n_q_heads: int) -> torch.Tensor:
    """int8 x int8 fused decode attention -> f32 [B*H, 1, hd]."""
    if q.device.type == "cpu":
        return decode_attention_int8_mxu_plain(q, k8, v8, bias,
                                               n_q_heads=n_q_heads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8_mxu: no kernel for "
                         f"{q.device}")
    out = _launch("decode_attention_int8_mxu", q, k8, v8, bias, n_q_heads)
    decode_attention_int8_mxu.launches += 1
    return out


decode_attention_int8_mxu.launches = 0
