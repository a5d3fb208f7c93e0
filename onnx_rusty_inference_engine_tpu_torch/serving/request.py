"""Request state and token selection for the serving stack.

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/
request.py. `_Request`, the host sampler `_select_token` (numpy, seeded per
request), `_hits_stop` and the logit epilogue `_bias_penalize` carry over
as they are. `_device_select`, the per-slot sampler of the K-step blocks,
cannot draw JAX's PRNG bits: its uniforms come from a counter-based hash of
(the slot's seed, the cache position, the vocabulary index) in plain
integer tensor ops, so a request's stream depends on neither K nor the
requests beside it, and the whole selection can be captured in a CUDA
graph.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch


class _Request:
    __slots__ = ("prompt", "max_new", "eos_id", "stop_sequences",
                 "future", "tokens", "adapter",
                 "temperature", "top_k", "top_p", "min_p", "rng", "seed",
                 "on_token", "logit_bias", "cancelled",
                 "frequency_penalty", "presence_penalty",
                 "t_enqueue")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int] = None,
                 stop_sequences: Optional[List[List[int]]] = None,
                 adapter: int = 0,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 min_p: Optional[float] = None,
                 seed: int = 0,
                 on_token=None,
                 logit_bias: Optional[Dict[int, float]] = None,
                 frequency_penalty: float = 0.0,
                 presence_penalty: float = 0.0):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.stop_sequences = [list(q) for q in (stop_sequences or [])]
        self.adapter = int(adapter)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.frequency_penalty = float(frequency_penalty)
        self.presence_penalty = float(presence_penalty)
        # per-request PRNG: sampling is deterministic in (seed, prompt
        # order) and independent across concurrent slots
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.on_token = on_token
        self.cancelled = False
        # additive per-token bias (OpenAI-style logit_bias): applied to
        # every selection step, greedy included; -inf-like values ban
        self.logit_bias = None
        if logit_bias:
            idx = np.fromiter((int(k) for k in logit_bias), np.int64)
            val = np.fromiter((float(v) for v in logit_bias.values()),
                              np.float64)
            self.logit_bias = (idx, val)
        self.future: Future = Future()
        self.tokens: List[int] = []
        self.t_enqueue = time.perf_counter()

    def emit(self, tok: int) -> None:
        """Append a generated token; stream it to the caller if asked.
        A broken callback must not poison the dispatcher (other slots'
        tokens ride the same step)."""
        self.tokens.append(tok)
        if self.on_token is not None:
            try:
                self.on_token(tok)
            except Exception:
                self.on_token = None


def _select_token(logits: np.ndarray, r: _Request) -> int:
    """Host-side per-request token selection: greedy at temperature 0,
    else categorical over temperature-scaled logits with optional top-k /
    nucleus / min-p filtering — the same filtering semantics as
    generate.Generator._select, per slot instead of per batch.
    frequency/presence penalties (OpenAI semantics) subtract from the
    logits of already-generated tokens before anything else, greedy
    included."""
    if (r.frequency_penalty or r.presence_penalty) and r.tokens:
        logits = logits.astype(np.float64).copy()
        seen, counts = np.unique(np.asarray(r.tokens, np.int64),
                                 return_counts=True)
        logits[seen] -= (r.frequency_penalty * counts
                         + r.presence_penalty)
    if r.logit_bias is not None:
        idx, val = r.logit_bias
        logits = logits.astype(np.float64).copy()
        logits[idx] += val
    if r.temperature == 0.0:
        return int(logits.argmax())
    l = logits.astype(np.float64) / r.temperature
    if r.top_k is not None:
        # clamp to [1, V]: an oversized top_k means "no filtering", and a
        # crash here would take down every slot sharing the step
        k = max(1, min(int(r.top_k), l.size))
        kth = np.sort(l)[-k]
        l = np.where(l >= kth, l, -np.inf)
    if r.top_p is not None:
        sl = np.sort(l)[::-1]
        probs = np.exp(sl - sl[0])
        probs /= probs.sum()
        cum = np.cumsum(probs)
        keep = cum - probs < r.top_p
        thresh = sl[keep].min() if keep.any() else sl[0]
        l = np.where(l >= thresh, l, -np.inf)
    if r.min_p is not None:
        # keep tokens whose probability >= min_p * p_max (the min-p
        # sampler): scale-invariant tail cutoff
        pm = np.exp(l - l[np.isfinite(l)].max())
        l = np.where(pm >= r.min_p, l, -np.inf)
    p = np.exp(l - l.max())
    p /= p.sum()
    return int(r.rng.choice(l.size, p=p))


def _bias_penalize(logits, bias, fpen, ppen, counts):
    """Shared logit epilogue of every multi_step block: additive
    logit_bias rows + OpenAI frequency/presence penalties from the
    per-slot generated-token histogram."""
    cf = counts.to(torch.float32)
    return logits + bias - (fpen[:, None] * cf
                            + ppen[:, None] * (cf > 0).to(torch.float32))


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), without overflowing
    int64: the 16-bit halves of x are multiplied apart."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of [0, 2**32) that mixes every bit (lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seeds: torch.Tensor, pos: torch.Tensor, V: int,
             draw: int = 0) -> torch.Tensor:
    """Uniforms in (0, 1), [B, V] float32, a function of (seed, position,
    draw index, column) only: row b, column v is hash(t_b ^ v) to 24 bits,
    where t_b = hash(hash(seed_b) ^ pos_b), hashed once more with `draw`
    where it is not 0. Draw 0 is the stream of _device_select; the
    speculative server's rounds take several draws at one position, each
    under its own index."""
    s = _hash32(_hash32(seeds & _M32) ^ ((seeds >> 32) & _M32))
    t = _hash32(s ^ (pos.to(torch.int64) & _M32))              # [B]
    if draw:
        t = _hash32(t ^ (int(draw) & _M32))
    v = torch.arange(V, dtype=torch.int64, device=seeds.device)
    x = _hash32(t[:, None] ^ v[None, :])                          # [B, V]
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _device_select(logits, seeds, pos, temp, tk, tp, mp):
    """On-device per-slot token selection for the multi_step blocks:
    [B, V] logits -> [B] tokens. Same filtering semantics as the host
    _select_token, vectorized per slot; neutral params (temp 0, tk = V,
    tp 1.0, mp 0.0) reduce a row to exact argmax. Randomness is keyed on
    (per-slot seed, cache position): deterministic in (seed, prompt),
    invariant to K and to co-resident traffic. Nothing here reads the
    device: it may be captured."""
    B, V = logits.shape
    ninf = -float("inf")
    greedy = torch.argmax(logits, dim=-1)
    l = logits / torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    sl = torch.sort(l, dim=-1).values                      # ascending
    kth = sl.gather(1, (V - tk).to(torch.int64)[:, None])
    l = torch.where(l >= kth, l, ninf)
    # descending sorted view of the top-k-masked row, from the ONE sort
    # above (masking the sorted array == sorting the masked array)
    sld = torch.where(sl >= kth, sl, ninf).flip(-1)
    probs = torch.softmax(sld, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < tp[:, None]
    # host parity: an empty keep set (top_p == 0) keeps the top-1
    thresh = torch.where(keep.any(dim=-1, keepdim=True),
                         torch.where(keep, sld, float("inf")).amin(
                             dim=-1, keepdim=True),
                         sld[:, :1])
    l = torch.where(l >= thresh, l, ninf)
    pm = torch.exp(l - l.amax(dim=-1, keepdim=True))
    l = torch.where(pm >= mp[:, None], l, ninf)
    u = _uniform(seeds, pos, V)
    samp = torch.argmax(l - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temp > 0, samp, greedy)


def _hits_stop(r: "_Request") -> bool:
    """True when r.tokens ends with any registered stop sequence."""
    for q in r.stop_sequences:
        if q and len(r.tokens) >= len(q) and r.tokens[-len(q):] == q:
            return True
    return False

