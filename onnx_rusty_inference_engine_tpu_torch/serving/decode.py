"""DecodeServer: token-level continuous batching for the decoder families
(gpt2, llama, and families registered with models.register_decoder_family).

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/
decode.py. One decode graph over a fixed pool of B slots runs every step;
finished sequences free their slot and newly admitted prompts are
prefilled into it while the other slots keep generating. Per-slot cache
offsets are native to the decode graph (pos [B]), so admission never
disturbs resident sequences.

On the card every graph the server runs is a CUDA graph: each prefill
bucket and each single decode step through `Engine.__call__` (captured on
a signature's first call), and with `multi_step=K` the K decode steps of a
block, selection included, as one graph per cache length
(decode_multi.py). The KV cache lives on the device; admission writes a
slot's rows in place.

Mechanics (as in the reference): prompts are right-padded to a prefill
bucket; padded positions write garbage K/V beyond the true prompt, which
the decode graph's per-slot mask (k <= pos) hides until the step that
reaches each row overwrites it, so served tokens are exactly the isolated
generation's. Inactive slots park at pos = max_len - 1. The KV cache can
be INT8 (kv_dtype="int8") or INT4 nibble-packed (kv_dtype="int4", gpt2 and
llama): the decode graph carries the QDQ, and the server quantizes prefill
K/V into the slot with the same per-head scales it feeds the graph. Cache
shapes come from the decode graph (GQA families carry n_kv_head heads).

`prefill_dtype` sets the bucketed prefill Engines' scheme, as in JAX:
"float32", "bfloat16", or "w8a8" (a bf16 Engine on the graph
quant.quantize_matmuls_w8a8 rewrote, in place of the prefill's int4
quantization); the decode engines keep theirs, and share no float weight
with a bf16 prefill Engine. Chunked prefill has no prefill engines and
refuses any other prefill_dtype than "float32".

`lora_bank` attaches a multi-LoRA bank (lora.py) to every graph the
server runs (decode, shadow, each prefill bucket), after the int4 rewrite
as generate.Generator attaches it, so a served row computes what an
isolated Generator on its adapter computes. (The JAX server attaches
before the int4 rewrite, which then quantizes a bank's stacked matrices
once they reach 4,096 elements.) `submit(adapter=k)` writes k into the
slot's entry of the `lora_idx` device buffer when the slot is filled;
every step and block reads that buffer, so one captured graph serves a
mixed-adapter batch. The prompt cache is keyed by (adapter, prompt).

`mesh` / `param_sharding_fn` shard every Engine the server runs
(parallel/spmd.py). Serving on a mesh is SPMD: every rank runs its own
server with the same submissions in the same order (pre-queue them with
autostart=False, then `start()`), so that the dispatchers issue their
collectives in the same order; with the process group's `timeout` a dead
peer fails the survivors' step, and the step's failure (or the watchdog's
`step_timeout`) fails every pending future instead of hanging.
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine import Engine, _fetch, resolve_device
from ..graph import import_model
from .base import _ServerBase
from .decode_multi import _MultiStepMixin
from .request import _Request, _hits_stop, _select_token


class DecodeServer(_MultiStepMixin, _ServerBase):
    """Continuous-batching generation server over a slot pool.

    Parameters
    ----------
    cfg: model config, any with `n_layer` and `vocab_size` (weights are
        seeded; same seed == same weights as generate.Generator and as the
        JAX package's server).
    slots: decode batch size B, resident sequences generated per step.
    prompt_len: prefill graph length; prompts are right-padded to it.
    max_len: fixed KV-cache length.
    kv_dtype: "float32", "int8" or "int4" (in-graph QDQ cache; int4 packs
        two values a byte, scales amax / 7).
    len_buckets: ascending cache lengths ending at max_len. The pool runs
        at the smallest bucket covering what live requests still need:
        one decode Engine (and graph) per bucket, weights shared, cache
        rows padded or sliced on a switch.
    multi_step: K > 0 runs K decode steps per dispatch as one graph.
    device: where it runs; "cuda" (the default) raises when no card is
        present, only an explicit "cpu" runs on the CPU.
    """

    def __init__(
        self,
        cfg,
        *,
        slots: int = 4,
        prompt_len: int = 8,
        max_len: int = 32,
        kv_dtype: str = "float32",
        int4_weights: bool = False,
        seed: int = 0,
        mesh=None,
        param_sharding_fn=None,
        family: str = "gpt2",
        prompt_buckets: Optional[Sequence[int]] = None,
        prefill_dtype: str = "float32",
        chunked_prefill: bool = False,
        chunk: int = 8,
        multi_step: int = 0,
        prompt_cache: int = 0,
        lora_bank=None,
        lora_alpha: float = 16.0,
        autostart: bool = True,
        len_buckets: Optional[Sequence[int]] = None,
        device="cuda",
    ):
        if chunked_prefill and prefill_dtype != "float32":
            raise ValueError(
                f"prefill_dtype={prefill_dtype!r} has no effect with "
                "chunked_prefill=True (prompts ride the decode chunk "
                "graph, there are no prefill engines); drop the knob or "
                "use bucketed prefill")
        self.device = resolve_device(device)
        self._ekw = dict(device=self.device, mesh=mesh,
                         param_sharding_fn=param_sharding_fn)
        self.cfg = cfg
        self.B = slots
        self.prompt_len = prompt_len
        self.max_len = max_len
        # int4: the nibble-packed [B,H,L,hd/2] int8 cache; it takes every
        # int8 path, only the packing and the amax/7 scales differ
        self._int4_kv = kv_dtype == "int4"
        self.kv_dtype = np.dtype(np.int8 if self._int4_kv else kv_dtype)
        self._kv_qmax = 7.0 if self._int4_kv else 127.0
        # prompts pad to the smallest bucket >= their length: one prefill
        # Engine (one graph) per bucket, made on first use
        self.prompt_buckets = tuple(sorted(prompt_buckets or (prompt_len,)))
        assert chunked_prefill or self.prompt_buckets[-1] == prompt_len

        from ..models import decoder_family

        build_prefill, build_decode, int8_kv_ok = decoder_family(family)
        if self._int4_kv and family not in ("gpt2", "llama", "moe"):
            raise NotImplementedError(
                "int4 KV serving needs a nibble-packing decode graph (gpt2 "
                "and llama, and moe)")
        if self.kv_dtype == np.int8 and not int8_kv_ok:
            raise NotImplementedError(
                f"{family}: in-graph INT8 KV cache not implemented")
        # chunked prefill: ONE chunk-C decode graph serves both prompt
        # ingestion (C tokens/step into a slot) and decoding (1 real
        # token/step), prompts of any length <= max_len
        self.chunked = bool(chunked_prefill)
        self.chunk = int(chunk)
        if self.chunked and self.chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.multi_step = int(multi_step)
        # the K-step blocks' graphs: (kind, cache length) -> its Replay
        self._blocks: Dict[tuple, object] = {}
        # prompt/prefix KV cache: up to `prompt_cache` prompts' rows (in
        # the cache dtype, on the device), LRU. Bucketed-prefill mode
        # reuses EXACT prompt matches; chunked mode the longest PREFIX.
        self.prompt_cache = int(prompt_cache)
        self._pcache: "OrderedDict[bytes, dict]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        dkw = {"kv_dtype": kv_dtype} if int8_kv_ok else {}
        if self.chunked:
            dkw["chunk"] = self.chunk
        pkw = {"past_len": 0} if family == "gpt2" else {}

        self._len_buckets: Optional[Tuple[int, ...]] = None
        if len_buckets is not None:
            bks = tuple(sorted(int(b) for b in len_buckets))
            if not bks or bks[-1] != max_len:
                raise ValueError("len_buckets must end at max_len")
            self._len_buckets = bks
        # chunked int8/int4: the shadow-calibration phase runs at max_len
        # (the shadow graph's only length); buckets engage after the flip
        self._cur_len = max_len if (
            self.chunked and self.kv_dtype == np.int8
            or self._len_buckets is None) else self._len_buckets[0]
        self.cache_resizes = 0

        self._lora = lora_bank is not None

        def quantized(g):
            """The int4 rewrite, then the adapter bank (fp32)."""
            if int4_weights:
                from ..quant import quantize_weights_int4

                g = quantize_weights_int4(g)
            return attach(g)

        def attach(g):
            if not self._lora:
                return g
            from ..lora import attach_lora

            return attach_lora(g, lora_bank, alpha=lora_alpha)

        def make_decode_graph(L: int):
            return quantized(import_model(build_decode(
                cfg, batch=slots, max_len=L, seed=seed, **dkw)))

        self._make_decode_graph = make_decode_graph
        # chunked + int8/int4 KV: no bucketed prefill exists to calibrate
        # the per-head scales from, so steps run a SHADOW fp32 chunk graph
        # (same weights) until the first request finishes prefilling; the
        # fp32 cache (unpacked: int4's packed cache halves the hd axis) is
        # then quantized once and serving goes on in the quantized cache
        self._shadow = None
        if self.chunked and self.kv_dtype == np.int8:
            self._shadow = Engine(quantized(import_model(build_decode(
                cfg, batch=slots, max_len=max_len, seed=seed,
                chunk=self.chunk))), **self._ekw)
        self._prefill_engines: Dict[int, Engine] = {}
        w8a8_prefill = prefill_dtype == "w8a8"

        def make_prefill(bucket: int) -> Engine:
            g = import_model(build_prefill(
                cfg, batch=1, seq_len=bucket, with_presents=True,
                seed=seed, **pkw))
            if w8a8_prefill:
                from ..quant import quantize_matmuls_w8a8

                g = quantize_matmuls_w8a8(attach(g))
            else:
                g = quantized(g)
            return Engine(g, dtype=(
                "bfloat16" if w8a8_prefill else prefill_dtype), **self._ekw)

        self._make_prefill = make_prefill
        # decode engines keyed by cache length; all share ONE set of
        # device weights (the length only changes the cache and tables)
        self._decode_engines: Dict[int, Engine] = {
            self._cur_len: Engine(make_decode_graph(self._cur_len),
                                  **self._ekw)}

        cache_t = torch.int8 if self.kv_dtype == np.int8 else torch.float32
        # the shadow-calibration phase keeps the cache fp32
        boot_t = torch.float32 if self._shadow is not None else cache_t
        shape_src = (self._shadow.graph if self._shadow is not None
                     else self.decode.graph)
        self._cache: Dict[str, torch.Tensor] = {
            spec.name: torch.zeros(spec.concrete_shape(batch=slots),
                                   dtype=boot_t, device=self.device)
            for spec in shape_src.inputs if spec.name.startswith("past_")}
        self._kv_scales: Optional[Dict[str, torch.Tensor]] = None

        # per-slot state (dispatcher thread only)
        self._pos = np.full((slots,), max_len - 1, np.int64)  # parked
        self._last_tok = np.zeros((slots,), np.int64)
        self._pending: List[Optional[np.ndarray]] = [None] * slots
        # each slot's adapter: the `lora_idx` input of every step and block
        self._adapter = (torch.zeros((slots,), dtype=torch.int64,
                                     device=self.device)
                         if self._lora else None)
        self._init_sampling_state(slots, cfg.vocab_size,
                                  bool(self.multi_step))
        # chunked x multi_step: pending prompt suffixes live ON DEVICE so
        # the K-step block feeds chunks without host round-trips;
        # _pbuf_len mirrors each row's admitted suffix length
        self._pbuf: Optional[torch.Tensor] = None
        if self.chunked and self.multi_step:
            self._pbuf = torch.zeros((slots, max_len), dtype=torch.int64,
                                     device=self.device)
        self._pbuf_len = np.zeros((slots,), np.int64)
        self._start_dispatch(slots, autostart)

    @property
    def decode(self) -> Engine:
        """The decode engine for the CURRENT cache length (len_buckets:
        one per bucket, made on first use, one shared set of weights)."""
        eng = self._decode_engines.get(self._cur_len)
        if eng is None:
            base = next(iter(self._decode_engines.values()))
            eng = Engine(self._make_decode_graph(self._cur_len),
                         share_params_with=base, **self._ekw)
            self._decode_engines[self._cur_len] = eng
        return eng

    # -- KV-length buckets -------------------------------------------------
    def _required_len(self) -> int:
        """Cache rows the LIVE requests still need: per slot, current
        position + un-ingested prompt + tokens left to generate."""
        need = 2
        for s in self._active():
            r = self._req[s]
            pend = 0 if self._pending[s] is None else \
                int(self._pending[s].size)
            need = max(need, int(self._pos[s]) + pend
                       + (r.max_new - len(r.tokens)))
        return need

    def _bucket_for(self, need: int) -> int:
        for b in self._len_buckets:
            if b >= need:
                return b
        return self._len_buckets[-1]

    def _resize_cache(self, target: int) -> None:
        """Switch the slot pool to a different cache length: pad (grow)
        or slice (shrink) every KV tensor's length axis (dim 2). Rows
        beyond every live request's final need are garbage by
        construction (attention masks by pos), so slicing is exact."""
        if target == self._cur_len:
            return
        old = self._cur_len
        for name, v in self._cache.items():
            if target > old:
                self._cache[name] = F.pad(v, (0, 0, 0, target - old))
            else:
                self._cache[name] = v[:, :, :target].contiguous()
        self._cur_len = target
        self.cache_resizes += 1

    @property
    def _calibrating(self) -> bool:
        """Chunked int8 serving before the first prompt finishes: the fp32
        shadow graph (built at max_len) is stepping, so the cache is
        pinned to max_len until the quantization flip."""
        return self._shadow is not None and self._kv_scales is None

    def _fit_cache(self, admit_need: int = 0) -> None:
        if self._len_buckets is None or self._calibrating:
            return
        self._resize_cache(self._bucket_for(
            max(self._required_len(), admit_need)))

    def _prefill_for(self, plen: int) -> tuple:
        """Smallest prefill bucket >= plen (its Engine made on first
        use)."""
        bucket = next(b for b in self.prompt_buckets if b >= plen)
        if bucket not in self._prefill_engines:
            self._prefill_engines[bucket] = self._make_prefill(bucket)
        return bucket, self._prefill_engines[bucket]

    # -- client API ------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, max_new_tokens: int,
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
               presence_penalty: float = 0.0) -> Future:
        """prompt_ids: [plen] int64; plen <= prompt_len (bucketed-prefill
        mode) or <= max_len - max_new_tokens (chunked_prefill mode).
        Resolves to the list of generated token ids. Generation stops at
        eos_id (included) or when the generated tail matches a stop
        sequence (included). temperature / top_k / top_p / min_p / seed:
        per-request sampling (0.0 = greedy). Single-step servers sample
        on the host from the returned logits (numpy, seeded per request,
        the reference's sampler). multi_step servers sample on the device
        inside the K-step block from a counter-based stream keyed on
        (seed, cache position): the same for any K and any co-resident
        traffic, but other draws than the host sampler's."""
        prompt_ids = np.asarray(prompt_ids).reshape(-1).astype(np.int64)
        limit = self.max_len if self.chunked else self.prompt_len
        assert 1 <= prompt_ids.size <= limit
        assert prompt_ids.size + max_new_tokens <= self.max_len
        if adapter and not self._lora:
            raise ValueError("adapter requested but server has no lora_bank")
        r = _Request(prompt_ids, max_new_tokens, eos_id, stop_sequences,
                     adapter=adapter, temperature=temperature,
                     top_k=top_k, top_p=top_p, min_p=min_p, seed=seed,
                     on_token=on_token,
                     logit_bias=logit_bias,
                     frequency_penalty=frequency_penalty,
                     presence_penalty=presence_penalty)
        return self._enqueue(r)

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        if self.prompt_cache:
            s["prefix_hits"] = self.prefix_hits
            s["prefix_tokens_saved"] = self.prefix_tokens_saved
        if self._len_buckets is not None:
            s["cache_len"] = self._cur_len
            s["cache_resizes"] = self.cache_resizes
        return s

    # -- admission --------------------------------------------------------
    def _scale(self, name: str) -> torch.Tensor:
        """past_{kind}_{i} -> its per-head scale, shaped [1, H, 1, 1]."""
        kind = "key" if "_key_" in name else "value"
        return self._kv_scales[
            f"kv_scale_{kind}_{name.rsplit('_', 1)[1]}"].reshape(1, -1, 1, 1)

    def _quant_kv(self, kv: torch.Tensor, name: str) -> torch.Tensor:
        """fp32 K/V rows -> the cache's dtype and layout (round half to
        even, as the reference's numpy; the division is a true one on both
        devices)."""
        if self.kv_dtype != np.int8:
            return kv.to(torch.float32)
        if self._int4_kv:
            from ..quant import pack_int4_kv

            return pack_int4_kv(kv, self._scale(name))
        return torch.clamp(torch.round(kv / self._scale(name)),
                           -127, 127).to(torch.int8)

    def _calibrate(self, presents: Dict[str, torch.Tensor]) -> None:
        """Per-(layer, kind, head) KV scales amax / 127 (INT4: amax / 7)
        from fp32 K/V [B, H, T, hd], keyed by past_ name."""
        qmax = torch.tensor(self._kv_qmax, dtype=torch.float32,
                            device=self.device)
        self._kv_scales = {}
        for name, kv in presents.items():
            kind, i = ("key" if "_key_" in name else "value",
                       name.rsplit("_", 1)[1])
            amax = kv.abs().amax(dim=(0, 2, 3)).clamp_min(1e-6)
            self._kv_scales[f"kv_scale_{kind}_{i}"] = amax / qmax

    def _clear_slot(self, slot: int) -> None:
        super()._clear_slot(slot)
        self._pending[slot] = None

    # -- prompt/prefix KV cache (dispatcher thread only) -----------------
    @staticmethod
    def _pkey(prompt: np.ndarray, adapter: int) -> bytes:
        # KV rows depend on the adapter, so it is part of the identity
        return np.int64(adapter).tobytes() + prompt.tobytes()

    def _pcache_put(self, prompt: np.ndarray, adapter: int,
                    kv: Dict[str, torch.Tensor],
                    last_logits: Optional[np.ndarray] = None) -> None:
        if not self.prompt_cache:
            return
        key = self._pkey(prompt, adapter)
        self._pcache[key] = {"prompt": prompt.copy(), "adapter": adapter,
                             "kv": kv, "last_logits": last_logits}
        self._pcache.move_to_end(key)
        while len(self._pcache) > self.prompt_cache:
            self._pcache.popitem(last=False)

    def _pcache_exact(self, prompt: np.ndarray,
                      adapter: int) -> Optional[dict]:
        key = self._pkey(prompt, adapter)
        e = self._pcache.get(key)
        if e is not None:
            self._pcache.move_to_end(key)
        return e

    def _pcache_prefix(self, prompt: np.ndarray, adapter: int):
        """Longest COMMON prefix between `prompt` and any same-adapter
        cached entry. KV rows are causal (row t depends only on tokens
        <= t), so any shared prefix's rows transfer exactly. At least 1
        token is left to stream (it produces the first-token logits).
        Returns (entry, n_common) or (None, 0)."""
        best, best_n = None, 0
        for e in self._pcache.values():
            if e["adapter"] != adapter:
                continue
            p = e["prompt"]
            n = int(min(p.size, prompt.size - 1))
            neq = np.nonzero(p[:n] != prompt[:n])[0]
            if neq.size:
                n = int(neq[0])
            if n > best_n:
                best, best_n = e, n
        if best is not None:
            self._pcache.move_to_end(
                self._pkey(best["prompt"], best["adapter"]))
        return best, best_n

    def _pcache_usable(self, e: Optional[dict]) -> bool:
        """Entry KV dtype must match the live cache (the chunked-int8
        calibration flip moves the cache fp32 -> int8 mid-serve)."""
        if e is None:
            return False
        name, q = next(iter(e["kv"].items()))
        return q.dtype == self._cache[name].dtype

    def _admit(self, slot: int, r: _Request) -> None:
        if self._len_buckets is not None:
            plen = r.prompt.size
            if self.chunked:
                need = plen + r.max_new
            else:
                bucket = next(b for b in self.prompt_buckets if b >= plen)
                need = max(bucket, plen + r.max_new)
            self._fit_cache(need)
        if self.chunked:
            # no prefill engine: the prompt streams through the chunk
            # graph C tokens per step, from position 0 or from the end of
            # the longest cached prefix. The slot is claimed LAST: if the
            # lookup or the KV writes raise, _fail must not leave a dead
            # request occupying the slot.
            self._set_adapter(slot, r)
            hit, n = self._pcache_prefix(r.prompt, r.adapter)
            if n > 0 and self._pcache_usable(hit):
                for name, q in hit["kv"].items():
                    self._cache[name][slot, :, :n] = q[:, :n]
                self._pending[slot] = r.prompt[n:].copy()
                self._pos[slot] = n
                self.prefix_hits += 1
                self.prefix_tokens_saved += n
            else:
                self._pending[slot] = r.prompt.copy()
                self._pos[slot] = 0
            if self._pbuf is not None:
                pend = self._pending[slot]
                row = np.zeros((self.max_len,), np.int64)
                row[: pend.size] = pend
                self._pbuf[slot].copy_(torch.from_numpy(row))
                self._pbuf_len[slot] = pend.size
            self._set_slot_sampling(slot, r)
            self._req[slot] = r
            return
        plen = r.prompt.size
        self._set_adapter(slot, r)
        hit = self._pcache_exact(r.prompt, r.adapter)
        if self._pcache_usable(hit):
            for name, q in hit["kv"].items():
                self._cache[name][slot, :, :plen] = q
            # select from the cached last-position logits: greedy replay
            # is identical; sampled requests draw their own stream
            first = _select_token(hit["last_logits"], r)
            self.prefix_hits += 1
            self.prefix_tokens_saved += plen
        else:
            bucket, prefill = self._prefill_for(plen)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :plen] = r.prompt
            pfeed = {"input_ids": padded}
            if self._lora:
                pfeed["lora_idx"] = np.array([r.adapter], np.int64)
            out = prefill(pfeed)
            presents = {f"past_{kind}_{i}": out[f"present_{kind}_{i}"]
                        for i in range(self.cfg.n_layer)
                        for kind in ("key", "value")}      # [1,H,Pb,hd]
            if self.kv_dtype == np.int8 and self._kv_scales is None:
                # one-time per-head calibration from the first prompt
                self._calibrate(presents)
            store: Dict[str, torch.Tensor] = {}
            for name, kv in presents.items():
                q = self._quant_kv(kv, name)[0]
                self._cache[name][slot, :, :bucket] = q
                if self.prompt_cache:
                    store[name] = q[:, :plen].clone()
            last = _fetch(out["logits"][0, plen - 1])
            first = _select_token(last, r)
            self._pcache_put(r.prompt, r.adapter, store, last)
        r.emit(first)
        self.tokens_out += 1
        if (len(r.tokens) >= r.max_new or first == r.eos_id
                or _hits_stop(r)):  # done already
            self._finish(None, r)
            return
        self._set_slot_sampling(slot, r)
        self._req[slot] = r
        self._pos[slot] = plen
        self._last_tok[slot] = first

    def _set_adapter(self, slot: int, r: _Request) -> None:
        """Write the request's adapter into its slot's `lora_idx` entry."""
        if self._lora:
            self._adapter[slot].fill_(r.adapter)

    # -- dispatcher -------------------------------------------------------
    def _lora_feed(self, feed: dict) -> dict:
        if self._lora:
            feed["lora_idx"] = self._adapter
        return feed

    def _feed(self, ids: np.ndarray, calibrating: bool = False) -> dict:
        feed = {"input_ids": torch.from_numpy(ids),
                "pos": torch.from_numpy(self._pos.copy())}
        feed.update(self._cache)
        if self.kv_dtype == np.int8 and not calibrating:
            feed.update(self._kv_scales)
        return self._lora_feed(feed)

    def _take_presents(self, out: Dict[str, torch.Tensor]) -> None:
        for name in self._cache:
            self._cache[name] = out[name.replace("past_", "present_", 1)]

    def _step(self) -> None:
        if self._len_buckets is not None and not self._calibrating:
            # shrink opportunistically: growth happened at admission, so
            # only a finished long request can lower the requirement here
            t = self._bucket_for(self._required_len())
            if t < self._cur_len:
                self._resize_cache(t)
        if self.chunked:
            # chunked x multi_step runs the device block once int8 KV
            # calibration (shadow fp32 phase) is out of the way
            if self.multi_step > 0 and not self._calibrating:
                return self._step_chunked_multi()
            return self._step_chunked()
        if self.multi_step > 0:
            return self._step_multi()
        self._new_graph(("step", self._cur_len))
        out = self.decode(self._feed(self._last_tok[:, None].copy()))
        logits = _fetch(out["logits"])  # [B,1,V]
        self._take_presents(out)
        self.steps += 1
        self._occupancy_sum += len(self._active())

        for s in self._active():
            r = self._req[s]
            self._pos[s] += 1
            tok = _select_token(logits[s, 0], r)
            r.emit(tok)
            self._last_tok[s] = tok
            self.tokens_out += 1
            if (len(r.tokens) >= r.max_new or tok == r.eos_id
                    or _hits_stop(r)):
                self._finish(s, r)

    def _step_chunked(self) -> None:
        C = self.chunk
        B = self.B
        ids = np.zeros((B, C), np.int64)
        fed = np.zeros((B,), np.int64)          # real prompt tokens fed
        for s in range(B):
            r = self._req[s]
            if r is None:
                continue
            pend = self._pending[s]
            if pend is not None and pend.size > 0:
                n = int(min(C, pend.size))
                ids[s, :n] = pend[:n]
                self._pending[s] = pend[n:]
                fed[s] = n
            else:
                ids[s, 0] = self._last_tok[s]

        calibrating = self._calibrating
        eng = self._shadow if calibrating else self.decode
        self._new_graph(("chunk", calibrating, self._cur_len))
        out = eng(self._feed(ids, calibrating))
        logits = _fetch(out["logits"])          # [B, C, V]
        self._take_presents(out)
        self.steps += 1
        self._occupancy_sum += len(self._active())

        prefill_done = False
        for s in self._active():
            r = self._req[s]
            if fed[s] > 0:
                self._pos[s] += fed[s]
                if self._pending[s].size > 0:
                    continue                    # still prefilling
                prefill_done = True
                if self.prompt_cache and not calibrating:
                    # prompt fully ingested: keep its KV rows so later
                    # requests sharing this prefix skip the prefill stream
                    plen = int(self._pos[s])
                    self._pcache_put(r.prompt, r.adapter, {
                        name: v[s, :, :plen].clone()
                        for name, v in self._cache.items()})
                tok = _select_token(logits[s, fed[s] - 1], r)
            else:
                self._pos[s] += 1
                tok = _select_token(logits[s, 0], r)
            r.emit(tok)
            self._last_tok[s] = tok
            self.tokens_out += 1
            if (len(r.tokens) >= r.max_new or tok == r.eos_id
                    or _hits_stop(r)):
                self._finish(s, r)

        if calibrating and prefill_done:
            # the first full prompt is in the fp32 shadow cache: derive the
            # per-head scales from it and quantize the cache ONCE
            self._calibrate(self._cache)
            for name in list(self._cache):
                self._cache[name] = self._quant_kv(self._cache[name], name)
            # the shadow engine (a full duplicate weight set) is dead from
            # here on: release it
            self._shadow = None
