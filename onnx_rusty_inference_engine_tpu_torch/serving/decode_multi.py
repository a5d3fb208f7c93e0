"""K-step blocks for DecodeServer(multi_step=K): plain decode and chunked
mixed prefill/decode, as a mixin so decode.py stays navigable.

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/
decode_multi.py and of DecodeServer._get_multi_fn / _get_multi_sampled_fn
(serving/decode.py:574-666), where K steps are one `lax.scan`. Here a
block's K steps, selection included, are one CUDA graph per (kind, cache
length): the first block of a kind runs eagerly and is then captured,
later blocks replay. A graph reads and writes its buffers by address, so
the state it touches lives in buffers made once: the token, position,
remaining-prompt and offset inputs, the [B, K] outputs, the per-slot
sampling parameters (all copied in from the host before each block), the
[B, V] counts and bias rows, and one KV cache per length, which the
server's cache is bound to (`_bind_cache`) while blocks run. On the CPU a
block is the same body run as a Python loop.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..engine import _fetch, run_captured
from .request import _bias_penalize, _device_select, _hits_stop


class _MultiStepMixin:
    # -- the buffers the blocks' graphs read and write ---------------------
    def _io(self) -> Dict[str, torch.Tensor]:
        """Inputs and outputs of every block, made once."""
        io = getattr(self, "_io_bufs", None)
        if io is None:
            B, K, dev = self.B, self.multi_step, self.device
            i64 = dict(dtype=torch.int64, device=dev)
            f32 = dict(dtype=torch.float32, device=dev)
            io = {"tok": torch.zeros((B,), **i64),
                  "pos": torch.zeros((B,), **i64),
                  "rem": torch.zeros((B,), **i64),
                  "off": torch.zeros((B,), **i64),
                  "toks": torch.zeros((B, K), **i64),
                  "valid": torch.zeros((B, K), dtype=torch.bool, device=dev),
                  "seeds": torch.zeros((B,), **i64),
                  "tk": torch.zeros((B,), **i64),
                  "temp": torch.zeros((B,), **f32),
                  "tp": torch.zeros((B,), **f32),
                  "mp": torch.zeros((B,), **f32),
                  "fpen": torch.zeros((B,), **f32),
                  "ppen": torch.zeros((B,), **f32)}
            self._io_bufs = io
        return io

    def _load_io(self, sampling: bool, **host) -> Dict[str, torch.Tensor]:
        """Copy this block's host inputs (and, for a sampling block, the
        per-slot parameters) into the buffers."""
        io = self._io()
        if sampling:
            host.update(seeds=self._seeds, tk=self._topk, temp=self._temp,
                        tp=self._topp, mp=self._minp, fpen=self._fpen,
                        ppen=self._ppen)
        for k, v in host.items():
            io[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        return io

    def _bind_cache(self) -> Dict[str, torch.Tensor]:
        """The KV buffers of the current cache length, holding the
        server's cache; the server's cache is them from here on (its
        in-place admission writes land in them)."""
        bufs = getattr(self, "_cache_bufs", None)
        if bufs is None:
            bufs = self._cache_bufs = {}
        cur = bufs.get(self._cur_len)
        if cur is None:
            cur = bufs[self._cur_len] = {
                name: torch.empty_like(v) for name, v in self._cache.items()}
        for name, v in self._cache.items():
            if v is not cur[name]:
                cur[name].copy_(v)
        self._cache = dict(cur)
        return cur

    def _run_block(self, kind: str, body: Callable[[], None]) -> None:
        """Run one block of `kind` at the current cache length: on the
        card its graph's replay, captured after an eager first run."""
        key = (kind, self._cur_len)
        self._new_graph(key)
        run_captured(self._blocks, key, body, self.decode)

    def _scales(self) -> Dict[str, torch.Tensor]:
        return self._kv_scales if self.kv_dtype == np.int8 else {}

    @staticmethod
    def _presents(out: dict, cache: dict) -> Dict[str, torch.Tensor]:
        return {name: out[name.replace("past_", "present_", 1)]
                for name in cache}

    # -- plain decode ------------------------------------------------------
    def _step_multi(self) -> None:
        """K decode steps in one block; host-side bookkeeping after.
        Pure-greedy batches run the lean argmax block; batches with any
        sampled/biased/penalized slot run the sampled block (greedy slots
        in it still select exact argmax)."""
        sampled = any(self._needs_device_sampling(self._req[s])
                      for s in self._active())
        if sampled:
            self._alloc_sampling_rows()  # replayed pcache admissions only
        io = self._load_io(sampled, tok=self._last_tok, pos=self._pos)
        cache = self._bind_cache()
        eng, scales = self.decode, self._scales()
        B, K, L = self.B, self.multi_step, self._cur_len

        def body():
            tok, pos, cur = io["tok"], io["pos"], cache
            for j in range(K):
                feed = {"input_ids": tok.reshape(B, 1), "pos": pos}
                feed.update(cur)
                feed.update(scales)
                out = eng.forward(self._lora_feed(feed))
                logits = out["logits"][:, -1, :]
                if sampled:
                    logits = _bias_penalize(
                        logits.to(torch.float32), self._bias, io["fpen"],
                        io["ppen"], self._counts)
                    nxt = _device_select(logits, io["seeds"], pos,
                                         io["temp"], io["tk"], io["tp"],
                                         io["mp"])
                    self._counts.scatter_add_(
                        1, nxt[:, None], torch.ones((B, 1), dtype=torch.int32,
                                                    device=nxt.device))
                else:
                    nxt = torch.argmax(logits, dim=-1)
                cur = self._presents(out, cur)
                io["toks"][:, j].copy_(nxt)
                # parking invariant: pos stays < L inside the block
                tok, pos = nxt, torch.clamp(pos + 1, max=L - 1)
            for name, v in cur.items():
                cache[name].copy_(v)

        self._run_block("sampled" if sampled else "greedy", body)
        self._emit_multi_block(_fetch(io["toks"]), K)

    # -- chunked prefill x decode --------------------------------------------
    def _step_chunked_multi(self) -> None:
        """K CHUNK steps in one block: the unified prefill/decode loop on
        the device. Each step, per slot: if prompt tokens remain, feed the
        next C of them from the device prompt buffer and emit a token only
        when the chunk consumed the prompt's tail; otherwise feed the last
        emitted token as a 1-real-token decode chunk. Selection is the
        per-slot device sampler (neutral params = exact greedy); the
        emission mask comes back with the tokens and the host replays the
        same arithmetic for its bookkeeping."""
        self._alloc_sampling_rows()
        rem = np.array([0 if p is None else p.size for p in self._pending],
                       np.int64)
        off = self._pbuf_len - rem
        io = self._load_io(True, tok=self._last_tok, pos=self._pos, rem=rem,
                           off=off)
        cache = self._bind_cache()
        eng, scales, pbuf = self.decode, self._scales(), self._pbuf
        B, K, C, CUR = self.B, self.multi_step, self.chunk, self._cur_len
        L = pbuf.shape[1]
        V = self._vocab

        def body():
            tok, pos, rem, off, cur = (io["tok"], io["pos"], io["rem"],
                                       io["off"], cache)
            steps = torch.arange(C, dtype=torch.int64, device=tok.device)
            for j in range(K):
                prefilling = rem > 0                                 # [B]
                n_feed = torch.where(prefilling, torch.clamp(rem, max=C),
                                     torch.ones_like(rem))
                want = off[:, None] + steps[None, :]                # [B, C]
                window = torch.where(
                    want < L, pbuf.gather(1, torch.clamp(want, max=L - 1)),
                    torch.zeros_like(want))
                decode_ids = torch.cat(
                    [tok[:, None], torch.zeros((B, C - 1), dtype=tok.dtype,
                                               device=tok.device)], dim=1)
                ids = torch.where(prefilling[:, None], window, decode_ids)
                feed = {"input_ids": ids, "pos": pos}
                feed.update(cur)
                feed.update(scales)
                out = eng.forward(self._lora_feed(feed))
                logits = out["logits"].to(torch.float32)          # [B, C, V]
                last = logits.gather(1, (n_feed - 1)[:, None, None].expand(
                    B, 1, V))[:, 0]
                last = _bias_penalize(last, self._bias, io["fpen"],
                                      io["ppen"], self._counts)
                nxt = _device_select(last, io["seeds"], pos, io["temp"],
                                     io["tk"], io["tp"], io["mp"])
                rem_after = torch.clamp(rem - n_feed, min=0)
                valid = rem_after == 0          # emitted a real token
                tok = torch.where(valid, nxt, tok)
                self._counts.scatter_add_(1, nxt[:, None],
                                          valid[:, None].to(torch.int32))
                # parking invariant: parked and finished lanes must not
                # drift past the cache
                pos = torch.clamp(pos + n_feed, max=CUR - 1)
                off = off + torch.where(prefilling, n_feed,
                                        torch.zeros_like(n_feed))
                rem = rem_after
                cur = self._presents(out, cur)
                io["toks"][:, j].copy_(nxt)
                io["valid"][:, j].copy_(valid)
            for name, v in cur.items():
                cache[name].copy_(v)

        self._run_block("chunked", body)
        toks = _fetch(io["toks"])                # [B, K]
        valid = _fetch(io["valid"])              # [B, K]
        self.steps += 1
        self._occupancy_sum += len(self._active())
        for s in self._active():
            r = self._req[s]
            remaining = 0 if self._pending[s] is None else \
                int(self._pending[s].size)
            fed_total = 0
            plen_done = None
            for j in range(K):
                if remaining > 0:
                    n = min(C, remaining)
                    remaining -= n
                    fed_total += n
                    self._pos[s] += n
                    if remaining > 0:
                        assert not valid[s, j]
                        continue            # still prefilling: no token
                    plen_done = int(self._pos[s])
                else:
                    self._pos[s] += 1
                assert valid[s, j]
                tok = int(toks[s, j])
                r.emit(tok)
                self._last_tok[s] = tok
                self.tokens_out += 1
                if (len(r.tokens) >= r.max_new or tok == r.eos_id
                        or _hits_stop(r)):
                    self._finish(s, r)      # overshoot discarded
                    break
            # a request that finished in this block has been cleared (its
            # pending is None): the reference slices None here and fails
            # every request of the block
            if fed_total and self._pending[s] is not None:
                self._pending[s] = self._pending[s][fed_total:]
            if plen_done is not None and self.prompt_cache:
                self._pcache_put(r.prompt, r.adapter, {
                    name: v[s, :, :plen_done].clone()
                    for name, v in self._cache.items()})
