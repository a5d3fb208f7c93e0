"""Seq2SeqServer: continuous batching for the encoder-decoder families
(t5, asr): per-slot encoder state and a decoder slot pool.

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/
seq2seq.py. The self-attention cache, the cross K/V and the source
lengths are buffers made once; admission writes a slot's rows in place,
and the decode step (on the card a captured CUDA graph, replayed) reads
and writes them by address. `multi_step=K` runs K steps, selection
included, as one graph (decode_multi.py's buffers and block runner).
"""

from __future__ import annotations

from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from ..engine import Engine, _fetch, resolve_device, run_captured
from ..graph import import_model
from .base import _ServerBase
from .decode_multi import _MultiStepMixin
from .request import (_Request, _bias_penalize, _device_select, _hits_stop,
                      _select_token)


class Seq2SeqServer(_MultiStepMixin, _ServerBase):
    """Continuous batching for encoder-decoder families
    (models.seq2seq_family: "t5" tokens -> tokens, "asr" waveform ->
    tokens).

    Per-slot cross-attention state is what DecodeServer lacks: each
    admitted request runs the batch-1 encoder once, and its cross_key_i /
    cross_value_i go into slot s of the batched cross buffers that the
    shared decode graph reads every step (static after admission).
    Decoding then runs as DecodeServer's: one decode graph, per-slot
    positions, host selection from the step's logits.

    encoder_cache=N keeps the cross K/V of up to N sources (LRU, on the
    device): a repeated source skips the encoder (`encoder_cache_hits` in
    stats()). multi_step=K runs K decode steps as one graph with the
    per-slot device sampler (request._device_select; neutral parameters
    are exact greedy). For src_mask families (t5) each slot's true source
    length is fed to the decode graph, so cross-attention never reads
    padding and served tokens equal an isolated generation's. fp32 KV, as
    in JAX. Runs on the card unless `device="cpu"`.
    """

    def __init__(
        self,
        cfg,
        *,
        slots: int = 4,
        src_len: int = 16,
        max_len: int = 32,
        seed: int = 0,
        start_token: int = 0,
        mesh=None,
        param_sharding_fn=None,
        family: str = "t5",
        encoder_cache: int = 0,
        multi_step: int = 0,
        autostart: bool = True,
        device="cuda",
    ):
        from ..models import seq2seq_family

        self.device = resolve_device(device)
        self.fam = seq2seq_family(family)
        self.cfg = cfg
        self.src_len = src_len
        self.enc_len = self.fam.enc_len(cfg, src_len)
        self.max_len = max_len
        self.start_token = start_token
        self.n_layers = self.fam.n_layers(cfg)
        ekw = dict(device=self.device, mesh=mesh,
                   param_sharding_fn=param_sharding_fn)
        self.encoder = Engine(import_model(self.fam.build_encoder(
            cfg, batch=1, src_len=src_len, seed=seed)), **ekw)
        self.decode = Engine(import_model(self.fam.build_decode(
            cfg, batch=slots, max_len=max_len, src_len=self.enc_len,
            seed=seed)), **ekw)

        dev = self.device
        specs = {s.name: s for s in self.decode.graph.inputs}

        def zeros(name, dtype):
            return torch.zeros(specs[name].concrete_shape(batch=slots),
                               dtype=dtype, device=dev)

        self._cache = {n: zeros(n, torch.float32) for n in specs
                       if n.startswith("past_")}
        # what admission writes and every step reads: cross K/V, src_len
        self._const = {n: zeros(n, torch.float32) for n in specs
                       if n.startswith("cross_")}
        if self.fam.src_mask:
            self._const["src_len"] = zeros("src_len", torch.int64)
        self._logits = torch.zeros((slots, 1, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._graphs: Dict[object, object] = {}

        self._pos = np.full((slots,), max_len - 1, np.int64)
        self._last_tok = np.full((slots,), start_token, np.int64)
        self.encoder_cache = int(encoder_cache)
        self._enc_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self.encoder_cache_hits = 0
        self.multi_step = int(multi_step)
        self._cur_len = max_len        # decode_multi's block key
        self._blocks: Dict[tuple, object] = {}
        self._init_sampling_state(slots, cfg.vocab_size,
                                  bool(self.multi_step))
        self._start_dispatch(slots, autostart)

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        if self.encoder_cache:
            s["encoder_cache_hits"] = self.encoder_cache_hits
        return s

    # -- client API -------------------------------------------------------
    def submit(self, src: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int] = None,
               temperature: float = 0.0,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               seed: int = 0,
               on_token=None,
               logit_bias: Optional[Dict[int, float]] = None,
               frequency_penalty: float = 0.0,
               presence_penalty: float = 0.0) -> Future:
        """src: [plen] source (int64 tokens or f32 waveform per family;
        right-padded with zeros to src_len at admission). Resolves to the
        generated target token ids. Sampling knobs as DecodeServer.submit:
        single-step servers sample on the host from the request's numpy
        generator, multi_step servers on the device keyed on (seed, cache
        position)."""
        src = np.asarray(src).reshape(-1).astype(self.fam.prompt_dtype)
        assert 1 <= src.size <= self.src_len
        assert 1 <= max_new_tokens <= self.max_len
        r = _Request(src, max_new_tokens, eos_id, temperature=temperature,
                     top_k=top_k, top_p=top_p, min_p=min_p, seed=seed,
                     on_token=on_token, logit_bias=logit_bias,
                     frequency_penalty=frequency_penalty,
                     presence_penalty=presence_penalty)
        return self._enqueue(r)

    # -- dispatcher -------------------------------------------------------
    def _admit(self, slot: int, r: _Request) -> None:
        key = r.prompt.tobytes()
        cross = self._enc_cache.get(key) if self.encoder_cache else None
        if cross is not None:
            self._enc_cache.move_to_end(key)
            self.encoder_cache_hits += 1
        else:
            src = np.zeros((1, self.src_len), self.fam.prompt_dtype)
            src[0, : r.prompt.size] = r.prompt
            feed = {self.fam.enc_input: src}
            if self.fam.src_mask:
                feed["src_len"] = np.array([r.prompt.size], np.int64)
            enc = self.encoder(feed)
            cross = {n: enc[n][0] for n in self._const
                     if n.startswith("cross_")}
            if self.encoder_cache:
                self._enc_cache[key] = cross
                while len(self._enc_cache) > self.encoder_cache:
                    self._enc_cache.popitem(last=False)
        for name, v in cross.items():
            self._const[name][slot].copy_(v)
        if self.fam.src_mask:
            self._const["src_len"][slot] = r.prompt.size
        self._set_slot_sampling(slot, r)
        self._req[slot] = r
        self._pos[slot] = 0
        self._last_tok[slot] = self.start_token

    def _forward(self, tok: torch.Tensor, pos: torch.Tensor,
                 cache: Dict[str, torch.Tensor]) -> dict:
        feed = {"input_ids": tok.reshape(self.B, 1), "pos": pos}
        feed.update(cache)
        feed.update(self._const)
        return self.decode.forward(feed)

    def _step_multi(self) -> None:
        """K decode steps as one graph: the self-attention cache and the
        counts advance in place, the cross K/V are read as they are, every
        slot selects through the device sampler."""
        self._alloc_sampling_rows()
        io = self._load_io(True, tok=self._last_tok, pos=self._pos)
        B, K, L = self.B, self.multi_step, self.max_len
        ones = torch.ones((B, 1), dtype=torch.int32, device=self.device)

        def body():
            tok, pos, cur = io["tok"], io["pos"], self._cache
            for j in range(K):
                out = self._forward(tok, pos, cur)
                logits = _bias_penalize(
                    out["logits"][:, -1, :].to(torch.float32), self._bias,
                    io["fpen"], io["ppen"], self._counts)
                nxt = _device_select(logits, io["seeds"], pos, io["temp"],
                                     io["tk"], io["tp"], io["mp"])
                self._counts.scatter_add_(1, nxt[:, None], ones)
                cur = self._presents(out, cur)
                io["toks"][:, j].copy_(nxt)
                # parking invariant: pos stays < L inside the block
                tok, pos = nxt, torch.clamp(pos + 1, max=L - 1)
            for name, v in cur.items():
                self._cache[name].copy_(v)

        self._run_block("seq2seq", body)
        self._emit_multi_block(_fetch(io["toks"]), K)

    def _step(self) -> None:
        if self.multi_step > 0:
            return self._step_multi()
        io = self._load_io(False, tok=self._last_tok, pos=self._pos)

        def body():
            out = self._forward(io["tok"], io["pos"], self._cache)
            for name, v in self._presents(out, self._cache).items():
                self._cache[name].copy_(v)
            self._logits.copy_(out["logits"])

        self._new_graph(("step", self.max_len))
        run_captured(self._graphs, "step", body, self.decode)
        logits = _fetch(self._logits)
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
