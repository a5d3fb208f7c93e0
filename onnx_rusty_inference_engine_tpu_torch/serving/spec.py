"""SpeculativeServer: lossless speculative decoding as a serving mode
(draft-model and prompt-lookup proposals).

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/spec.py.
The target's and the draft's KV caches are buffers made once: admission
writes a slot's prefill rows into them in place, and every graph the
server runs reads and writes them by address. On the card each graph is a
CUDA graph (eager on its first run, captured, then replayed): the draft's
decode step and the target's chunk-verify of the host rounds, and with
`multi_step=R` the R whole rounds of a block.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..engine import Engine, _fetch, resolve_device, run_captured
from ..graph import import_model
from .base import _ServerBase
from .request import _Request, _hits_stop, _select_token, _uniform


class SpeculativeServer(_ServerBase):
    """Continuous-batching speculative decoding: every server step runs
    ONE speculation round over the whole slot pool. The draft proposes
    k-1 tokens per slot (k-1 batched draft steps), the target verifies
    all k in ONE chunk call, and each slot accepts its own greedy-matched
    prefix plus 1 corrected token (per-slot `pos [B]` makes variable
    acceptance free). Greedy verification is lossless: served tokens
    equal the target's own greedy decode, whatever the draft proposes.

    Slots park at pos = max_len - k so the draft steps (pos .. pos+k-1)
    and the verify chunk never index past the cache or the position
    tables; parked rows are stale but masked, as DecodeServer's.

    Per-request temperature > 0 switches that slot to speculative
    rejection sampling (Leviathan et al.): draft token x ~ q accepted with
    probability min(1, p(x)/q(x)); on rejection the emitted token is drawn
    from normalize(max(p - q, 0)): the slot's output distribution is plain
    target sampling at that temperature. The host rounds draw from the
    request's numpy generator (`r.rng`), as the JAX server does. top_k,
    top_p, logit_bias and adapter are refused (they would break the
    verification identity).

    ngram=N replaces the draft model with prompt-lookup proposals: each
    slot's continuation of the latest earlier occurrence of its context's
    final N-gram (no draft engines). Greedy only: no q distribution exists
    to rejection-sample against.

    multi_step=R runs R whole speculation rounds as one graph, for both
    proposal kinds. A draft round holds the k-1 draft steps and the last
    draft KV row, the target verify, and the acceptance (the cumprod of
    the token match, or device rejection sampling); a prompt-lookup round
    searches and appends a per-slot context buffer on the device. Device
    rejection sampling keeps the JAX server's seed contract, not its
    values: each draw is a function of (slot seed, position, draw index)
    alone (request._uniform), with the draw indices 0..k-2 for the draft
    tokens, 2k..3k-2 for the residuals, 3k for the bonus and 4k+1 for the
    acceptance uniforms, so a request's tokens do not depend on what else
    is resident. Greedy lanes (temperature 0) reduce to the exact token
    match, so mixed traffic runs in one graph. Inside a block every lane's
    position advances as min(pos + m + 1, max_len - k): a parked lane, or
    one that finished mid-block, must not walk the verify window past the
    tables, whose garbage K/V would poison the next request admitted to
    its slot.

    fp32 weights and KV, as in JAX. Runs on the card unless
    `device="cpu"`.
    """

    def __init__(
        self,
        target_cfg,
        draft_cfg=None,
        *,
        slots: int = 4,
        prompt_len: int = 8,
        max_len: int = 64,
        k: int = 4,
        target_seed: int = 0,
        draft_seed: int = 1,
        ngram: Optional[int] = None,
        family: str = "gpt2",
        mesh=None,
        param_sharding_fn=None,
        autostart: bool = True,
        multi_step: int = 0,
        device="cuda",
    ):
        from ..models import decoder_family

        build_prefill, build_decode, _ = decoder_family(family)
        self.device = resolve_device(device)
        self.cfg = target_cfg
        self.dcfg = draft_cfg if draft_cfg is not None else target_cfg
        assert self.dcfg.vocab_size == target_cfg.vocab_size
        self.k = int(k)
        assert self.k >= 2
        self.prompt_len = prompt_len
        self.max_len = max_len
        self.kv_dtype = np.dtype(np.float32)
        self.ngram = int(ngram) if ngram else 0
        self.multi_step = int(multi_step)

        pkw = ({"past_len": 0, "with_presents": True} if family == "gpt2"
               else {"with_presents": True})

        def engine(build, cfg, seed, **kw):
            return Engine(import_model(build(cfg, seed=seed, **kw)),
                          device=self.device, mesh=mesh,
                          param_sharding_fn=param_sharding_fn)

        self.t_prefill = engine(build_prefill, target_cfg, target_seed,
                                batch=1, seq_len=prompt_len, **pkw)
        self.t_verify = engine(build_decode, target_cfg, target_seed,
                               batch=slots, max_len=max_len, chunk=self.k)
        if self.ngram:
            self.d_prefill = self.d_decode = None
        else:
            self.d_prefill = engine(build_prefill, self.dcfg, draft_seed,
                                    batch=1, seq_len=prompt_len, **pkw)
            self.d_decode = engine(build_decode, self.dcfg, draft_seed,
                                   batch=slots, max_len=max_len)

        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)

        def cache_of(eng: Optional[Engine]) -> Dict[str, torch.Tensor]:
            if eng is None:
                return {}
            return {s.name: torch.zeros(s.concrete_shape(batch=slots),
                                        dtype=torch.float32, device=dev)
                    for s in eng.graph.inputs if s.name.startswith("past_")}

        V, k = target_cfg.vocab_size, self.k
        self._t_cache = cache_of(self.t_verify)
        self._d_cache = cache_of(self.d_decode)
        # the host rounds' inputs and outputs: the draft step's token,
        # position and logits; the verify chunk, position and logits
        self._io = {"d_tok": torch.zeros((slots,), **i64),
                    "d_pos": torch.zeros((slots,), **i64),
                    "d_logits": torch.zeros((slots, V), dtype=torch.float32,
                                            device=dev),
                    "chunk": torch.zeros((slots, k), **i64),
                    "v_pos": torch.zeros((slots,), **i64),
                    "v_logits": torch.zeros((slots, k, V),
                                            dtype=torch.float32, device=dev)}
        R = max(self.multi_step, 1)
        # the blocks' inputs and outputs: per-slot last token, position,
        # temperature and seed; each round's tokens [B, R, k] and accepted
        # count m [B, R]
        self._mio = {"last": torch.zeros((slots,), **i64),
                     "pos": torch.zeros((slots,), **i64),
                     "temp": torch.zeros((slots,), dtype=torch.float32,
                                         device=dev),
                     "seeds": torch.zeros((slots,), **i64),
                     "emits": torch.zeros((slots, R, k), **i64),
                     "ms": torch.zeros((slots, R), **i64)}
        self._graphs: Dict[str, object] = {}

        self._pos = np.full((slots,), max_len - self.k, np.int64)
        self._last_tok = np.zeros((slots,), np.int64)
        self.accepted_total = 0
        self.proposed_total = 0
        # prompt lookup with multi_step: the per-slot contexts live on the
        # device for the in-graph search (prompt, then every emitted token)
        self._ctx: Optional[torch.Tensor] = None
        if self.multi_step and self.ngram:
            self._ctx = torch.zeros((slots, max_len), **i64)
        # per-slot sampling state of the device rejection sampler (neutral
        # temperature 0 = a greedy lane)
        self._mtemp = np.zeros((slots,), np.float32)
        self._mseeds = np.zeros((slots,), np.int64)
        self._start_dispatch(slots, autostart)

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["acceptance_rate"] = (self.accepted_total / self.proposed_total
                                if self.proposed_total else 0.0)
        return s

    def _clear_slot(self, slot: int) -> None:
        self._req[slot] = None
        self._pos[slot] = self.max_len - self.k    # park (see docstring)
        self._mtemp[slot] = 0.0                    # parked lanes run greedy

    # -- client API ------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int] = None,
               stop_sequences: Optional[List[List[int]]] = None,
               on_token=None,
               temperature: float = 0.0,
               seed: int = 0, **kw) -> Future:
        if any(kw.get(p) for p in ("top_k", "top_p",
                                   "logit_bias", "adapter")):
            raise ValueError(
                "SpeculativeServer verifies exactly (greedy) or by "
                "rejection sampling (temperature); top_k/top_p/"
                "logit_bias/adapter would break that identity - use "
                "DecodeServer for them")
        if temperature and self.ngram:
            raise ValueError(
                "ngram (prompt-lookup) proposals have no q distribution "
                "to rejection-sample against - greedy only; use a draft "
                "model for sampled speculation")
        prompt_ids = np.asarray(prompt_ids).reshape(-1).astype(np.int64)
        assert 1 <= prompt_ids.size <= self.prompt_len
        assert prompt_ids.size + max_new_tokens + self.k <= self.max_len
        r = _Request(prompt_ids, max_new_tokens, eos_id, stop_sequences,
                     on_token=on_token, temperature=temperature,
                     seed=seed)
        return self._enqueue(r)

    @staticmethod
    def _soft(row: np.ndarray, temperature: float) -> np.ndarray:
        z = row.astype(np.float64) / temperature
        z -= z.max()
        e = np.exp(z)
        return e / e.sum()

    # -- admission -------------------------------------------------------
    def _admit(self, slot: int, r: _Request) -> None:
        plen = r.prompt.size
        padded = np.zeros((1, self.prompt_len), np.int64)
        padded[0, :plen] = r.prompt
        t_out = self.t_prefill({"input_ids": padded})
        pairs = [(self._t_cache, t_out)]
        if not self.ngram:
            pairs.append((self._d_cache, self.d_prefill(
                {"input_ids": padded})))
        for cache, out in pairs:
            for name, buf in cache.items():
                buf[slot, :, :self.prompt_len].copy_(
                    out[name.replace("past_", "present_", 1)][0])
        first = _select_token(_fetch(t_out["logits"][0, plen - 1]), r)
        r.emit(first)
        self.tokens_out += 1
        if (len(r.tokens) >= r.max_new or first == r.eos_id
                or _hits_stop(r)):
            self._finish(None, r)
            return
        if self._ctx is not None:
            row = np.zeros((self.max_len,), np.int64)
            row[:plen] = r.prompt
            row[plen] = first
            self._ctx[slot].copy_(torch.from_numpy(row))
        self._req[slot] = r
        self._pos[slot] = plen
        self._last_tok[slot] = first
        if self.multi_step and not self.ngram:
            self._mtemp[slot] = r.temperature
            self._mseeds[slot] = r.seed

    # -- the graphs ------------------------------------------------------
    def _forward(self, eng: Engine, cache: Dict[str, torch.Tensor],
                 ids: torch.Tensor, pos: torch.Tensor):
        """One decode (ids [B, 1]) or verify (ids [B, k]) forward on the
        cache `cache`: (logits, the presents by past_ name)."""
        feed = {"input_ids": ids, "pos": pos}
        feed.update(cache)
        out = eng.forward(feed)
        return out["logits"], {n: out[n.replace("past_", "present_", 1)]
                               for n in cache}

    def _run(self, kind: str, eng: Engine, body) -> None:
        self._new_graph(kind)
        run_captured(self._graphs, kind, body, eng)

    def _draft_step(self, tok: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """One draft decode step over the slot pool, its presents written
        into the draft cache: the logits [B, V] (a buffer)."""
        io = self._io
        io["d_tok"].copy_(torch.from_numpy(np.ascontiguousarray(tok)))
        io["d_pos"].copy_(torch.from_numpy(np.ascontiguousarray(pos)))

        def body():
            logits, presents = self._forward(
                self.d_decode, self._d_cache, io["d_tok"].reshape(-1, 1),
                io["d_pos"])
            for n, v in presents.items():
                self._d_cache[n].copy_(v)
            io["d_logits"].copy_(logits[:, -1, :])

        self._run("draft", self.d_decode, body)
        return io["d_logits"]

    def _verify(self, chunk: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """The target's chunk-verify over the slot pool, its presents
        written into the target cache: the logits [B, k, V]."""
        io = self._io
        io["chunk"].copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
        io["v_pos"].copy_(torch.from_numpy(np.ascontiguousarray(pos)))

        def body():
            logits, presents = self._forward(self.t_verify, self._t_cache,
                                             io["chunk"], io["v_pos"])
            for n, v in presents.items():
                self._t_cache[n].copy_(v)
            io["v_logits"].copy_(logits)

        self._run("verify", self.t_verify, body)
        return _fetch(io["v_logits"])

    # -- host rounds -----------------------------------------------------
    def _lookup_proposal(self, r: _Request) -> List[int]:
        """Prompt lookup: continue the most recent earlier occurrence of
        the context's final N-gram; pad or fall back with the last token
        (a bad proposal only costs acceptance, never correctness)."""
        ctx = list(r.prompt) + r.tokens
        n, k = self.ngram, self.k
        g = ctx[-n:]
        cont: List[int] = []
        for i in range(len(ctx) - n - 1, -1, -1):
            if ctx[i:i + n] == g:
                cont = [int(t) for t in ctx[i + n: i + n + k - 1]]
                break
        return (cont + [int(ctx[-1])] * (k - 1))[: k - 1]

    def _emit_round(self, s: int, r: _Request, toks, m: int) -> bool:
        """A slot's tokens of one round (the m accepted and the one after
        them): emitted until the request finishes; True if it did."""
        self.accepted_total += m
        self.proposed_total += self.k - 1
        self._pos[s] += m + 1
        self._last_tok[s] = int(toks[m])
        for t in toks[: m + 1]:
            r.emit(int(t))
            self.tokens_out += 1
            if (len(r.tokens) >= r.max_new or t == r.eos_id
                    or _hits_stop(r)):
                self._finish(s, r)      # overshoot discarded
                return True
        return False

    def _step_ngram(self) -> None:
        """One prompt-lookup round: no draft steps (the proposals come
        from each slot's own context), then the target's chunk-verify and
        greedy acceptance."""
        k = self.k
        chunk = np.repeat(self._last_tok[:, None], k, axis=1)  # [B, k]
        for s in self._active():
            chunk[s, 1:] = self._lookup_proposal(self._req[s])
        tpred = self._verify(chunk, self._pos).argmax(-1)        # [B, k]
        self.steps += 1
        self._occupancy_sum += len(self._active())
        for s in self._active():
            m = 0
            while m < k - 1 and chunk[s, m + 1] == tpred[s, m]:
                m += 1
            self._emit_round(s, self._req[s], tpred[s], m)

    def _step(self) -> None:
        if self.multi_step:
            return self._step_multi()
        if self.ngram:
            return self._step_ngram()
        k = self.k
        pos = self._pos.copy()
        # sampled slots draft by sampling from q (their own temperature,
        # their own generator); greedy slots by argmax, in the same batched
        # draft step
        sampled = {s: self._req[s] for s in self._active()
                   if self._req[s].temperature > 0.0}
        drafts = [self._last_tok.copy()]
        d_tok = self._last_tok.copy()
        q_dists: List[Dict[int, np.ndarray]] = []  # per j: slot -> q [V]
        for j in range(k - 1):
            dl = _fetch(self._draft_step(d_tok, pos + j))
            d_tok = dl.argmax(-1).astype(np.int64)
            qj: Dict[int, np.ndarray] = {}
            for s, r in sampled.items():
                q = self._soft(dl[s], r.temperature)
                qj[s] = q
                d_tok[s] = r.rng.choice(q.size, p=q)
            q_dists.append(qj)
            drafts.append(d_tok)
        # the LAST draft token's KV row too: a full-acceptance round moves
        # pos past it, and an unwritten row would be attended by every
        # later draft step
        self._draft_step(d_tok, pos + k - 1)
        chunk = np.stack(drafts, axis=1)                     # [B, k]

        t_logits = self._verify(chunk, pos)                  # [B, k, V]
        tpred = t_logits.argmax(-1)                          # [B, k]
        self.steps += 1
        self._occupancy_sum += len(self._active())

        for s in self._active():
            r = self._req[s]
            if r.temperature > 0.0:
                # rejection sampling: accept x ~ q with prob
                # min(1, p(x)/q(x)); on rejection draw from max(p-q, 0)
                p_dists = [self._soft(t_logits[s, j], r.temperature)
                           for j in range(k)]
                accepted = []
                m = 0
                for j in range(k - 1):
                    x = int(chunk[s, j + 1])
                    qx = q_dists[j][s][x]
                    px = p_dists[j][x]
                    if r.rng.random() < min(1.0, px / max(qx, 1e-30)):
                        accepted.append(x)
                        m += 1
                        continue
                    res = np.maximum(p_dists[j] - q_dists[j][s], 0.0)
                    tot = res.sum()
                    if tot <= 0:  # q covers p exactly; resample p
                        res, tot = p_dists[j], 1.0
                    accepted.append(int(r.rng.choice(res.size,
                                                     p=res / tot)))
                    break
                else:
                    # every draft accepted: bonus token from p_{k-1}
                    accepted.append(int(r.rng.choice(
                        p_dists[k - 1].size, p=p_dists[k - 1])))
            else:
                m = 0
                while m < k - 1 and chunk[s, m + 1] == tpred[s, m]:
                    m += 1
                accepted = [int(t) for t in tpred[s, : m + 1]]
            self._emit_round(s, r, accepted, m)

    # -- R rounds as one graph ------------------------------------------
    def _ngram_round(self, last, pos, ctx):
        """One prompt-lookup round on the device: the proposal search over
        the per-slot context (its length is pos + 1), the verify, greedy
        acceptance (the cumprod of the match) and the append of the
        accepted tokens. Returns (tokens [B, k], m [B], last, pos)."""
        k, n, L = self.k, self.ngram, self.max_len
        dev = last.device
        ar_n = torch.arange(n, device=dev)
        ar_L = torch.arange(L, device=dev)
        clen = pos + 1                                          # [B]
        # the final n-gram of each context (0 where it would start
        # before the context)
        want = (clen - n)[:, None] + ar_n[None, :]              # [B, n]
        inside = (want >= 0) & (want < L)
        g = torch.where(inside, ctx.gather(1, want.clamp(0, L - 1)),
                        torch.zeros_like(want))
        # the match map over every window start (n static shifts), of the
        # windows that start strictly before the final n-gram
        W = L - n + 1
        ok = torch.ones((ctx.shape[0], W), dtype=torch.bool, device=dev)
        for j in range(n):
            ok = ok & (ctx[:, j:j + W] == g[:, j:j + 1])
        idxs = torch.arange(W, device=dev)[None, :]
        ok = ok & (idxs <= (clen - n - 1)[:, None])
        has = ok.any(dim=1)
        i = torch.where(ok, idxs, torch.full_like(idxs, -1)).amax(dim=1)
        # the continuation window i+n .. i+n+k-2, padded with `last`
        tpos = (i + n)[:, None] + torch.arange(k - 1, device=dev)[None, :]
        cont = ctx.gather(1, tpos.clamp(0, L - 1))
        valid = has[:, None] & (tpos < clen[:, None])
        prop = torch.where(valid, cont, last[:, None])
        chunk = torch.cat([last[:, None], prop], dim=1)         # [B, k]

        logits, presents = self._forward(self.t_verify, self._t_cache,
                                         chunk, pos)
        for nme, v in presents.items():
            self._t_cache[nme].copy_(v)
        tpred = torch.argmax(logits, dim=-1)                    # [B, k]
        eq = chunk[:, 1:] == tpred[:, : k - 1]
        m = torch.cumprod(eq.to(torch.int64), dim=1).sum(dim=1)  # [B]
        last = tpred.gather(1, m[:, None])[:, 0]
        for j in range(k):                      # append the accepted tokens
            w = (ar_L[None, :] == (clen + j)[:, None]) & (j <= m)[:, None]
            ctx.copy_(torch.where(w, tpred[:, j:j + 1], ctx))
        # parking invariant: pos <= L - k always (class docstring)
        pos = torch.clamp(pos + m + 1, max=L - k)
        return tpred, m, last, pos

    def _draft_round(self, last, pos, temp, seeds):
        """One draft-model round on the device: the k-1 draft steps and
        the last draft KV row, the verify, and the acceptance (greedy
        token match, or rejection sampling keyed on (seed, pos, draw)).
        Returns (tokens [B, k], m [B], last, pos)."""
        k, L = self.k, self.max_len
        sampled = temp > 0                                      # [B]
        safe_t = torch.where(sampled, temp, torch.ones_like(temp))[:, None]

        def cat(draw: int, logp):
            """A per-slot categorical draw (Gumbel-max) keyed on (seed,
            pos, draw)."""
            u = _uniform(seeds, pos, logp.shape[-1], draw)
            return torch.argmax(logp - torch.log(-torch.log(u)), dim=-1)

        d_tok, cols, qs = last, [last], []
        for j in range(k - 1):
            dl, presents = self._forward(self.d_decode, self._d_cache,
                                         d_tok[:, None], pos + j)
            for n, v in presents.items():
                self._d_cache[n].copy_(v)
            dl = dl[:, -1, :].to(torch.float32)                 # [B, V]
            ql = torch.log_softmax(dl / safe_t, dim=-1)
            qs.append(ql)
            d_tok = torch.where(sampled, cat(j, ql), torch.argmax(dl, -1))
            cols.append(d_tok)
        # the last draft token's KV row (a full-acceptance round jumps
        # past it)
        _, presents = self._forward(self.d_decode, self._d_cache,
                                    d_tok[:, None], pos + k - 1)
        for n, v in presents.items():
            self._d_cache[n].copy_(v)
        chunk = torch.stack(cols, dim=1)                        # [B, k]
        qlog = torch.stack(qs, dim=1)                           # [B, k-1, V]

        tl, presents = self._forward(self.t_verify, self._t_cache, chunk,
                                     pos)
        for n, v in presents.items():
            self._t_cache[n].copy_(v)
        tl = tl.to(torch.float32)                               # [B, k, V]
        tpred = torch.argmax(tl, dim=-1)
        plog = torch.log_softmax(tl / safe_t[..., None], dim=-1)

        x = chunk[:, 1:]                                        # [B, k-1]
        px = plog[:, : k - 1].gather(-1, x[..., None])[..., 0]
        qx = qlog.gather(-1, x[..., None])[..., 0]
        u = _uniform(seeds, pos, k - 1, 4 * k + 1)              # [B, k-1]
        acc_s = torch.log(u) < (px - qx)        # min(1, p/q), in logs
        acc_g = x == tpred[:, : k - 1]
        acc = torch.where(sampled[:, None], acc_s, acc_g)
        m = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)  # [B]
        # corrections: the residual max(p - q, 0) at each j (p itself
        # where q covers p), the bonus from p_{k-1}; greedy lanes: tpred
        res = torch.clamp(torch.exp(plog[:, : k - 1]) - torch.exp(qlog),
                          min=0.0)
        res_ok = res.sum(dim=-1, keepdim=True) > 1e-9
        rl = torch.where(res_ok, torch.log(torch.clamp(res, min=1e-30)),
                         plog[:, : k - 1])
        corr = [cat(2 * k + j, rl[:, j]) for j in range(k - 1)]
        corr.append(cat(3 * k, plog[:, k - 1]))
        corr = torch.where(sampled[:, None], torch.stack(corr, dim=1), tpred)
        shifted = torch.cat([chunk[:, 1:], chunk[:, :1]], dim=1)
        ar_k = torch.arange(k, device=last.device)[None, :]
        emit = torch.where(ar_k < m[:, None], shifted, corr)
        last = emit.gather(1, m[:, None])[:, 0]
        # parking clamp (class docstring)
        pos = torch.clamp(pos + m + 1, max=L - k)
        return emit, m, last, pos

    def _block_body(self) -> None:
        mio = self._mio
        last, pos = mio["last"], mio["pos"]
        for rd in range(self.multi_step):
            if self.ngram:
                emit, m, last, pos = self._ngram_round(last, pos, self._ctx)
            else:
                emit, m, last, pos = self._draft_round(
                    last, pos, mio["temp"], mio["seeds"])
            mio["emits"][:, rd].copy_(emit)
            mio["ms"][:, rd].copy_(m)

    def _step_multi(self) -> None:
        """R whole rounds as one graph; the host then replays the rounds'
        tokens and counts for emission and finishing."""
        R, mio = self.multi_step, self._mio
        for name, v in (("last", self._last_tok), ("pos", self._pos),
                        ("temp", self._mtemp), ("seeds", self._mseeds)):
            mio[name].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        self._run("ngram_block" if self.ngram else "draft_block",
                  self.t_verify, self._block_body)
        emits, ms = _fetch(mio["emits"]), _fetch(mio["ms"])
        self.steps += 1
        self._occupancy_sum += len(self._active())
        for s in self._active():
            r = self._req[s]
            for rd in range(R):
                if self._emit_round(s, r, emits[s, rd], int(ms[s, rd])):
                    break
