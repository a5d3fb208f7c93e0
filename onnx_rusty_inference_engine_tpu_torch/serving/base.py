"""_ServerBase: the shared continuous-batching server core (slot pool,
admission queue, dispatcher thread, finishing, stats, sampling state).

The port's counterpart of onnx_rusty_inference_engine_tpu/serving/base.py,
with two faults of the reference repaired:

- every future is resolved under one lock (`_resolve`): the dispatcher's
  `_finish` and the watchdog's `_fail` used to check `done()` and then set
  a result or an exception without one, so the two could race to
  InvalidStateError;
- the watchdog exempts every step that runs a graph the server has not
  run before (`_new_graph`: a CUDA-graph capture, after a len_buckets
  switch for one), not only the server's first step.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import CancelledError, Future, InvalidStateError
from typing import Dict, List, Optional

import numpy as np
import torch

from .request import _Request, _hits_stop


class _ServerBase:
    """Shared continuous-batching server core: slot pool, admission queue,
    dispatcher thread, request finishing, serving stats. Subclasses
    provide `_admit(slot, request)` and `_step()` (one batched decode
    dispatch over the slot pool) plus their own engines and caches."""

    def _init_sampling_state(self, slots: int, vocab: int,
                             device_multi: bool) -> None:
        """Per-slot sampling state for the multi_step blocks: [B] arrays
        copied to the device before each block, so sampled / biased /
        penalized requests ride the same K-step graph as greedy ones.
        Neutral values make a slot exactly greedy. device_multi gates the
        lazy [B, V] counts/bias allocation."""
        self._vocab = int(vocab)
        self._device_multi = bool(device_multi)
        self._temp = np.zeros((slots,), np.float32)
        self._topk = np.full((slots,), vocab, np.int64)
        self._topp = np.ones((slots,), np.float32)
        self._minp = np.zeros((slots,), np.float32)
        self._fpen = np.zeros((slots,), np.float32)
        self._ppen = np.zeros((slots,), np.float32)
        self._seeds = np.zeros((slots,), np.int64)
        # dense [B, V] device state, allocated on the first admission that
        # needs it and then kept (the K-step graphs read it by address):
        # counts, the generated-token histogram for frequency/presence
        # penalties; bias, the additive logit_bias rows
        self._counts: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None

    @staticmethod
    def _needs_device_sampling(r: _Request) -> bool:
        return bool(r.temperature > 0.0 or r.logit_bias is not None
                    or r.frequency_penalty or r.presence_penalty)

    def _alloc_sampling_rows(self) -> None:
        if self._counts is None:
            self._counts = torch.zeros((self.B, self._vocab),
                                       dtype=torch.int32, device=self.device)
            self._bias = torch.zeros((self.B, self._vocab),
                                     dtype=torch.float32, device=self.device)

    def _set_slot_sampling(self, slot: int, r: _Request) -> None:
        """Write a claimed slot's sampling config into the per-slot arrays
        the multi_step blocks consume. Neutral values reduce a slot to
        exact greedy, so one graph serves mixed traffic."""
        V = self._vocab
        self._temp[slot] = r.temperature
        self._topk[slot] = max(1, min(int(r.top_k), V)) if r.top_k else V
        self._topp[slot] = 1.0 if r.top_p is None else r.top_p
        self._minp[slot] = 0.0 if r.min_p is None else r.min_p
        self._fpen[slot] = r.frequency_penalty
        self._ppen[slot] = r.presence_penalty
        self._seeds[slot] = r.seed
        if self._device_multi and self._needs_device_sampling(r):
            self._alloc_sampling_rows()
        if self._counts is not None:
            row = np.zeros((V,), np.int32)
            for t in r.tokens:  # admission-emitted tokens count too
                row[t] += 1
            self._counts[slot].copy_(torch.from_numpy(row))
            brow = np.zeros((V,), np.float32)
            if r.logit_bias is not None:
                idx, val = r.logit_bias
                brow[idx] = val.astype(np.float32)
            self._bias[slot].copy_(torch.from_numpy(brow))

    def _emit_multi_block(self, toks: np.ndarray, K: int) -> None:
        """Host bookkeeping after a K-step device block (pure decode):
        emit each active slot's K tokens in order, finishing early on
        max_new/eos/stop (overshoot tokens are discarded; the slot's
        over-advanced cache rows are dead state masked by pos on
        re-admission)."""
        self.steps += 1
        self._occupancy_sum += len(self._active())
        for s in self._active():
            r = self._req[s]
            for j in range(K):
                self._pos[s] += 1
                tok = int(toks[s, j])
                r.emit(tok)
                self._last_tok[s] = tok
                self.tokens_out += 1
                if (len(r.tokens) >= r.max_new or tok == r.eos_id
                        or _hits_stop(r)):
                    self._finish(s, r)
                    break

    def _start_dispatch(self, slots: int, autostart: bool = True) -> None:
        """Call LAST in subclass __init__ (after all slot state exists).
        autostart=False defers the dispatcher thread until start(): pre-
        queue requests first, so the loop admits them in submission order
        with no timing races."""
        self.B = slots
        self._req: List[Optional[_Request]] = [None] * slots
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._by_future: Dict[Future, _Request] = {}
        self._submit_lock = threading.Lock()
        # every future is set under this lock, after a check that it is
        # still pending: the dispatcher and the watchdog both resolve
        self._resolve_lock = threading.Lock()
        self._running = True
        self._draining = False
        self.steps = 0
        self.tokens_out = 0
        self.requests_done = 0
        self._occupancy_sum = 0
        self._latencies: List[float] = []
        # failure detection (opt-in): step_timeout > 0 arms a watchdog
        # that turns a stuck decode step into RuntimeError futures instead
        # of hanging every client. A step that runs a graph the server
        # has not run before is exempt (`_new_graph`): on the card it
        # captures a CUDA graph, and a first call also builds kernels.
        self.step_timeout: Optional[float] = getattr(
            self, "step_timeout", None)
        self._step_started: Optional[float] = None
        self._step_exempt = False
        self._graphs_run: set = set()
        self._watchdog_fired = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if autostart:
            self._thread.start()

    def _new_graph(self, key) -> None:
        """Called by a step before it runs the graph `key` (its kind and
        cache length): the first step that runs it is exempt from the
        step timeout."""
        if key not in self._graphs_run:
            self._graphs_run.add(key)
            self._step_exempt = True

    def start(self) -> None:
        """Launch the dispatcher of a server built with autostart=False
        (no-op if already running; a stopped server cannot restart)."""
        if not self._thread.is_alive():
            self._thread.start()

    # -- client API ------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int,
                 timeout: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 **kw) -> List[int]:
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           **kw).result(timeout)

    def stop(self, drain: bool = False) -> None:
        """Shut the dispatcher down. drain=True finishes every admitted
        AND queued request first; drain=False (default) stops after the
        current step and FAILS outstanding futures with RuntimeError:
        callers never hang on a stopped server."""
        if drain:
            self._draining = True
        with self._submit_lock:
            # _enqueue holds this lock across its running-check + put, so
            # after this flip no new request can slip past both drains
            self._running = False
        self._q.put(None)
        if self._thread.ident is not None:  # autostart=False, never started
            self._thread.join(timeout=300 if drain else 30)
        self._drain_queue("server stopped before request was admitted")

    def _drain_queue(self, msg: str) -> None:
        # non-blocking: a still-alive dispatcher may be draining
        # concurrently, and get() would deadlock on the last item
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                self._fail(None, r, RuntimeError(msg))

    def cancel(self, future: Future) -> bool:
        """Request-level cancellation: the slot is freed at the next step
        boundary and the future fails with CancelledError. Queued (not
        yet admitted) requests cancel the same way. True if the future
        belongs to a live request of this server."""
        r = self._by_future.get(future)
        if r is None:
            return False
        r.cancelled = True
        return True

    def stats(self) -> Dict[str, float]:
        """Serving counters (the LLM analog of serve.ServerStats)."""
        lat = np.asarray(self._latencies) if self._latencies else np.zeros(1)
        return {
            "requests": self.requests_done,
            "decode_steps": self.steps,
            "tokens_out": self.tokens_out,
            "tokens_per_step": self.tokens_out / max(1, self.steps),
            "mean_slot_occupancy": self._occupancy_sum / max(1, self.steps)
                                   / self.B,
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
        }

    # -- slot lifecycle ---------------------------------------------------
    def _enqueue(self, r: _Request) -> Future:
        # lock pairs with stop()'s _running flip: either we raise, or our
        # put is in the queue before the flip and a drain will see it
        with self._submit_lock:
            if not self._running:
                raise RuntimeError("server stopped")
            self._by_future[r.future] = r
            self._q.put(r)
        return r.future

    def _clear_slot(self, slot: int) -> None:
        self._req[slot] = None
        self._pos[slot] = self.max_len - 1      # park

    def _resolve(self, r: _Request, exc: Optional[BaseException]) -> bool:
        """Set r's future once: its tokens, or `exc`. False when it was
        already resolved (by the other thread, or cancelled by its
        caller)."""
        with self._resolve_lock:
            self._by_future.pop(r.future, None)
            if r.future.done():
                return False
            try:
                if exc is None:
                    r.future.set_result(r.tokens)
                else:
                    r.future.set_exception(exc)
            except InvalidStateError:  # the caller's own future.cancel()
                return False
            if exc is None:
                self.requests_done += 1
                self._latencies.append(time.perf_counter() - r.t_enqueue)
            return True

    def _finish(self, slot_or_none, r: _Request) -> None:
        self._resolve(r, None)
        if slot_or_none is not None:
            self._clear_slot(slot_or_none)

    def _fail(self, slot_or_none, r: _Request, exc: BaseException) -> None:
        self._resolve(r, exc)
        if slot_or_none is not None:
            self._clear_slot(slot_or_none)

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self._req) if r is not None]

    # -- dispatcher -------------------------------------------------------
    def _watchdog(self) -> None:
        """Fail-fast monitor for the opt-in step_timeout: a _step that
        exceeds the deadline fails every in-flight and queued future with
        a RuntimeError and marks the server dead. Slot state is NOT
        mutated: the dispatcher thread may still be inside the stuck
        step."""
        assert self.step_timeout
        poll = min(0.2, self.step_timeout / 4)
        while self._running and not self._watchdog_fired:
            time.sleep(poll)
            t0 = self._step_started
            if (t0 is None or self._step_exempt
                    or time.perf_counter() - t0 <= self.step_timeout):
                continue
            self._watchdog_fired = True
            with self._submit_lock:
                self._running = False
            exc = RuntimeError(
                f"decode step exceeded step_timeout={self.step_timeout}s "
                "- device failure suspected; server stopped")
            for r in list(self._req):
                if r is not None:
                    self._fail(None, r, exc)
            self._drain_queue(str(exc))
            return

    def _loop(self) -> None:
        wd_armed = False
        while True:
            # lazy arming: step_timeout may be set after __init__
            if self.step_timeout and not wd_armed:
                threading.Thread(target=self._watchdog, daemon=True).start()
                wd_armed = True
            if not self._running:
                # drain mode keeps stepping until all work completes;
                # otherwise exit now (leftovers failed below)
                if not self._draining or (not self._active()
                                          and self._q.empty()):
                    break
            # fill free slots from the queue (non-blocking when busy)
            free = [i for i, r in enumerate(self._req) if r is None]
            block = not self._active() and self._running
            for slot in free:
                try:
                    r = self._q.get(timeout=0.05 if block else 0)
                except queue.Empty:
                    break
                if r is None:
                    continue  # stop sentinel; loop head decides exit
                if r.cancelled:
                    self._fail(None, r, CancelledError())
                    continue
                try:
                    self._admit(slot, r)
                except Exception as e:  # request-level failure isolation
                    # pass the slot: a partially-claimed admission must
                    # not leave a dead request occupying it
                    self._fail(slot, r, e)
                block = False
            # cancellation sweep: freed at the step boundary
            for s in self._active():
                if self._req[s].cancelled:
                    self._fail(s, self._req[s], CancelledError())
            if self._active():
                self._step_exempt = False
                self._step_started = time.perf_counter()
                try:
                    self._step()
                except Exception as e:
                    for s in self._active():
                        self._fail(s, self._req[s], e)
                finally:
                    self._step_started = None
                if self._watchdog_fired:
                    break   # futures already failed; state untrusted
        # stopped without drain: no caller may hang on a dead server
        for s in self._active():
            self._fail(s, self._req[s],
                       RuntimeError("server stopped with request in flight"))
        self._drain_queue("server stopped before request was admitted")
