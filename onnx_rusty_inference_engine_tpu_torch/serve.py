"""Serving layer: continuous batching of inference requests.

The port's counterpart of onnx_rusty_inference_engine_tpu/serve.py.
Requests enter a queue; a dispatcher thread drains it, packs requests into
the largest ready power-of-two bucket, pads the remainder, runs the
Engine, and scatters per-request results to futures. On the card each
bucket is one CUDA graph of the Engine (captured on the bucket's first
call, or by `warmup`), so steady state replays graphs and nothing else.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["InferenceServer", "ServerStats"]


class ServerStats:
    """Requests, batches and rows served. `padding_overhead` is the share
    of the rows run that were padding: rows, not requests, because a
    request may carry several examples (the JAX package's ServerStats
    counts requests against rows, onnx_rusty_inference_engine_tpu/serve.py:41)."""

    def __init__(self) -> None:
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.padded = 0
        self.latencies: List[float] = []
        self._lock = threading.Lock()

    def record(self, n_requests: int, n_rows: int, n_padded: int,
               latencies: Sequence[float]):
        """One batch: n_requests requests of n_rows examples in all, run
        as a bucket of n_padded rows."""
        with self._lock:
            self.requests += n_requests
            self.batches += 1
            self.rows += n_rows
            self.padded += n_padded - n_rows
            self.latencies.extend(latencies)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            lat = np.asarray(self.latencies) if self.latencies else np.zeros(1)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "padding_overhead": self.padded / max(1, self.rows + self.padded),
                "p50_latency_s": float(np.percentile(lat, 50)),
                "p99_latency_s": float(np.percentile(lat, 99)),
            }


class _Item:
    __slots__ = ("feed", "n", "future", "t_enqueue")

    def __init__(self, feed: Dict[str, np.ndarray]):
        self.feed = feed  # every array shares the leading batch dim
        self.n = int(next(iter(feed.values())).shape[0])
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class InferenceServer:
    """Continuous-batching front end over a compiled Engine.

    Parameters
    ----------
    engine: an engine.Engine
    input_name: graph input fed per request (single-input models)
    batch_buckets: compiled batch sizes, ascending. Each request is a single
        example (leading dim 1) or a small batch; the dispatcher packs.
    max_delay_s: how long to wait for more requests before dispatching a
        partially filled bucket.
    """

    def __init__(
        self,
        engine,
        input_name: Optional[str] = None,
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        max_delay_s: float = 0.002,
        warmup: bool = False,
        example_shape: Optional[Tuple[int, ...]] = None,
        autostart: bool = True,
    ):
        self.engine = engine
        self.input_name = input_name or engine.graph.input_names[0]
        self.buckets = sorted(batch_buckets)
        self.max_delay_s = max_delay_s
        self.stats = ServerStats()
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if warmup and example_shape is not None:
            self.warmup(example_shape)
        if autostart:
            self._thread.start()

    def start(self) -> None:
        """Launch the dispatcher of a server built with autostart=False
        (pre-queue requests first for deterministic packing; a stopped
        server cannot restart)."""
        if not self._thread.is_alive():
            self._thread.start()

    # -- client API ------------------------------------------------------
    def submit(self, x) -> Future:
        """x: one example — an array (single-input models, with or without
        the leading batch dim of 1) or a dict {input_name: array} for
        multi-input models (e.g. BERT's ids/type_ids/attention_mask)."""
        if not isinstance(x, dict):
            x = {self.input_name: np.asarray(x)}
        feed = {}
        for spec in self.engine.graph.inputs:
            if spec.name not in x:
                raise KeyError(f"missing input {spec.name!r}")
            v = np.asarray(x[spec.name])
            if v.ndim == len(spec.shape) - 1:
                v = v[None]
            feed[spec.name] = v
        item = _Item(feed)
        self._q.put(item)
        return item.future

    def infer(self, x: np.ndarray, timeout: Optional[float] = None):
        return self.submit(x).result(timeout)

    def warmup(self, example_shape: Tuple[int, ...]) -> None:
        """Run every bucket once: on the card that captures its graph."""
        for b in self.buckets:
            x = np.zeros((b,) + tuple(example_shape), dtype=np.float32)
            for v in self.engine({self.input_name: x}).values():
                v.cpu()

    def stop(self) -> None:
        self._running = False
        self._q.put(None)
        if self._thread.ident is not None:  # autostart=False, never started
            self._thread.join(timeout=10)

    # -- dispatcher -------------------------------------------------------
    def _collect(self) -> List[_Item]:
        items: List[_Item] = []
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return items
        if first is None:
            return items
        items.append(first)
        deadline = time.perf_counter() + self.max_delay_s
        max_bucket = self.buckets[-1]
        while sum(i.n for i in items) < max_bucket:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        while self._running:
            items = self._collect()
            if not items:
                continue
            n = sum(i.n for i in items)
            bucket = self._bucket_for(n)
            if n > bucket:  # overflow: requeue the tail
                tail_items, kept, acc = [], [], 0
                for i in items:
                    if acc + i.n <= bucket:
                        kept.append(i)
                        acc += i.n
                    else:
                        tail_items.append(i)
                for t in reversed(tail_items):
                    self._q.put(t)
                items = kept

            def pack(name: str) -> np.ndarray:
                xs = np.concatenate([i.feed[name] for i in items], axis=0)
                if xs.shape[0] < bucket:  # pad to the compiled batch size
                    pad = np.zeros((bucket - xs.shape[0],) + xs.shape[1:],
                                   xs.dtype)
                    xs = np.concatenate([xs, pad], axis=0)
                return xs

            feed = {spec.name: pack(spec.name)
                    for spec in self.engine.graph.inputs}
            try:
                out = self.engine(feed)
                out_np = {k: v.cpu().numpy() for k, v in out.items()}
            except Exception as e:  # request-level failure tolerance
                for i in items:
                    i.future.set_exception(e)
                continue

            now = time.perf_counter()
            offset = 0
            lats = []
            total = int(next(iter(feed.values())).shape[0])
            for i in items:
                i.future.set_result(
                    {k: v[offset:offset + i.n] for k, v in out_np.items()})
                lats.append(now - i.t_enqueue)
                offset += i.n
            self.stats.record(len(items), sum(i.n for i in items), total,
                              lats)
