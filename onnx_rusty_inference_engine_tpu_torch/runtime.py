"""The device runtime an Engine and a loaded artifact share: where a run
goes (`resolve_device`) and, on the card, how a forward becomes one CUDA
graph that later calls replay (`capture`, `Replay`, `side_stream`,
`signature`, `collector_held`).

Split out of engine.py so that export_aot.py can replay a loaded program
the way `Engine.__call__` replays a graph (the same counters, the same
collector hold) without importing the graph or the op registry. engine.py
re-exports every name.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
from typing import Callable, Tuple

import torch

from .ops.kernels import counters

__all__ = ["resolve_device", "captures", "capture", "collector_held",
           "Replay", "signature", "side_stream"]


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def captures(device) -> bool:
    """Whether work on `device` runs as captured CUDA graphs: on the card
    it does, on the CPU everything runs eagerly."""
    return torch.device(device).type == "cuda"


def signature(feed: Mapping[str, torch.Tensor]) -> tuple:
    """What a captured graph is specific to: each input's name, shape and
    dtype, and the ORIET_ATTN_I8 switch that ops/fused.py reads (a graph
    captured with it freezes its choice of attention kernel)."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(
        feed.items())), bool(os.environ.get("ORIET_ATTN_I8")))


class Replay:
    """A captured CUDA graph. Calling it replays the graph on the current
    stream and adds the launches the capture recorded to the kernel
    wrappers' counters."""

    def __init__(self, graph, gains: dict):
        self.graph = graph
        self.gains = gains

    def __call__(self) -> None:
        self.graph.replay()
        counters.add(self.gains)


_hold_lock = threading.Lock()
_holds = 0
_collector_was_on = False


@contextlib.contextmanager
def collector_held():
    """Keep Python's cycle collector off for the block. A collection while
    a stream captures may free an unreachable CUDAGraph (one held only by
    a reference cycle, as a dropped Engine's graphs are); its destruction
    is not permitted during a capture and invalidates the capture under
    way, which then fails at its end (cudaErrorStreamCaptureInvalidated).
    The collector is process-wide, so is the hold: nested and concurrent
    holds keep it off until the last one ends, which restores the state
    the first one found. Unreachable cycles are collected after."""
    global _holds, _collector_was_on
    with _hold_lock:
        if _holds == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _holds += 1
    try:
        yield
    finally:
        with _hold_lock:
            _holds -= 1
            if _holds == 0 and _collector_was_on:
                gc.enable()


def capture(fn: Callable, *, stream, pool=None, generators=()
            ) -> Tuple[object, Replay]:
    """Capture `fn()` into one CUDA graph on the side stream `stream`:
    (what fn returned, its tensors now the graph's static outputs; the
    Replay). fn must have run once with the same shapes before (kernels
    built, static values fixed), on `stream`, whose work the caller has
    ordered after the current stream's. The counters' gain over the
    capture is taken back out: nothing ran. `generators` are the
    torch.Generators fn draws from: each replay advances them as the
    eager calls would. The cycle collector is held off meanwhile
    (`collector_held`). A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = counters.snapshot()
    # thread_local: a server captures on its dispatcher thread while
    # client threads may touch the card
    with collector_held(), torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        out = fn()
    gains = counters.delta(before)
    counters.add(gains, -1)
    return out, Replay(graph, gains)


@contextlib.contextmanager
def side_stream(stream):
    """`with side_stream(s):` runs the block on stream `s`, ordered after
    the current stream's work so far, and orders the current stream's
    later work after it. Warm-up runs and captures go there, as CUDA
    graphs want."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield stream
    cur.wait_stream(stream)
