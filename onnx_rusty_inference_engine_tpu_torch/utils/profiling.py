"""Profiling: torch.profiler traces whose ranges carry the ONNX node names.

The port's counterpart of onnx_rusty_inference_engine_tpu/utils/
profiling.py. Under an active profiler the Engine runs each emitter call in
a range named `<OpType>.<onnx node name>` (engine.lower_packed), the label
the JAX lowering gives its ops with `jax.named_scope`; the hand kernels are
`torch.library` ops (`oriet::...`, ops/kernels/), so each launch lies under
its op and so under its node's range. A replayed CUDA graph runs no Python
and carries no range: trace eager forwards (`Engine.forward`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace CPU and (where there is a card) CUDA activity of the enclosed
    block into a `*.pt.trace.json` under `log_dir`, which TensorBoard's
    profiler plugin and Perfetto open.

    Usage:
        with profiling.trace("/tmp/tb"):
            engine.forward(feed)
    """
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()  # the block's kernels end in the trace
        prof.stop()
