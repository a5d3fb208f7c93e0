"""Device-side timing with CUDA events.

The port's counterpart of onnx_rusty_inference_engine_tpu/utils/timing.py.
Work is warmed up first, then a run of iterations is bracketed by two CUDA
events on the current stream, so the number is device time for
device-resident inputs, not the host's enqueue time. Both functions need a
card and raise without one; there is no CPU fallback for a device metric.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

__all__ = ["device_loop_timer", "engine_throughput"]


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: a device time needs a CUDA device")


def device_loop_timer(step_fn: Callable, init_carry, iters: int = 200,
                      warmup: int = 3) -> float:
    """Seconds per iteration of `step_fn` (carry -> carry), each iteration
    fed the previous one's result, timed with CUDA events."""
    _require_cuda("device_loop_timer")
    carry = init_carry
    with torch.no_grad():
        for _ in range(warmup):
            carry = step_fn(carry)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            carry = step_fn(carry)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def engine_throughput(engine, feed: Dict[str, object], iters: int = 100,
                      warmup: int = 3) -> float:
    """Steady-state examples/s of an engine on the card, inputs and outputs
    resident on the device."""
    _require_cuda("engine_throughput")
    if engine.device.type != "cuda":
        raise RuntimeError("engine_throughput: the engine is not on a "
                           "CUDA device")
    from ..weights import as_device_tensor

    dev_feed = {k: as_device_tensor(v, engine.device)
                for k, v in feed.items()}
    fn, params = engine._fn, engine.params

    def step(carry):
        fn(params, dev_feed)  # stream order serializes the iterations
        return carry

    sec = device_loop_timer(step, None, iters, warmup)
    batch = int(next(iter(dev_feed.values())).shape[0])
    return batch / sec
