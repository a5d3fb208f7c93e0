"""What the benchmarks share: the device, the timer, the JSON line."""

from __future__ import annotations

import json
import time
from typing import Callable

import torch


def device_of(cpu: bool) -> torch.device:
    """The card, or the CPU where `--cpu` asks for it (the card raises
    without one: runtime.resolve_device)."""
    from ..runtime import resolve_device

    return resolve_device("cpu" if cpu else "cuda")


def clock(device: torch.device) -> str:
    return "cuda events" if device.type == "cuda" else "host (cpu)"


def seconds_per_step(step: Callable, carry, iters: int,
                     device: torch.device, warmup: int = 3) -> float:
    """Seconds per call of `step` (carry -> carry): CUDA events on the card
    (utils.timing.device_loop_timer), the host clock on the CPU."""
    if device.type == "cuda":
        from ..utils.timing import device_loop_timer

        return device_loop_timer(step, carry, iters=iters, warmup=warmup)
    with torch.no_grad():
        for _ in range(warmup):
            carry = step(carry)
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = step(carry)
    return (time.perf_counter() - t0) / iters


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
