"""The `oriet` operator namespace: each hand kernel as a `torch.library`
operator with three implementations.

    CUDA  the launch (the wrapper's `_launch`: plan, checks, count)
    CPU   the kernel's plain PyTorch version
    fake  the output's shape, dtype and strides from the operands alone

So torch.export traces a graph that runs a hand kernel (export_aot.py),
a profiler puts each launch under its op (`oriet::<name>`), and
`torch.library.opcheck` holds each op's implementations together.

The operators are defined with the low-level `torch.library.Library` and
not `torch.library.custom_op`: custom_op wraps every implementation in
`torch._disable_dynamo`, which imports torch._dynamo (and sympy) at an
op's first call, some 6 s of a process's cold start on an H100 host (a
loaded artifact still pays it, in torch.export.load: chip_smoke.py's
export lines, `artifact_load_split_s`). Nothing here takes a gradient, so
no autograd kernel is registered.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["define"]

LIB = torch.library.Library("oriet", "DEF")


def define(schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define `oriet::<schema>` with its CPU, CUDA and fake
    implementations; the op's overload, which the wrapper calls."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"oriet::{name}", fake, lib=LIB)
    return getattr(torch.ops.oriet, name).default
