"""TF32 off: the flags under which fp32 convolutions and matrix products
run in full fp32, as the JAX package's Precision.HIGHEST does.

A module of its own, free of the graph and the op registry, because the
emitters (ops/standard.py), the kernels' plain versions (ops/kernels/) and
a loaded artifact (export_aot.py) all set them: an exported program runs
its convs and matmuls under the caller's flags, not under the emitters'
context managers, so `ExportedModel` sets both around every call.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["cudnn_fp32_exact", "matmul_fp32_exact", "fp32_exact"]


def cudnn_fp32_exact():
    """cuDNN flags as they are, with TF32 off (fp32 convs in full fp32)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


@contextlib.contextmanager
def matmul_fp32_exact():
    """CUDA matmul flags as they are, with TF32 off (fp32 matrix products
    in full fp32), restored on exit."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = prev


@contextlib.contextmanager
def fp32_exact():
    """Both: TF32 off for convs and matrix products."""
    with cudnn_fp32_exact(), matmul_fp32_exact():
        yield
