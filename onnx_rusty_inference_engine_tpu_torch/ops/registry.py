"""Lowering-rule registry: ONNX op_type -> PyTorch emitter.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/registry.py.
An emitter takes (ctx, node, input tensors) and returns the node's output
tensors; engine.py runs the emitters eagerly in topological order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..graph import Graph

# keyed by (domain, op_type); domain "" is ai.onnx (the spec treats
# "ai.onnx" as an alias for the default domain)
_REGISTRY: Dict[tuple, Callable] = {}


class UnsupportedOpError(NotImplementedError):
    """Clean error for ops (or op variants) the port cannot run."""


def _norm_domain(domain: str) -> str:
    return "" if domain in ("", "ai.onnx") else domain


def register(*op_types: str, domain: str = ""):
    def deco(fn):
        for op in op_types:
            _REGISTRY[(_norm_domain(domain), op)] = fn
        return fn
    return deco


def _load_emitters() -> None:
    """Import the emitter modules, whose `register` calls fill the
    registry (once; later calls find them imported)."""
    from . import fused, quantized, standard  # noqa: F401


def get_emitter(op_type: str, domain: str = "") -> Callable:
    """Dispatch by (domain, op_type).

    Lookup order: the node's own domain first, then the default domain
    (many exporters leave node.domain empty even for contrib ops, and some
    stamp com.microsoft on nodes lowered with default-domain semantics)."""
    _load_emitters()
    dom = _norm_domain(domain)
    fn = _REGISTRY.get((dom, op_type))
    if fn is None and dom:
        fn = _REGISTRY.get(("", op_type))
    if fn is None and not dom:
        # bare contrib node (exporters frequently omit the domain)
        fn = _REGISTRY.get(("com.microsoft", op_type))
    if fn is None:
        raise UnsupportedOpError(
            f"op '{op_type}' (domain {domain!r}) has no lowering rule; "
            f"supported: {supported_ops()}"
        )
    return fn


def supported_ops():
    _load_emitters()
    return sorted({op for _, op in _REGISTRY})


class LoweringContext:
    """Context handed to emitters: graph constants, opset, the value env,
    values known before the run (`static_env`: Shape of a tensor, and
    foldable arithmetic on such values), and the pre-packed QLinearConv and
    QLinearMatMul weights (`packed`, weight name -> kernel layout; see
    weights.py)."""

    def __init__(self, graph: Graph, env: dict,
                 packed: Optional[Dict[str, torch.Tensor]] = None):
        self.graph = graph
        self.env = env  # tensor name -> torch.Tensor
        self.static_env: Dict[str, np.ndarray] = {}
        self.opset = graph.opset
        self.packed = {} if packed is None else packed
        # True when this run's batch differs from the graph's declared input
        # batch (engine.lower sets it per run): Expand may then put the
        # runtime batch in place of a baked leading dim. When False, baked
        # shapes hold and a mismatch is an invalid model.
        self.batch_polymorphic = True

    def constant(self, name: str) -> Optional[np.ndarray]:
        """Value of a tensor known before the run, else None."""
        v = self.graph.constants.get(name)
        if v is None:
            v = self.static_env.get(name)
        return v

    def require_constant(self, name: str, what: str) -> np.ndarray:
        v = self.constant(name)
        if v is None:
            raise UnsupportedOpError(
                f"{what} must be known before the run (tensor {name!r})")
        return v
