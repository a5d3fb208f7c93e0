"""Inference engine: run a Graph node by node with PyTorch on one device.

The port's counterpart of onnx_rusty_inference_engine_tpu/engine.py. Where
the JAX package lowers the graph into one function and jit-compiles it, this
engine runs the same emitters eagerly under `torch.no_grad()`, in
topological order, on the device the caller names. Values known before the
run (Shape/Size of a tensor, and foldable arithmetic on such values) are
propagated statically, as the JAX lowering does at trace time.

`Engine(graph)` runs on the card; only an explicit `device="cpu"` runs on
the CPU. Not ported yet: the bfloat16 dtype policy, the host prolog/epilog
for string and image front-end ops (a graph that needs it raises), and
capturing the whole graph as one CUDA graph.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .graph import _FOLDABLE, Graph, _fold_one, _shape_slice
from . import ops  # noqa: F401  (importing ops fills the registry)
from .ops.registry import LoweringContext, UnsupportedOpError, get_emitter
from .weights import as_device_tensor, params_from_numpy, prepack_int8_weights

__all__ = ["lower", "Engine", "InferenceResult", "resolve_device"]

# ops that need no emitter when their inputs are known before the run
# (Shape/Size always are; the foldable ops when fed static values)
_STATIC_OPS = {"Shape", "Size"} | _FOLDABLE


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def lower(graph: Graph, device, packed: Optional[Dict[str, torch.Tensor]]
          = None):
    """Build `f(params: dict[str, Tensor], inputs: dict[str, Tensor]) ->
    dict[str, Tensor]` that runs the graph on `device`.

    `params` carries the graph's weights; the other constants (scales, zero
    points, folded values) are moved to the device here, once. `packed`
    holds the pre-packed QLinearConv and QLinearMatMul weights the kernels
    read on the card (`weights.prepack_int8_weights`; `Engine` makes
    them)."""
    device = resolve_device(device)
    consts = params_from_numpy(
        {k: v for k, v in graph.constants.items()
         if k not in graph.weight_names
         and not (isinstance(v, np.ndarray) and v.dtype == object)},
        device)

    def fn(params: Mapping[str, torch.Tensor],
           inputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = dict(consts)
        env.update(params)
        env.update(inputs)
        ctx = LoweringContext(graph, env, packed)

        def static_value(name):
            if name in graph.constants:
                return graph.constants[name]
            return ctx.static_env.get(name)

        for node in graph.nodes:
            # static propagation: Shape/Size of a tensor are known from its
            # shape; foldable ops over static values stay static
            if node.op_type in ("Shape", "Size") and node.inputs[0] in env:
                shp = tuple(env[node.inputs[0]].shape)
                if node.op_type == "Shape":
                    val = np.asarray(shp[_shape_slice(node, len(shp))],
                                     dtype=np.int64)
                else:
                    val = np.asarray(int(np.prod(shp)), dtype=np.int64)
                ctx.static_env[node.outputs[0]] = val
                env[node.outputs[0]] = torch.as_tensor(val, device=device)
                continue
            if node.op_type in _FOLDABLE and len(node.outputs) == 1 and all(
                    (not i) or static_value(i) is not None
                    for i in node.inputs):
                try:
                    folded = _fold_one(
                        node, {i: static_value(i) for i in node.inputs if i})
                except Exception:
                    folded = None
                if folded is not None:
                    folded = np.asarray(folded)
                    ctx.static_env[node.outputs[0]] = folded
                    env[node.outputs[0]] = torch.as_tensor(folded,
                                                           device=device)
                    continue

            emitter = get_emitter(node.op_type, node.domain)
            ins = [env[i] if i else None for i in node.inputs]
            outs = emitter(ctx, node, ins)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return {o: env[o] for o in graph.outputs}

    return fn


class InferenceResult:
    """Structured results: output name -> numpy array, plus wall latency."""

    def __init__(self, outputs: Dict[str, np.ndarray], latency_s: float):
        self.outputs = outputs
        self.latency_s = latency_s

    def __getitem__(self, name: str) -> np.ndarray:
        return self.outputs[name]

    def top_k(self, k: int = 1, output: Optional[str] = None) -> np.ndarray:
        name = output or next(iter(self.outputs))
        arr = self.outputs[name]
        flat = arr.reshape(arr.shape[0], -1)
        return np.argsort(flat, axis=-1)[:, ::-1][:, :k]

    def top1(self, output: Optional[str] = None) -> np.ndarray:
        return self.top_k(1, output)[:, 0]


class Engine:
    """Executor for one ONNX graph on one device.

    Parameters
    ----------
    graph: imported Graph.
    device: where it runs; "cuda" (the default) raises when no card is
        present, only an explicit "cpu" runs on the CPU.
    dtype: compute dtype policy for float tensors; only "float32" is ported.
    """

    def __init__(self, graph: Graph, *, device="cuda",
                 dtype: str = "float32"):
        if np.dtype(dtype) != np.float32:
            raise NotImplementedError(
                f"Engine dtype {dtype!r}: only float32 is ported")
        self.device = resolve_device(device)
        for spec in graph.inputs:
            if spec.dtype == object:
                raise UnsupportedOpError(
                    f"input {spec.name!r} is a string tensor: the host "
                    f"prolog is not ported")
        for node in graph.nodes:  # an op the port lacks fails here, not mid-run
            if node.op_type not in _STATIC_OPS:
                get_emitter(node.op_type, node.domain)
        self.graph = graph
        self.params = params_from_numpy(
            {k: graph.constants[k] for k in graph.weight_names}, self.device)
        self.packed = prepack_int8_weights(graph, self.params)
        self._fn = lower(graph, self.device, self.packed)

    def _canon_inputs(self, inputs) -> Dict[str, torch.Tensor]:
        names = self.graph.input_names
        if isinstance(inputs, (list, tuple)):
            inputs = dict(zip(names, inputs))
        elif not isinstance(inputs, Mapping):
            inputs = {names[0]: inputs}
        return {k: as_device_tensor(v, self.device)
                for k, v in inputs.items()}

    # -- API -----------------------------------------------------------
    def __call__(self, inputs) -> Dict[str, torch.Tensor]:
        """Run once; outputs stay on the device."""
        feed = self._canon_inputs(inputs)
        with torch.no_grad():
            return self._fn(self.params, feed)

    def run(self, inputs) -> InferenceResult:
        t0 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in self(inputs).items()}
        return InferenceResult(out, time.perf_counter() - t0)
