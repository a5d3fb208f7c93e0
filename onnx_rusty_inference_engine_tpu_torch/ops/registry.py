"""Lowering-rule registry: ONNX op_type -> PyTorch emitter.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/registry.py.
An emitter takes (ctx, node, input tensors) and returns the node's output
tensors; engine.py runs the emitters eagerly in topological order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import onnx_io
from ..graph import (_FOLDABLE, Graph, _fold_one, _node_from_proto,
                     _shape_slice)

# keyed by (domain, op_type); domain "" is ai.onnx (the spec treats
# "ai.onnx" as an alias for the default domain)
_REGISTRY: Dict[tuple, Callable] = {}


# ops that need no emitter when their inputs are known before the run:
# run_nodes makes Shape/Size of a tensor, and the foldable ops over static
# values, static values (Shape, Size, Constant, ConstantOfShape and Range
# run only so, and have no emitter)
STATIC_OPS = frozenset({"Shape", "Size"} | _FOLDABLE)


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
    from . import (bounded, contrib_transformers, control_flow,  # noqa: F401
                   core_attention, extra, fused, losses, ml, quantized, rnn,
                   sequences, standard, vision_roi)


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
    return sorted({op for _, op in _REGISTRY} | STATIC_OPS)


class LoweringContext:
    """Context handed to emitters: graph constants, opset, the value env,
    values known before the run (`static_env`: Shape of a tensor, and
    foldable arithmetic on such values), and the pre-packed QLinearConv and
    QLinearMatMul weights (`packed`, weight name -> kernel layout; see
    weights.py).

    `device` is where the run's tensors live. `statics`, where given, keeps
    the static values of one input signature with their device tensors, so
    that a later run copies nothing from the host and may be captured into
    a CUDA graph. `subgraphs` holds the attribute subgraphs (If/Loop/Scan
    bodies) prepared for `eval_subgraph`: their nodes, and their
    initializers as tensors on the device, made once when the graph is
    prepared (`prepare_subgraphs`)."""

    def __init__(self, graph: Graph, env: dict,
                 packed: Optional[Dict[str, torch.Tensor]] = None, *,
                 device=None, statics: Optional[dict] = None,
                 subgraphs: Optional[dict] = None):
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
        self.device = torch.device("cpu") if device is None else device
        self.statics = statics
        self.subgraphs = {} if subgraphs is None else subgraphs
        self.scope = None  # id of the subgraph being lowered, else None
        # names a subgraph defines (inputs, node outputs): an outer graph
        # constant of the same name is hidden inside it
        self.shadowed: frozenset = frozenset()

    def constant(self, name: str) -> Optional[np.ndarray]:
        """Value of a tensor known before the run, else None."""
        v = self.static_env.get(name)
        if v is None and name not in self.shadowed:
            v = self.graph.constants.get(name)
        return v

    def require_constant(self, name: str, what: str) -> np.ndarray:
        v = self.constant(name)
        if v is None:
            raise UnsupportedOpError(
                f"{what} must be known before the run (tensor {name!r})")
        return v

    def put_static(self, name: str, val) -> torch.Tensor:
        """Bind `name` to a value known before the run: numpy in
        `static_env`, a tensor on the device in `env`. With `statics` the
        tensor is made once per input signature and reused (a subgraph's
        value is keyed by its scope, and reused only where it is equal)."""
        val = np.asarray(val)
        t = None
        if self.statics is not None:
            if self.scope is None:
                hit = self.statics.get(name)
                if hit is not None:
                    val, t = hit
            else:
                key = (self.scope, name)
                for v, tv in self.statics.get(key, ()):
                    if (v.dtype == val.dtype and v.shape == val.shape
                            and np.array_equal(v, val)):
                        t = tv
                        break
        if t is None:
            t = torch.as_tensor(val, device=self.device)
            if self.statics is not None:
                if self.scope is None:
                    self.statics[name] = (val, t)
                else:
                    self.statics.setdefault((self.scope, name),
                                            []).append((val, t))
        self.static_env[name] = val
        self.env[name] = t
        return t

    def device_constant(self, key: str, make) -> torch.Tensor:
        """A value an emitter makes on the host (`make()`: index tables,
        windows, filter banks, random draws) as a tensor on the device.
        With `statics` it is made once per input signature and scope and
        reused, so that a later run copies nothing from the host and may
        be captured; `key` names it within the scope, and carries whatever
        of the node's input shapes the value depends on."""
        if self.statics is None:
            return torch.as_tensor(np.asarray(make()), device=self.device)
        k = ("__const__", self.scope, key)
        t = self.statics.get(k)
        if t is None:
            t = self.statics[k] = torch.as_tensor(np.asarray(make()),
                                                  device=self.device)
        return t

    def host_constant(self, key: str, make):
        """A host object an emitter derives from its node alone (the tree
        ensembles' tables): made once per input signature and scope where
        the run keeps its static values (`statics`), else made now."""
        if self.statics is None:
            return make()
        k = ("__host__", self.scope, key)
        hit = self.statics.get(k)
        if hit is None:
            hit = self.statics[k] = make()
        return hit

    def run_nodes(self, nodes) -> None:
        """Run `nodes` in order into `env`: Shape/Size of a tensor and the
        foldable ops over static values become static values, every other
        node runs its emitter. Under an active profiler each emitter call
        runs in a `<OpType>.<node>` range (`node_label`)."""
        profiling = torch._C._autograd._profiler_enabled()
        env = self.env
        for node in nodes:
            if node.op_type in ("Shape", "Size") and node.inputs[0] in env \
                    and isinstance(env[node.inputs[0]], torch.Tensor):
                shp = tuple(env[node.inputs[0]].shape)
                if node.op_type == "Shape":
                    val = np.asarray(shp[_shape_slice(node, len(shp))],
                                     dtype=np.int64)
                else:
                    val = np.asarray(int(np.prod(shp)), dtype=np.int64)
                self.put_static(node.outputs[0], val)
                continue
            if node.op_type in _FOLDABLE and len(node.outputs) == 1 and all(
                    (not i) or self.constant(i) is not None
                    for i in node.inputs):
                try:
                    folded = _fold_one(
                        node, {i: self.constant(i) for i in node.inputs if i})
                except Exception:
                    folded = None
                if folded is not None:
                    self.put_static(node.outputs[0], np.asarray(folded))
                    continue

            emitter = get_emitter(node.op_type, node.domain)
            ins = [env[i] if i else None for i in node.inputs]
            if profiling:
                with torch.profiler.record_function(node_label(node)):
                    outs = emitter(self, node, ins)
            else:
                outs = emitter(self, node, ins)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val

    def eval_subgraph(self, gproto, inputs: list) -> list:
        """Lower an attribute subgraph (If/Loop/Scan body) inline: the JAX
        package's LoweringContext.eval_subgraph.

        ONNX subgraphs close over the outer scope, so the run starts from a
        copy of the outer env (and of `static_env`); `inputs` bind by
        position to the subgraph's declared inputs. Returns the subgraph's
        output values in order. ONNX requires subgraph nodes to be
        topologically sorted already."""
        nodes, consts, defined = self.subgraph(gproto)
        env = dict(self.env)
        env.update(consts)
        for vi, val in zip(gproto.inputs, inputs):
            env[vi.name] = val
        sub = LoweringContext(self.graph, env, self.packed,
                              device=self.device, statics=self.statics,
                              subgraphs=self.subgraphs)
        sub.batch_polymorphic = self.batch_polymorphic
        sub.scope = id(gproto)
        sub.shadowed = self.shadowed | defined
        sub.static_env = {k: v for k, v in self.static_env.items()
                          if k not in defined}
        sub.static_env.update(
            {k: np.asarray(v) for k, v in gproto.initializers.items()})
        sub.run_nodes(nodes)
        return [env[vi.name] for vi in gproto.outputs]

    def subgraph(self, gproto) -> tuple:
        """(nodes, initializer tensors on the device, the names it defines)
        of an attribute subgraph: those `prepare_subgraphs` made, else made
        now."""
        prep = self.subgraphs.get(id(gproto))
        if prep is None:
            prep = self.subgraphs[id(gproto)] = _prepare(gproto, self.device)
        return prep[1:]


def _prepare(gproto, device) -> tuple:
    """(gproto, its nodes as Graph nodes, its initializers as tensors on
    `device`, the names its inputs and nodes define): gproto is kept, so
    that its id stays its own."""
    from ..weights import params_from_numpy

    nodes = [_node_from_proto(n) for n in gproto.nodes]
    defined = frozenset([vi.name for vi in gproto.inputs]
                        + [o for n in nodes for o in n.outputs if o])
    return (gproto, nodes, params_from_numpy(gproto.initializers, device),
            defined)


def _attr_graphs(attributes) -> list:
    """The GraphProtos among a node's attribute values."""
    out = []
    for v in attributes:
        for g in (v if isinstance(v, list) else [v]):
            if isinstance(g, onnx_io.GraphProto):
                out.append(g)
    return out


def subgraphs_of(nodes) -> list:
    """Every attribute subgraph of `nodes` (Graph nodes), nested ones
    included."""
    out, todo = [], _attr_graphs(v for n in nodes for v in n.attrs.values())
    while todo:
        g = todo.pop()
        out.append(g)
        todo += _attr_graphs(a.value for n in g.nodes
                             for a in n.attributes.values())
    return out


def prepare_subgraphs(graph: Graph, device) -> dict:
    """The graph's attribute subgraphs prepared for eval_subgraph, by id:
    their initializers become tensors on `device` here, once, and not on
    every run (a copy from the host inside a run would stall it and cannot
    be captured). They keep their dtypes, as the JAX lowering keeps a
    subgraph's initializers (its eval_subgraph takes them as they are)."""
    return {id(g): _prepare(g, device) for g in subgraphs_of(graph.nodes)}


def node_label(node) -> str:
    """`<OpType>.<node name>`, the node's first output standing in for a
    missing name: the range an emitter call runs in under a profiler."""
    return f"{node.op_type}.{node.name or node.outputs[0]}"
