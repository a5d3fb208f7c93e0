"""Typed graph IR + import-time compiler passes.

The port's copy of onnx_rusty_inference_engine_tpu/graph.py: ONNX proto ->
typed IR -> topological sort -> constant folding -> dead-code elimination
(-> passes.optimize). The engine (engine.py) then runs the graph node by
node with PyTorch on one device. Intermediate shapes come from running the
graph; symbolic batch dims are resolved against the caller's input.

Unlike the JAX package's copy, `import_onnx` reads files with the
pure-Python codec only (no C++ loader), and the Shape fold's slice helper
lives here instead of in ops/standard.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import onnx_io
from .onnx_io import ModelProto, NodeProto

__all__ = ["Node", "Graph", "import_onnx", "import_model"]


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]  # "" = omitted optional input
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    domain: str = ""  # "" = ai.onnx; e.g. "com.microsoft" for contrib ops

    def attr(self, key: str, default=None):
        return self.attrs.get(key, default)


@dataclasses.dataclass
class InputSpec:
    """A graph input: its name, shape (a str for a symbolic dim) and dtype,
    a numpy dtype, or `torch.bfloat16` for a BFLOAT16 input (numpy has no
    bfloat16 here; the JAX package's InputSpec carries ml_dtypes')."""

    name: str
    shape: Tuple[Union[int, str], ...]
    dtype: Union[np.dtype, torch.dtype]

    def concrete_shape(self, batch: Optional[int] = None) -> Tuple[int, ...]:
        out = []
        for d in self.shape:
            if isinstance(d, int):
                out.append(d)
            else:  # symbolic — treat as batch-like
                out.append(batch if batch is not None else 1)
        return tuple(out)


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    constants: Dict[str, np.ndarray]  # initializers + folded values
    inputs: List[InputSpec]  # real model inputs only (initializers excluded)
    outputs: List[str]
    opset: int = 13  # ai.onnx (default-domain) opset version
    # all opset_import entries, domain -> version (e.g. com.microsoft: 1)
    opsets: Dict[str, int] = dataclasses.field(default_factory=dict)

    # names of constants that were *initializers* (weights) vs folded scalars
    weight_names: List[str] = dataclasses.field(default_factory=list)

    @property
    def input_names(self) -> List[str]:
        return [i.name for i in self.inputs]

    def producers(self) -> Dict[str, Node]:
        return {o: n for n in self.nodes for o in n.outputs if o}


def _attr_plain(a: onnx_io.Attribute):
    v = a.value
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, onnx_io.TensorData):
        return v.array
    if isinstance(v, list) and v and isinstance(v[0], bytes):
        return [s.decode("utf-8") for s in v]
    return v


def _subgraph_captures(gp: onnx_io.GraphProto) -> set:
    """Names a subgraph reads from the ENCLOSING scope (ONNX closure
    semantics): used names not defined by the subgraph's own inputs,
    initializers, or node outputs; nested subgraphs recurse."""
    defined = set(gp.initializers) | {vi.name for vi in gp.inputs}
    used: set = set()
    nested: List[onnx_io.GraphProto] = []
    for np_ in gp.nodes:
        used.update(i for i in np_.input if i)
        defined.update(o for o in np_.output if o)
        for a in np_.attributes.values():
            if a.g is not None:
                nested.append(a.g)
            if a.graphs:
                nested.extend(a.graphs)
    caps = used - defined
    for sub in nested:
        caps |= _subgraph_captures(sub) - defined
    return caps


def _node_from_proto(n: NodeProto) -> Node:
    attrs = {k: _attr_plain(a) for k, a in n.attributes.items()}
    caps: set = set()
    for a in n.attributes.values():
        if a.g is not None:
            caps |= _subgraph_captures(a.g)
        if a.graphs:
            for sub in a.graphs:
                caps |= _subgraph_captures(sub)
    if caps:
        # implicit dataflow edges for the scheduler/DCE (never exported)
        attrs["__captures__"] = sorted(caps)
    return Node(
        op_type=n.op_type,
        inputs=list(n.input),
        outputs=list(n.output),
        name=n.name,
        attrs=attrs,
        domain=n.domain,
    )


def _shape_slice(node: Node, rank: int) -> slice:
    """Shape-15 start/end attrs -> a python slice over the dims.

    Spec semantics: negatives count from the end, then CLAMP to [0, rank]
    (exporters emit sentinels like end=INT64_MAX meaning "to the end");
    start >= end yields an empty result."""

    def norm(v, default):
        if v is None:
            return default
        v = int(v)
        if v < 0:
            v += rank
        return max(0, min(rank, v))

    return slice(norm(node.attr("start"), 0), norm(node.attr("end"), rank))


def node_deps(n: Node) -> List[str]:
    """Declared inputs plus subgraph closure captures (If/Loop/Scan)."""
    return [i for i in n.inputs if i] + list(n.attrs.get("__captures__", ()))


# --------------------------------------------------------------------------
# Passes
# --------------------------------------------------------------------------
def topo_sort(nodes: List[Node], available: set) -> List[Node]:
    """Kahn's algorithm over tensor-name edges. `available` = inputs+constants."""
    pending = list(nodes)
    seen = set(available)
    out: List[Node] = []
    progress = True
    while pending and progress:
        progress = False
        rest = []
        for n in pending:
            if all(i in seen for i in node_deps(n)):
                out.append(n)
                seen.update(o for o in n.outputs if o)
                progress = True
            else:
                rest.append(n)
        pending = rest
    if pending:
        missing = {
            i for n in pending for i in node_deps(n) if i not in seen
        } - {o for n in pending for o in n.outputs}
        raise ValueError(
            f"graph is not schedulable; unresolvable inputs: {sorted(missing)[:10]}"
        )
    return out


_IDENTITY_OPS = {"Identity", "Dropout"}  # Dropout in inference mode is identity
                                         # (reference: inference_fp32_ops/dropout_op.rs:66-71)


def eliminate_identities(g: Graph) -> None:
    """Rewrite consumers of Identity/inference-Dropout outputs to the source name."""
    alias: Dict[str, str] = {}
    kept: List[Node] = []
    graph_outputs = set(g.outputs)
    captured = {c for n in g.nodes
                for c in n.attrs.get("__captures__", ())}
    for n in g.nodes:
        if n.op_type in _IDENTITY_OPS and n.outputs and \
                n.outputs[0] not in graph_outputs and \
                n.outputs[0] not in captured:
            src = n.inputs[0]
            while src in alias:
                src = alias[src]
            alias[n.outputs[0]] = src
            # secondary outputs (Dropout mask) must be unused to elide
            if any(o and o in _all_consumed(g) for o in n.outputs[1:]):
                kept.append(n)
                del alias[n.outputs[0]]
        else:
            kept.append(n)
    if not alias:
        return
    for n in kept:
        n.inputs = [alias.get(i, i) for i in n.inputs]
    g.outputs = [alias.get(o, o) for o in g.outputs]
    g.nodes = kept


def _all_consumed(g: Graph) -> set:
    s = set(g.outputs)
    for n in g.nodes:
        s.update(node_deps(n))
    return s


# Ops safe to fold at import time when every input is a known constant.
_FOLDABLE = {
    "Reshape", "Shape", "Gather", "Concat", "Cast", "Slice", "Squeeze",
    "Unsqueeze", "Transpose", "Add", "Sub", "Mul", "Div", "ConstantOfShape",
    "Range", "Expand", "Constant", "Identity", "Flatten", "Where", "Equal",
    "Mod", "Neg", "Floor", "Ceil", "Min", "Max", "Sqrt",
}


def _fold_one(n: Node, consts: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    op = n.op_type
    ins = [consts[i] if i else None for i in n.inputs]
    if op == "Constant":
        for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
            if key in n.attrs:
                v = n.attrs[key]
                return np.asarray(v)
        return None
    if op == "Identity":
        return ins[0]
    if op == "Reshape":
        data, shape = ins[0], ins[1].astype(np.int64)
        tgt = _resolve_reshape(data.shape, shape, allowzero=int(n.attr("allowzero", 0)))
        return data.reshape(tgt)
    if op == "Shape":
        return np.asarray(ins[0].shape[_shape_slice(n, ins[0].ndim)],
                          dtype=np.int64)
    if op == "Gather":
        return np.take(ins[0], ins[1].astype(np.int64), axis=int(n.attr("axis", 0)))
    if op == "Concat":
        return np.concatenate([x for x in ins], axis=int(n.attr("axis", 0)))
    if op == "Cast":
        return ins[0].astype(onnx_io.DTYPE_TO_NUMPY[int(n.attr("to"))])
    if op == "Slice":
        return _np_slice(n, ins)
    if op == "Squeeze":
        axes = n.attr("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = ins[1].astype(np.int64).tolist()
        return np.squeeze(ins[0], axis=tuple(axes) if axes else None)
    if op == "Unsqueeze":
        axes = n.attr("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = ins[1].astype(np.int64).tolist()
        out = ins[0]
        for ax in sorted(int(a) for a in axes):
            out = np.expand_dims(out, ax if ax >= 0 else ax + out.ndim + 1)
        return out
    if op == "Transpose":
        perm = n.attr("perm")
        return np.transpose(ins[0], axes=perm)
    if op == "Flatten":
        ax = int(n.attr("axis", 1))
        s = ins[0].shape
        return ins[0].reshape(int(np.prod(s[:ax], dtype=np.int64)), -1)
    if op in ("Add", "Sub", "Mul", "Div"):
        f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply, "Div": np.divide}[op]
        out = f(ins[0], ins[1])
        if op == "Div" and np.issubdtype(ins[0].dtype, np.integer):
            out = (ins[0] // ins[1]).astype(ins[0].dtype)
        return out
    if op == "Mod":
        # fmod=0 (default): result follows the DIVISOR's sign (python %)
        if int(n.attr("fmod", 0)):
            return np.fmod(ins[0], ins[1])
        return np.mod(ins[0], ins[1])
    if op == "Neg":
        return np.negative(ins[0])
    if op == "Floor":
        return np.floor(ins[0])
    if op == "Ceil":
        return np.ceil(ins[0])
    if op == "Sqrt":
        return np.sqrt(ins[0])
    if op == "Min":
        return np.minimum.reduce([x for x in ins])
    if op == "Max":
        return np.maximum.reduce([x for x in ins])
    if op == "Equal":
        return np.equal(ins[0], ins[1])
    if op == "Where":
        return np.where(ins[0], ins[1], ins[2])
    if op == "ConstantOfShape":
        val = n.attr("value")
        fill = val.reshape(-1)[0] if isinstance(val, np.ndarray) else np.float32(0)
        return np.full(tuple(int(d) for d in ins[0]), fill)
    if op == "Range":
        return np.arange(ins[0].item(), ins[1].item(), ins[2].item(),
                         dtype=ins[0].dtype)
    if op == "Expand":
        return np.broadcast_to(ins[0], _broadcast_expand(ins[0].shape, ins[1])).copy()
    return None


def _broadcast_expand(in_shape, shape_arr) -> Tuple[int, ...]:
    tgt = [int(d) for d in shape_arr]
    # ONNX Expand: dims of 1 in target take input's dim (numpy broadcast both ways)
    in_s = (1,) * (len(tgt) - len(in_shape)) + tuple(in_shape)
    tgt = [1] * (len(in_s) - len(tgt)) + tgt
    for a, b in zip(in_s, tgt):
        if a != b and 1 not in (a, b):
            raise ValueError(
                f"Expand: input shape {tuple(in_shape)} is not "
                f"broadcastable to target {[int(d) for d in shape_arr]}")
    return tuple(max(a, b) for a, b in zip(in_s, tgt))


def _resolve_reshape(in_shape: Sequence[int], shape: np.ndarray, allowzero: int = 0
                     ) -> Tuple[int, ...]:
    """Full ONNX Reshape semantics: 0 = copy input dim (unless allowzero), -1 = infer.

    The reference implements only the 0-copy rule and only 4D→2D
    (reference: src/inference_fp32_ops/reshape_op.rs:69-90); this is the
    complete spec.
    """
    dims = [int(d) for d in shape.reshape(-1)]
    out: List[int] = []
    for i, d in enumerate(dims):
        if d == 0 and not allowzero:
            out.append(int(in_shape[i]))
        else:
            out.append(d)
    total = int(np.prod(in_shape, dtype=np.int64))
    if -1 in out:
        idx = out.index(-1)
        rest = int(np.prod([d for j, d in enumerate(out) if j != idx], dtype=np.int64))
        out[idx] = total // rest
    return tuple(out)


def _np_slice(n: Node, ins) -> np.ndarray:
    data = ins[0]
    if len(ins) > 1 and ins[1] is not None:  # opset >= 10: tensor operands
        starts = ins[1].astype(np.int64).tolist()
        ends = ins[2].astype(np.int64).tolist()
        axes = (ins[3].astype(np.int64).tolist() if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (ins[4].astype(np.int64).tolist() if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
    else:  # opset < 10: attributes
        starts = [int(x) for x in n.attr("starts")]
        ends = [int(x) for x in n.attr("ends")]
        axes = [int(x) for x in (n.attr("axes") or range(len(starts)))]
        steps = [1] * len(starts)
    sl = [slice(None)] * data.ndim
    for ax, st, en, sp in zip(axes, starts, ends, steps):
        sl[ax] = slice(st, en, sp)
    return data[tuple(sl)]


def fold_constants(g: Graph) -> None:
    """Evaluate nodes whose inputs are all constants; runs to fixpoint in one
    topological pass."""
    kept: List[Node] = []
    for n in g.nodes:
        if (
            n.op_type in _FOLDABLE
            and all((not i) or i in g.constants for i in n.inputs)
            and len([o for o in n.outputs if o]) == 1
        ):
            try:
                val = _fold_one(n, g.constants)
            except Exception:
                val = None
            if val is not None:
                g.constants[n.outputs[0]] = np.asarray(val)
                continue
        kept.append(n)
    g.nodes = kept


def prune_dead(g: Graph) -> None:
    """Drop nodes (and constants) that don't reach any graph output."""
    needed = set(g.outputs)
    kept_rev: List[Node] = []
    for n in reversed(g.nodes):
        if any(o in needed for o in n.outputs):
            kept_rev.append(n)
            needed.update(node_deps(n))
    g.nodes = list(reversed(kept_rev))
    g.constants = {k: v for k, v in g.constants.items() if k in needed}
    g.weight_names = [w for w in g.weight_names if w in g.constants]


# --------------------------------------------------------------------------
# Import
# --------------------------------------------------------------------------
def import_model(model: ModelProto) -> Graph:
    if isinstance(model, Graph):
        # pass-through so callers may pass pre-imported (possibly
        # transformed) graphs from custom family builders
        return model
    gp = model.graph
    constants: Dict[str, np.ndarray] = dict(gp.initializers)
    inputs: List[InputSpec] = []
    for vi in gp.inputs:
        if vi.name in constants:
            continue  # old exporters re-declare initializers as inputs
        shape = tuple(
            d if isinstance(d, int) else (d or "N") for d in (vi.shape or ())
        )
        if vi.elem_type == onnx_io.BFLOAT16:
            dtype = torch.bfloat16
        else:
            dtype = onnx_io.DTYPE_TO_NUMPY.get(vi.elem_type or onnx_io.FLOAT,
                                               np.dtype(np.float32))
        inputs.append(InputSpec(name=vi.name, shape=shape, dtype=dtype))

    g = Graph(
        name=gp.name or "graph",
        nodes=[_node_from_proto(n) for n in gp.nodes],
        constants=constants,
        inputs=inputs,
        outputs=[vi.name for vi in gp.outputs],
        opset=model.opset_version,
        opsets=dict(model.opset_imports),
        weight_names=list(gp.initializers.keys()),
    )
    available = set(constants) | {i.name for i in inputs}
    g.nodes = topo_sort(g.nodes, available)
    fold_constants(g)
    eliminate_identities(g)
    prune_dead(g)
    from .passes import optimize  # late import (passes depends on this module)

    optimize(g)
    return g


def export_model(g: Graph) -> ModelProto:
    """Graph -> ModelProto (inverse of import_model), e.g. to persist a
    quantized graph as a standard ONNX file (QDQ/QLinear form) so the
    offline quantize step runs once — the framework's checkpoint story
    (the reference never persists anything, SURVEY.md §5)."""
    from .models._builder import _attr

    gp = onnx_io.GraphProto(name=g.name)
    for n in g.nodes:
        proto = onnx_io.NodeProto(op_type=n.op_type, input=list(n.inputs),
                                  output=list(n.outputs), name=n.name,
                                  domain=n.domain)
        for k, v in n.attrs.items():
            if k.startswith("__"):  # internal bookkeeping (captures)
                continue
            proto.attributes[k] = _attr(k, v)
        gp.nodes.append(proto)
    # a bf16 constant stays a torch tensor (onnx_io encodes it as BFLOAT16)
    gp.initializers = {k: v if isinstance(v, torch.Tensor)
                       else np.ascontiguousarray(v)
                       for k, v in g.constants.items()}
    for spec in g.inputs:
        gp.inputs.append(onnx_io.ValueInfo(
            name=spec.name,
            elem_type=(onnx_io.BFLOAT16 if spec.dtype == torch.bfloat16
                       else onnx_io.NUMPY_TO_DTYPE[spec.dtype]),
            shape=[d if isinstance(d, int) else str(d) for d in spec.shape],
        ))
    for o in g.outputs:
        gp.outputs.append(onnx_io.ValueInfo(name=o))
    imports = {dom: ver for dom, ver in g.opsets.items() if dom}
    imports[""] = max(g.opset, 13)
    # declare contrib domains actually used by the graph's nodes
    for n in g.nodes:
        if n.domain and n.domain not in imports:
            imports[n.domain] = 1
    return ModelProto(graph=gp, ir_version=8, opset_version=imports[""],
                      opset_imports=imports, producer_name="oriet")


def save_graph(path: str, g: Graph) -> None:
    onnx_io.save_model(path, export_model(g))


def import_onnx(path: str) -> Graph:
    """Load + import an ONNX file. Prefers the native C++ parser
    (native_loader.py / native/onnx_loader.cc); falls back to the
    pure-Python wire codec where it is off (ORIET_NATIVE=0), cannot be
    built (with a warning), or cannot decode a tensor of the file."""
    from .native_loader import load_model_native

    model = load_model_native(path)
    if model is None:
        model = onnx_io.load_model(path)
    return import_model(model)
