"""The sharded Engine's program: one rank's part of a graph on a mesh.

In the JAX package a sharding is an annotation and XLA inserts the
collectives; the output equals the unsharded run. Here each rank runs the
graph's emitters on its own shards and moves data with explicit
collectives (collectives.py), under the same contract: every rank returns
the whole outputs, equal to the unsharded Engine's.

Weights at rest are shards (`shard_graph`): the rule's placements cut each
sharded weight to this rank's block before the Engine builds its tensors,
and so before the int8 kernels' packing (weights.py) and with the int4
packing already in the weight. A node that reads a sharded weight takes
one of four routes, fixed when the graph is cut:

    a  column-parallel: the weight is sharded on its output axis (the O of
       a Conv / QLinearConv / ConvInteger [O, I, kh, kw], the N of a
       MatMul, Gemm, QLinearMatMul, MatMulInteger or int4 MatMulNBits, the
       feature dim of an embedding Gather). The node's per-output vectors
       (bias, w_scale, w_zero_point, the int4 scales) are cut to the same
       range though the rule replicates them; the hand kernel runs on the
       local shard and an all_gather along the output's channel dim makes
       the output whole.
    b  row-parallel: the weight is sharded on its contraction axis (the I
       of a Conv, QLinearConv or ConvInteger, the K of a MatMul, Gemm,
       QLinearMatMul, MatMulInteger or planar int4 MatMulNBits). The
       activation is cut to the local K range, the node runs without its
       bias, an all_reduce sums the parts and the bias is added once
       after. The int8 nodes sum int32: a QLinearConv or QLinearMatMul
       runs its kernel's int32 epilogue on the local K, and the bias and
       the requant run once after the reduce, so the result is the
       unsharded one bit for bit (a part requantized alone would round
       and saturate early). A planar int4 weight's local K is its block of
       each half of K (a packed byte holds k and K/2 + k) and must be
       whole quant blocks; its scales are cut to those blocks.
    c  expert-parallel: a stacked [E, D, F] MatMul sharded on E
       (models.moe.moe_param_sharding): the local experts' rows of the
       activation run, then an all_gather along E.
    d  any other sharded weight is gathered whole just before the node
       that reads it (and only for that node).

Activations follow the inputs' placements (`input_sharding_fn`): each
rank cuts its block of a sharded input inside the program, and a tensor
keeps the dims it is sharded on (its layout) through every node that is
local along them: elementwise ops (a whole operand is cut to the same
block, a broadcast one is left), normalizations and softmax over unsharded
axes, convolutions and pools on the batch, MatMul on its batch and M dims,
Gather by sharded indices (the embedding of sharded positions), Concat,
Split and Slice off their axis, Transpose, (Un)Squeeze, Flatten, and a
Reshape that keeps a sharded leading dim. Any other node first gathers the
sharded dims of its inputs (for a sequence-sharded prefill: before the
head split, the first node that reads across positions). Graph outputs are
gathered whole. Shape of a sharded tensor is its whole shape.

`SpmdRun.counts` holds the last eager run's nodes by route: "a_column",
"b_row", "c_expert", "d_gathered" (routes), "local" (ran on local
activation shards), "whole" (ran on whole tensors), and the collectives
on activations ("activation_gathers", "output_gathers").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import Graph, Node, _FOLDABLE, _fold_one, _resolve_reshape, \
    _shape_slice
from ..ops.registry import get_emitter, node_label
from . import collectives as C
from .mesh import axis_size
from .sharding import spec_of

__all__ = ["Route", "shard_graph", "SpmdRun", "ROUTES"]

ROUTES = ("a_column", "b_row", "c_expert", "d_gathered")


@dataclasses.dataclass
class Route:
    """How one node runs on a sharded weight."""

    kind: str                       # one of ROUTES
    axis: str = ""                  # the mesh dim of the collective
    out_dim: int = 0                # a, c: the output dim gathered
    act: Optional[Tuple[int, int]] = None   # b, c: (slot, dim) to cut
    bias: Optional[Tuple[int, int]] = None  # b: (slot, channel dim) added
    # after the reduce
    narrow: Optional[int] = None    # a: the output's size along out_dim
    # (the int4 weights' N is padded to 256)
    gathers: Tuple[Tuple[int, str], ...] = ()  # d: (slot, weight name)
    alpha_beta: Optional[Tuple[float, float]] = None  # b for Gemm
    requant: Optional[str] = None   # b for QLinearConv ("conv") and
    # QLinearMatMul ("matmul"): int32 sums reduced, then one requant
    halves: bool = False            # b for planar int4: the local K is a
    # block of each half of K (a packed byte holds k and K/2 + k)


def _arr(graph: Graph, name: str):
    v = graph.constants.get(name) if name else None
    return None if v is None or getattr(v, "dtype", None) == object else v


def _local_range(mesh, axis: str, size: int) -> slice:
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    k = size // n
    return slice(r * k, (r + 1) * k)


def _take(a, dim: int, sl: slice):
    idx = [slice(None)] * np.ndim(a)
    idx[dim] = sl
    return np.ascontiguousarray(np.asarray(a)[tuple(idx)])


class _Cutter:
    """Cuts a graph's weights and decides each node's route."""

    def __init__(self, graph: Graph, mesh, specs: Dict[str, Dict[int, str]]):
        self.graph, self.mesh, self.specs = graph, mesh, specs
        self.consts = dict(graph.constants)
        self.weights = list(graph.weight_names)

    def spec(self, name: str) -> Dict[int, str]:
        return self.specs.get(name, {}) if name else {}

    def per_channel(self, node: Node, slots, size: int, axis: str,
                    dim: int = 0) -> Optional[List[str]]:
        """The node's inputs with the per-output vectors at `slots` (1-D of
        `size`, or [.., size] at `dim` for the int4 scales) cut to the
        local range under new names; None where one is sharded or has
        another shape (the node then takes route d)."""
        inputs = list(node.inputs)
        for s in slots:
            name = inputs[s] if s < len(inputs) else ""
            if not name:
                continue
            if self.spec(name):
                return None
            a = _arr(self.graph, name)
            if a is None:
                return None
            if a.size <= 1:
                continue
            if a.shape[dim] != size or (dim == 0 and a.ndim != 1):
                return None
            local = f"{name}@shard:{axis}"
            if local not in self.consts:
                self.consts[local] = _take(
                    a, dim, _local_range(self.mesh, axis, size))
                if name in self.graph.weight_names:
                    self.weights.append(local)
            inputs[s] = local
        return inputs

    def route(self, node: Node) -> Tuple[Node, Optional[Route]]:
        sharded = [(s, n) for s, n in enumerate(node.inputs) if self.spec(n)]
        if not sharded:
            return node, None
        new = self._route(node, sharded)
        if new is not None:
            return new
        # d: every sharded weight of the node gathered whole, under a name
        # of its own (no packed form and no constant answers to it)
        inputs = list(node.inputs)
        gathers = []
        for s, name in sharded:
            inputs[s] = f"{name}@whole"
            gathers.append((s, name))
        return (dataclasses.replace(node, inputs=inputs),
                Route("d_gathered", gathers=tuple(gathers)))

    def _route(self, node: Node, sharded) -> Optional[Tuple[Node, Route]]:
        op, g = node.op_type, self.graph
        ins = node.inputs

        def one(slot):
            """The one sharded weight at `slot` and its (dim, axis)."""
            if len(sharded) != 1 or sharded[0][0] != slot:
                return None
            sp = self.spec(ins[slot])
            if len(sp) != 1:
                return None
            return next(iter(sp.items()))

        def col(inputs, axis, out_dim, **kw):
            return (dataclasses.replace(node, inputs=inputs, **kw),
                    Route("a_column", axis=axis, out_dim=out_dim))

        if op in ("Conv", "QLinearConv", "ConvInteger") \
                and int(node.attr("group", 1)) == 1:
            wslot = 3 if op == "QLinearConv" else 1
            hit = one(wslot)
            w = _arr(g, ins[wslot])
            if hit is None or w is None:
                return None
            d, axis = hit
            if d == 0:
                slots = {"Conv": (2,), "QLinearConv": (4, 5, 8),
                         "ConvInteger": (3,)}[op]
                inputs = self.per_channel(node, slots, w.shape[0], axis)
                return None if inputs is None else col(inputs, axis, 1)
            if d == 1:
                return node, Route(
                    "b_row", axis=axis, act=(0, 1),
                    bias=(2, 1) if op == "Conv" and len(ins) > 2 and ins[2]
                    else None,
                    requant="conv" if op == "QLinearConv" else None)
            return None
        if op == "MatMul":
            hit = one(1)
            w = _arr(g, ins[1])
            if hit is None or w is None:
                return None
            d, axis = hit
            if w.ndim == 2 and d == 1:
                return col(list(ins), axis, -1)
            if w.ndim == 2 and d == 0:
                return node, Route("b_row", axis=axis, act=(0, -1))
            if w.ndim == 3 and d == 0:
                return node, Route("c_expert", axis=axis, out_dim=-3,
                                   act=(0, -3))
            return None
        if op == "Gemm":
            hit = one(1)
            w = _arr(g, ins[1])
            if hit is None or w is None or w.ndim != 2:
                return None
            d, axis = hit
            trans_b = int(node.attr("transB", 0))
            n_dim, k_dim = (0, 1) if trans_b else (1, 0)
            if d == n_dim:
                inputs = self.per_channel(node, (2,), w.shape[n_dim], axis)
                c = _arr(g, ins[2]) if len(ins) > 2 and ins[2] else None
                if c is not None and c.ndim == 2 and c.shape[1] > 1:
                    inputs = list(node.inputs)
                    local = f"{ins[2]}@shard:{axis}"
                    self.consts[local] = _take(c, 1, _local_range(
                        self.mesh, axis, c.shape[1]))
                    inputs[2] = local
                return None if inputs is None else col(inputs, axis, -1)
            if d == k_dim:
                a_k = 0 if int(node.attr("transA", 0)) else 1
                return node, Route(
                    "b_row", axis=axis, act=(0, a_k),
                    bias=(2, -1) if len(ins) > 2 and ins[2] else None,
                    alpha_beta=(float(node.attr("alpha", 1.0)),
                                float(node.attr("beta", 1.0))))
            return None
        if op in ("QLinearMatMul", "MatMulInteger"):
            wslot = 3 if op == "QLinearMatMul" else 1
            hit = one(wslot)
            w = _arr(g, ins[wslot])
            if hit is None or w is None or w.ndim != 2:
                return None
            if hit[0] == 0:
                return node, Route(
                    "b_row", axis=hit[1], act=(0, -1),
                    requant="matmul" if op == "QLinearMatMul" else None)
            slots = (4, 5) if op == "QLinearMatMul" else (3,)
            inputs = self.per_channel(node, slots, w.shape[1], hit[1])
            return None if inputs is None else col(inputs, hit[1], -1)
        if op == "MatMulNBits":
            w = _arr(g, ins[1])
            sp = self.spec(ins[1])
            if w is not None and w.ndim == 2 and list(sp) == [1] \
                    and [s for s, _ in sharded] == [1]:
                return self._int4_rows(node, w, sp[1])
            if w is None or w.ndim != 2 or list(sp) != [0] or any(
                    s not in (1, 2) for s, _ in sharded):
                return None
            axis = sp[0]
            planar = node.attr("layout", "") == "planar"
            s_dim = 1 if planar else 0
            sname = ins[2]
            s_spec = self.spec(sname)
            inputs = list(ins)
            if s_spec:
                if s_spec != {s_dim: axis}:
                    return None
            else:
                a = _arr(g, sname)
                if a is None or a.shape[s_dim] != w.shape[0]:
                    return None
                local = f"{sname}@shard:{axis}"
                self.consts[local] = _take(a, s_dim, _local_range(
                    self.mesh, axis, a.shape[s_dim]))
                self.weights.append(local)
                inputs[2] = local
            n = axis_size(self.mesh, axis)
            N = int(node.attr("N"))
            attrs = dict(node.attrs)
            if n > 1:
                attrs["N"] = w.shape[0] // n
            new, route = col(inputs, axis, -1, attrs=attrs)
            if n > 1:
                route.narrow = N
            return new, route
        if op == "Gather":
            hit = one(0)
            w = _arr(g, ins[0])
            gaxis = int(node.attr("axis", 0)) % max(1, np.ndim(w))
            if hit is None or w is None or hit[0] == gaxis:
                return None
            d, axis = hit
            if d < gaxis:
                return None
            return col(list(ins), axis, d - w.ndim)
        return None

    def _int4_rows(self, node: Node, w, axis: str
                   ) -> Optional[Tuple[Node, Route]]:
        """Route b for a planar int4 weight sharded on its packed K/2 dim:
        rank r's bytes hold k in its block of each half of K, so its scales
        are its block of the low half's quant blocks and the same of the
        high half's, and its activation the same two K ranges; the local K
        must be whole quant blocks, else None (route d)."""
        from ..ops.kernels.qmatmul_int4 import planar_layout

        if node.attr("layout", "") != "planar":
            return None
        n, r = axis_size(self.mesh, axis), self.mesh.get_local_rank(axis)
        K = int(node.attr("K"))
        nbh, bs = planar_layout(K, int(node.attr("block_size", K)))
        scales = _arr(self.graph, node.inputs[2])
        if nbh % n or scales is None or scales.shape[0] != 2 * nbh:
            return None
        k = nbh // n
        rows = np.r_[r * k:(r + 1) * k, nbh + r * k:nbh + (r + 1) * k]
        local = f"{node.inputs[2]}@rows:{axis}"
        self.consts[local] = np.ascontiguousarray(np.asarray(scales)[rows])
        self.weights.append(local)
        inputs = list(node.inputs)
        inputs[2] = local
        attrs = dict(node.attrs, K=K // n)
        return (dataclasses.replace(node, inputs=inputs, attrs=attrs),
                Route("b_row", axis=axis, act=(0, -1), halves=True))

    def cut(self) -> Tuple[Graph, Dict[int, Route]]:
        nodes, routes = [], {}
        for i, node in enumerate(self.graph.nodes):
            new, route = self.route(node)
            nodes.append(new)
            if route is not None:
                routes[i] = route
        for name, sp in self.specs.items():
            a = self.consts[name]
            for d, axis in sp.items():
                a = _take(a, d, _local_range(self.mesh, axis, a.shape[d]))
            self.consts[name] = a
        used = {i for n in nodes for i in n.inputs if i} | set(
            self.graph.outputs)
        consts = {k: v for k, v in self.consts.items()
                  if k in used or k not in self.graph.constants
                  or k in self.specs}
        local = dataclasses.replace(
            self.graph, nodes=nodes, constants=consts,
            weight_names=[w for w in dict.fromkeys(self.weights)
                          if w in consts])
        return local, routes


def shard_graph(graph: Graph, mesh, param_sharding_fn: Optional[Callable]
                ) -> Tuple[Graph, Dict[str, Dict[int, str]],
                           Dict[int, Route]]:
    """(this rank's graph: sharded weights cut to its block, per-output
    vectors of column-parallel nodes cut under new names; weight name ->
    {tensor dim: mesh dim} of every sharded weight; node index -> its
    Route)."""
    specs: Dict[str, Dict[int, str]] = {}
    if param_sharding_fn is not None:
        for name in graph.weight_names:
            a = _arr(graph, name)
            if a is None or isinstance(a, torch.Tensor):
                continue
            sp = spec_of(mesh, param_sharding_fn(name, a), np.ndim(a))
            sp = {d: ax for d, ax in enumerate(sp) if ax is not None}
            for d, ax in sp.items():
                if a.shape[d] % axis_size(mesh, ax):
                    raise ValueError(
                        f"{name}: dim {d} of size {a.shape[d]} does not "
                        f"divide over {ax}={axis_size(mesh, ax)}")
            if sp:
                specs[name] = sp
    local, routes = _Cutter(graph, mesh, specs).cut()
    return local, specs, routes


# --------------------------------------------------------------------------
# activation layouts
# --------------------------------------------------------------------------
_ELEMENTWISE = {
    "Add", "Sub", "Mul", "Div", "Pow", "Mod", "Where", "Max", "Min", "Sum",
    "Mean", "Equal", "Less", "LessOrEqual", "Greater", "GreaterOrEqual",
    "And", "Or", "Xor", "Not", "Relu", "LeakyRelu", "Elu", "Selu", "Celu",
    "Gelu", "Tanh", "Sigmoid", "HardSigmoid", "HardSwish", "Softplus",
    "Softsign", "Erf", "Exp", "Log", "Sqrt", "Reciprocal", "Neg", "Abs",
    "Sign", "Floor", "Ceil", "Round", "Cast", "CastLike", "Identity",
    "Clip", "IsNaN", "IsInf", "PRelu", "Mish", "ThresholdedRelu", "Shrink",
    "QuantizeLinear", "DequantizeLinear", "QLinearAdd", "QLinearMul",
    "QLinearLeakyRelu", "QLinearSigmoid", "BitShift", "Sin", "Cos",
}
_BATCH_LOCAL = {
    "Conv", "QLinearConv", "ConvInteger", "ConvTranspose", "MaxPool",
    "AveragePool", "LpPool", "GlobalAveragePool", "GlobalMaxPool",
    "GlobalLpPool", "QLinearGlobalAveragePool", "QLinearAveragePool",
    "BatchNormalization", "InstanceNormalization", "LRN",
}
_REDUCE = {"ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
           "ReduceProd", "ReduceL2", "ReduceL1", "ReduceSumSquare",
           "ReduceLogSumExp"}


class SpmdRun:
    """Runs one rank's graph (from `shard_graph`) with its collectives."""

    def __init__(self, mesh, specs: Dict[str, Dict[int, str]],
                 routes: Dict[int, Route],
                 input_sharding_fn: Optional[Callable] = None):
        self.mesh = mesh
        self.key = C.register_mesh(mesh)
        self.specs = specs
        self.routes = routes
        self.input_sharding_fn = input_sharding_fn
        self.counts: Dict[str, int] = {}

    def gk(self, axis: str) -> str:
        return f"{self.key}/{axis}"

    def n(self, axis: str) -> int:
        return axis_size(self.mesh, axis)

    def group_keys(self) -> List[str]:
        return [self.gk(a) for a in self.mesh.mesh_dim_names]

    # -- collectives on activations --------------------------------------
    def _gather(self, t: torch.Tensor, lay: Dict[int, str],
                dims=None) -> Tuple[torch.Tensor, Dict[int, str]]:
        """t made whole along `dims` (default: every sharded dim)."""
        lay = dict(lay)
        for d in sorted(lay if dims is None else dims):
            t = C.all_gather(t, d, self.gk(lay.pop(d)))
            self.counts["activation_gathers"] += 1
        return t, lay

    def _whole_inputs(self, ins, lays):
        for s, lay in enumerate(lays):
            if lay:
                ins[s], lays[s] = self._gather(ins[s], lay)

    # -- one node ----------------------------------------------------------
    def _maps(self, node: Node, ins) -> Optional[dict]:
        """For a node that may run on local shards, per input slot a
        function from its dims to the outputs' dims (None: that dim may
        not stay sharded); else None."""
        op = node.op_type
        t_slots = [s for s, t in enumerate(ins)
                   if isinstance(t, torch.Tensor)]
        if not t_slots:
            return None
        ranks = {s: ins[s].dim() for s in t_slots}
        R = max(ranks.values())
        n_out = len([o for o in node.outputs if o])

        def right(forbid=()):
            """Broadcast alignment from the right; `forbid`: output dims
            that may not stay sharded."""
            return {s: (lambda d, s=s: None if d + R - ranks[s] in forbid
                        else d + R - ranks[s]) for s in t_slots}

        def only(slot, fn):
            """`fn` for one slot's dims, None for every other slot's."""
            return {s: fn if s == slot else (lambda d: None)
                    for s in t_slots}

        if op in _ELEMENTWISE:
            if n_out != 1:
                return None
            if op in ("QuantizeLinear", "DequantizeLinear") and len(ins) > 1 \
                    and isinstance(ins[1], torch.Tensor) \
                    and ins[1].numel() > 1:
                return right((int(node.attr("axis", 1)) % R,))
            return right()
        if op in ("Softmax", "LogSoftmax", "Hardmax"):
            opset = self._ctx.opset
            ax = int(node.attr("axis", -1 if opset >= 13 else 1))
            ax %= R
            forbid = (ax,) if opset >= 13 else tuple(range(ax, R))
            return right(forbid)
        if op == "LayerNormalization":
            if n_out != 1:
                return None
            ax = int(node.attr("axis", -1)) % R
            return right(tuple(range(ax, R)))
        if op in _REDUCE:
            if not int(node.attr("keepdims", 1)):
                return None
            axes = node.attr("axes")
            if axes is None and len(node.inputs) > 1 and node.inputs[1]:
                return None
            forbid = tuple(range(R)) if axes is None else tuple(
                int(a) % R for a in axes)
            return right(forbid)
        if op in _BATCH_LOCAL:
            if n_out != 1:  # MaxPool's indices count over the whole batch
                return None
            return only(0, lambda d: 0 if d == 0 else None)
        if op in ("Concat", "QLinearConcat"):
            return right((int(node.attr("axis", 0)) % R,))
        if op == "Split":
            ax = int(node.attr("axis", 0)) % R
            return only(0, lambda d: None if d == ax else d)
        if op == "Transpose":
            perm = node.attr("perm") or list(range(R))[::-1]
            inv = {int(p): i for i, p in enumerate(perm)}
            return only(0, lambda d: inv[d])
        if op in ("Unsqueeze", "Squeeze"):
            axes = node.attr("axes")
            if axes is None and len(node.inputs) > 1 and node.inputs[1]:
                axes = self._static(node.inputs[1])
                if axes is None:
                    return None
            r_in = ranks[0]
            if op == "Unsqueeze":
                if axes is None:
                    return None
                axes = np.asarray(axes).reshape(-1)
                r_out = r_in + len(axes)
                axes = {int(a) % r_out for a in axes}
                kept = [i for i in range(r_out) if i not in axes]
                return only(0, lambda d: kept[d])
            if axes is None:
                axes = [i for i in range(r_in) if ins[0].shape[i] == 1]
            axes = {int(a) % r_in for a in np.asarray(axes).reshape(-1)}
            pos = {d: j for j, d in enumerate(
                i for i in range(r_in) if i not in axes)}
            return only(0, lambda d: pos.get(d))
        if op == "Flatten":
            if int(node.attr("axis", 1)) % (R + 1) == 0:
                return None
            return only(0, lambda d: 0 if d == 0 else None)
        if op == "Slice":
            if len(node.inputs) > 3 and node.inputs[3]:
                axes = self._static(node.inputs[3])
                if axes is None:
                    return None
                sliced = np.asarray(axes).reshape(-1)
            elif len(node.inputs) > 1:  # opset >= 10: starts an input
                sliced = range(ins[1].numel())
            else:
                sliced = node.attr("axes",
                                   range(len(node.attr("starts", ()))))
            forbid = {int(a) % R for a in sliced}
            return only(0, lambda d: None if d in forbid else d)
        if op == "Gather":
            ax = int(node.attr("axis", 0)) % ranks[0]
            ri = ranks.get(1, 0)
            m = {0: lambda d: d if d < ax else (None if d == ax
                                                else d - 1 + ri)}
            if 1 in ranks:
                m[1] = lambda d: ax + d
            return m
        if op == "MatMul":
            if len(t_slots) != 2 or min(ranks.values()) < 2:
                return None
            ra, rb = ranks[0], ranks[1]
            return {0: lambda d: (None if d == ra - 1 else
                                  R - 2 if d == ra - 2 else d + R - ra),
                    1: lambda d: (None if d >= rb - 2 else d + R - rb)}
        if op == "Gemm":
            ta = int(node.attr("transA", 0))
            m = {0: lambda d: 0 if d == ta else None, 1: lambda d: None}
            if 2 in ranks:
                m[2] = (lambda d: 0 if d == 0 else None) \
                    if ranks[2] == 2 else (lambda d: None)
            return m
        return None

    def _static(self, name: str):
        v = self._ctx.constant(name)
        return None if v is None else np.asarray(v)

    def _local(self, node: Node, ins, lays) -> Optional[dict]:
        """Bring a node's inputs to one layout it can run on locally: the
        output layout {out dim: mesh dim}, with `ins` cut or gathered in
        place; None where the node runs on whole inputs (they are gathered
        then)."""
        if not any(lays):
            return {}
        maps = self._maps(node, ins)
        if maps is None:
            return None
        want: Dict[int, str] = {}
        glob: Dict[int, int] = {}
        for s, m in maps.items():
            for d, axis in sorted(lays[s].items()):
                od = m(d)
                if od is None or want.get(od, axis) != axis:
                    ins[s], lays[s] = self._gather(ins[s], lays[s], [d])
                    continue
                want[od] = axis
                glob[od] = ins[s].shape[d] * self.n(axis)
        for s, m in maps.items():
            inv = {}
            for d in range(ins[s].dim()):
                od = m(d)
                if od is not None:
                    inv[od] = d
            for od, axis in want.items():
                d = inv.get(od)
                if d is None or d in lays[s]:
                    continue
                size = ins[s].shape[d]
                if size == 1:
                    continue
                if size != glob[od]:
                    return None
                ins[s] = C.shard(ins[s], d, self.gk(axis))
                lays[s] = {**lays[s], d: axis}
        return want

    def _reshape(self, node: Node, x: torch.Tensor, lay) -> Optional[tuple]:
        """A Reshape that keeps a sharded leading dim, run on the local
        rows: (output, layout), or None."""
        if set(lay) != {0}:
            return None
        target = self._static(node.inputs[1])
        if target is None:
            return None
        whole = (x.shape[0] * self.n(lay[0]),) + tuple(x.shape[1:])
        out = _resolve_reshape(whole, np.asarray(target),
                               int(node.attr("allowzero", 0)))
        if not out or out[0] != whole[0]:
            return None
        return x.reshape((x.shape[0],) + tuple(out[1:])), dict(lay)

    def _run_node(self, idx: int, node: Node, ctx) -> None:
        env = ctx.env
        lays_env = self._lays
        route = self.routes.get(idx)
        ins = [env[i] if i and i in env else None for i in node.inputs]
        lays = [dict(lays_env.get(i, {})) if i else {} for i in node.inputs]
        if route is not None and route.kind == "d_gathered":
            for s, name in route.gathers:
                t = env[name]
                for d, axis in sorted(self.specs[name].items()):
                    t = C.all_gather(t, d, self.gk(axis))
                ins[s] = t
        if node.op_type == "Reshape" and lays[0] and route is None:
            hit = self._reshape(node, ins[0], lays[0])
            if hit is not None:
                env[node.outputs[0]], lay = hit
                lays_env[node.outputs[0]] = lay
                self.counts["local"] += 1
                return
        out_lay = self._local(node, ins, lays)
        if out_lay is None:
            self._whole_inputs(ins, lays)
            out_lay = {}
        if route is not None and route.act is not None:
            s, d = route.act
            a = ins[s]
            d %= a.dim()
            if route.kind == "b_row" or (a.dim() >= 3 and a.shape[d] > 1):
                if d in lays[s]:
                    ins[s], lays[s] = self._gather(ins[s], lays[s], [d])
                ins[s] = self._cut_k(ins[s], d, route)
        bias = None
        if route is not None and route.bias is not None:
            bias = ins[route.bias[0]]
            ins[route.bias[0]] = None
        finish = None
        if route is not None and route.requant is not None:
            from ..ops import quantized

            split = (quantized.qlinear_conv_int32 if route.requant == "conv"
                     else quantized.qlinear_matmul_int32)
            outs = self._emit(node, lambda: split(ctx, node, ins))
            outs, finish = [outs[0]], outs[1]
        else:
            emitter = get_emitter(node.op_type, node.domain)
            outs = list(self._emit(node, lambda: emitter(ctx, node, ins)))
        if route is not None and route.kind in ("a_column", "c_expert"):
            y = C.all_gather(outs[0], route.out_dim, self.gk(route.axis))
            if route.narrow is not None:
                y = y.narrow(route.out_dim % y.dim(), 0, route.narrow)
            outs[0] = y
        elif route is not None and route.kind == "b_row":
            y = C.all_reduce(outs[0], self.gk(route.axis))
            if finish is not None:
                y = finish(y)
            if bias is not None:
                if route.alpha_beta is not None:
                    y = y + route.alpha_beta[1] * bias
                else:
                    cd = route.bias[1] % y.dim()
                    shape = [1] * y.dim()
                    shape[cd] = -1
                    y = y + bias.reshape(shape)
            outs[0] = y
        if route is not None:
            self.counts[route.kind] += 1
        else:
            self.counts["local" if out_lay else "whole"] += 1
        for name, val in zip(node.outputs, outs):
            if name:
                env[name] = val
                if out_lay and isinstance(val, torch.Tensor):
                    lays_env[name] = dict(out_lay)

    def _emit(self, node: Node, call):
        """call(), in the node's profiler range while a profiler runs."""
        if self._profiling:
            with torch.profiler.record_function(node_label(node)):
                return call()
        return call()

    def _cut_k(self, a: torch.Tensor, d: int, route: Route) -> torch.Tensor:
        """This rank's part of the contraction dim `d` of a whole
        activation: its block of d, or (planar int4) its block of each
        half of d."""
        g = self.gk(route.axis)
        if not route.halves:
            return C.shard(a, d, g)
        h = a.shape[d] // 2
        return torch.cat([C.shard(a.narrow(d, 0, h), d, g),
                          C.shard(a.narrow(d, h, h), d, g)], dim=d)

    # -- the program ---------------------------------------------------------
    def run(self, ctx, graph: Graph, inputs) -> Dict[str, torch.Tensor]:
        """Run `graph` (this rank's) from whole `inputs` in `ctx`: the
        inputs' blocks cut per `input_sharding_fn`, the nodes on their
        routes and layouts, the outputs gathered whole."""
        self._ctx = ctx
        self._profiling = torch._C._autograd._profiler_enabled()
        self.counts = {k: 0 for k in ROUTES + (
            "local", "whole", "activation_gathers", "output_gathers")}
        self._lays: Dict[str, Dict[int, str]] = {}
        env = ctx.env
        if self.input_sharding_fn is not None:
            for name in graph.input_names:
                t = env.get(name)
                if not isinstance(t, torch.Tensor):
                    continue
                sp = spec_of(self.mesh, self.input_sharding_fn(name, t),
                             t.dim())
                lay = {d: ax for d, ax in enumerate(sp) if ax is not None}
                for d, ax in lay.items():
                    t = C.shard(t, d, self.gk(ax))
                env[name] = t
                if lay:
                    self._lays[name] = lay
        for idx, node in enumerate(graph.nodes):
            if node.op_type in ("Shape", "Size") and node.inputs[0] in env \
                    and isinstance(env[node.inputs[0]], torch.Tensor):
                shp = list(env[node.inputs[0]].shape)
                lay = self._lays.get(node.inputs[0]) or self.specs.get(
                    node.inputs[0], {})
                for d, ax in lay.items():
                    shp[d] *= self.n(ax)
                if node.op_type == "Shape":
                    val = np.asarray(shp[_shape_slice(node, len(shp))],
                                     dtype=np.int64)
                else:
                    val = np.asarray(int(np.prod(shp)), dtype=np.int64)
                ctx.put_static(node.outputs[0], val)
                continue
            if node.op_type in _FOLDABLE and len(node.outputs) == 1 and all(
                    (not i) or ctx.constant(i) is not None
                    for i in node.inputs) and not any(
                    i in self.specs for i in node.inputs):
                try:
                    folded = _fold_one(
                        node, {i: ctx.constant(i) for i in node.inputs if i})
                except Exception:
                    folded = None
                if folded is not None:
                    ctx.put_static(node.outputs[0], np.asarray(folded))
                    continue
            self._run_node(idx, node, ctx)
        out = {}
        for o in graph.outputs:
            v = env[o]
            lay = self._lays.get(o)
            if lay and isinstance(v, torch.Tensor):
                for d in sorted(lay):
                    v = C.all_gather(v, d, self.gk(lay[d]))
                    self.counts["output_gathers"] += 1
            out[o] = v
        self._ctx = None
        return out

