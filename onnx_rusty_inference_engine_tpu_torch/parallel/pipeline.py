"""Pipeline parallelism: GPipe stages over a mesh dim, one process a stage.

The port's counterpart of onnx_rusty_inference_engine_tpu/parallel/
pipeline.py. The graph surgery is the JAX package's, on numpy and the
port's graph IR: the imported graph is cut at its residual-stream tensors
into a prefix (embeddings, and the position and mask tensors every layer
reads), N isomorphic layer blocks and a suffix (final norm and head);
the blocks' per-layer constants are stacked on a leading [n_layers, ...]
axis (`infer_boundaries`, `split_stages`, `align_blocks`).

`PipelinedDecoder` runs it on torch.distributed, one process per stage of
the mesh's "pipe" dim: rank s holds rows [s*lps, (s+1)*lps) of every
stacked weight and of every stacked per-layer input (the KV caches), and
runs the GPipe schedule of M + S - 1 steps over M microbatches, sending
each microbatch's boundary activation to stage s + 1 with one
`batch_isend_irecv` a step (its send and its receive together, so that no
rank blocks its neighbour). The last stage's boundary output reaches every
rank by a broadcast (JAX: a masked psum); the prefix and the suffix run on
every rank. Per-layer outputs (presents) stay on their stage:
`stacked_call` returns the local rows, `__call__` gathers them under their
per-layer names. On the card a stage's kernels are the hand kernels its
nodes run in an Engine, and a world of one stage runs no send or receive.

Scope: transformer-style trunks whose blocks are structurally isomorphic;
blocks contain no control-flow subgraphs. `infer_boundaries` recognises
the repo's decoder families (gpt2/moe: blk{i}_res2, llama: l{i}_res2,
trunk input h0), then tries structural detection for foreign names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import resolve_device, signature
from . import collectives as C
from .mesh import axis_size

__all__ = ["PipelineError", "infer_boundaries", "infer_boundaries_structural",
           "split_stages", "StagePlan", "align_blocks", "AlignedBlocks",
           "PipelinedDecoder"]


class PipelineError(ValueError):
    """The graph cannot be pipelined as requested (non-isomorphic blocks,
    entangled cross-layer edges, control flow inside a block, bad
    divisibility)."""


# --------------------------------------------------------------------------
# Graph surgery
# --------------------------------------------------------------------------
_BOUNDARY_RE = re.compile(r"^(?:blk|l)(\d+)_res2$")


def infer_boundaries(graph) -> List[str]:
    """[trunk_in, layer0_out, ..., layerN-1_out]. Tries the repo's naming
    convention first (gpt2/llama/moe: blk{i}_res2 / l{i}_res2, trunk
    input h0), then falls back to STRUCTURAL detection — periodic
    isomorphic-block hashing along the node list — so external ONNX
    decoders with foreign tensor names pipeline without `boundaries=`."""
    try:
        return _infer_boundaries_named(graph)
    except PipelineError as named_err:
        try:
            return infer_boundaries_structural(graph)
        except PipelineError as struct_err:
            raise PipelineError(
                f"{named_err} Structural inference also failed: "
                f"{struct_err}") from None


def _infer_boundaries_named(graph) -> List[str]:
    produced = {o for n in graph.nodes for o in n.outputs if o}
    layers: Dict[int, str] = {}
    for name in produced:
        m = _BOUNDARY_RE.match(name)
        if m:
            layers[int(m.group(1))] = name
    if not layers or "h0" not in produced:
        raise PipelineError(
            "cannot infer pipeline boundaries: expected trunk input 'h0' and "
            "per-layer residuals 'blk{i}_res2'/'l{i}_res2'; pass boundaries=")
    idxs = sorted(layers)
    if idxs != list(range(len(idxs))):
        raise PipelineError(f"non-contiguous layer indices: {idxs}")
    return ["h0"] + [layers[i] for i in idxs]


def _node_sig(n) -> tuple:
    """Name-free structural signature — the same equivalence align_blocks
    enforces (op sequence + arity), so a structurally-proposed cut is
    exactly what the stacking machinery can consume."""
    return (n.op_type, n.domain, len(n.inputs), len(n.outputs))


def _periodic_window(sigs: List[tuple]) -> Tuple[int, int, int]:
    """Largest periodic run in the signature sequence: returns
    (start, period, span_end) for the run maximizing repeats*period
    (coverage), then repeats (so a 2-layer 'super-period' never shadows
    the true layer period). span_end is the exclusive end of the FULL
    periodic extent, which can exceed start + repeats*period by a
    partial block — phase shifts recover complete blocks from it.
    Raises if nothing repeats."""
    N = len(sigs)
    ids = {}
    S = np.fromiter((ids.setdefault(s, len(ids)) for s in sigs),
                    np.int64, N)
    best = None  # (coverage, repeats, -start)
    out = None
    for p in range(1, N // 2 + 1):
        eq = S[p:] == S[:-p]                       # eq[i]: S[i] == S[i+p]
        i = 0
        while i < eq.size:
            if not eq[i]:
                i += 1
                continue
            j = i
            while j < eq.size and eq[j]:
                j += 1
            run = j - i                            # S[i..i+run+p-1] periodic
            reps = run // p + 1
            if reps >= 2:
                cov = reps * p
                key = (cov, reps, -i)
                if best is None or key > best:
                    best, out = key, (i, p, i + run + p)  # full extent
            i = j
    if out is None:
        raise PipelineError("no repeated block structure found")
    return out


def _window_phases(start: int, p: int, span_end: int):
    """All phase shifts of a periodic window (the maximal run can begin
    mid-block, putting the residual add at the wrong edge): yields
    (start+d, p, reps_d) for every d that still holds >= 2 full periods
    inside the periodic extent [start, span_end), fullest-first."""
    phases = []
    for d in range(p):
        r = (span_end - (start + d)) // p
        if r >= 2:
            phases.append((r, start + d))
    phases.sort(key=lambda x: (-x[0], x[1]))
    for r, s in phases:
        yield s, p, r


def infer_boundaries_structural(graph) -> List[str]:
    """Detect the trunk by periodic isomorphic-block hashing: find the
    longest run of repeated node-signature blocks, then the positional
    tensor family crossing every consecutive block pair (the residual
    stream). Each candidate family is VALIDATED by split_stages +
    align_blocks — the proposal is only returned if the graph actually
    partitions and stacks along it."""
    nodes = graph.nodes
    w0, p, span_end = _periodic_window([_node_sig(n) for n in nodes])
    errors: List[str] = []
    for start, _, k in _window_phases(w0, p, span_end):
        blocks = [nodes[start + i * p: start + (i + 1) * p]
                  for i in range(k)]
        # positional families of tensors crossing consecutive blocks:
        # ((producer node offset, out slot), (consumer node offset, slot))
        fams = None
        for i in range(k - 1):
            produced = {o: (t, s) for t, n in enumerate(blocks[i])
                        for s, o in enumerate(n.outputs) if o}
            cur = set()
            for t, n in enumerate(blocks[i + 1]):
                for s, inp in enumerate(n.inputs):
                    if inp in produced:
                        cur.add((produced[inp], (t, s)))
            fams = cur if fams is None else fams & cur
        if not fams:
            errors.append(f"phase {start}: no tensor family crosses "
                          "every consecutive block pair")
            continue
        # residual stream enters its block early: low consumer offset 1st
        for (pt, ps), (ct, cs) in sorted(fams, key=lambda f: (f[1], f[0])):
            bnds = [blocks[0][ct].inputs[cs]] + [
                blocks[i][pt].outputs[ps] for i in range(k)]
            try:
                align_blocks(split_stages(graph, bnds))
                return bnds
            except PipelineError as e:
                errors.append(f"phase {start} cut {bnds[0]}->{bnds[1]}: "
                              f"{e}")
    raise PipelineError(
        "no periodic phase yields a valid stage partition: "
        + "; ".join(errors[:4]))


def _backward_slice(graph, targets: Sequence[str], stop: set) -> List:
    """Nodes (in original topo order) needed to compute `targets` from
    `stop` ∪ constants ∪ graph inputs."""
    from ..graph import node_deps

    producers = graph.producers()
    graph_inputs = set(graph.input_names)
    needed: set = set()
    frontier = list(targets)
    while frontier:
        name = frontier.pop()
        if name in stop or name in graph.constants or name in graph_inputs:
            continue
        n = producers.get(name)
        if n is None:
            raise PipelineError(f"no producer for '{name}'")
        if id(n) in needed:
            continue
        needed.add(id(n))
        frontier.extend(node_deps(n))
    return [n for n in graph.nodes if id(n) in needed]


def _subgraph(graph, nodes: List, inputs: List[str], outputs: List[str],
              name: str):
    """Build a Graph view over `nodes` with only the constants they use."""
    from ..graph import Graph, InputSpec, node_deps

    used: set = set()
    for n in nodes:
        used.update(node_deps(n))
    consts = {k: v for k, v in graph.constants.items() if k in used}
    return Graph(
        name=name,
        nodes=list(nodes),
        constants=consts,
        inputs=[InputSpec(i, ("?",), np.dtype(np.float32)) for i in inputs],
        outputs=list(outputs),
        opset=graph.opset,
        opsets=dict(graph.opsets),
        weight_names=[k for k in graph.weight_names if k in consts],
    )


@dataclasses.dataclass
class StagePlan:
    """Partition of a graph into prefix / layer blocks / suffix.

    prefix outputs [boundary_0] + `shared` (per-model tensors every layer
    reads, hoisted out of the trunk); block i maps boundary_i →
    boundary_{i+1} plus its `extra` per-layer outputs (e.g. presents);
    suffix maps boundary_N (+ prefix/shared tensors + graph inputs) to the
    remaining graph outputs."""

    prefix: object
    blocks: List[object]
    suffix: object
    boundaries: List[str]
    shared: List[str]                      # prefix-computed, read by blocks
    block_outputs: List[List[str]]         # extra outputs per block

    def __iter__(self):  # (prefix, blocks, suffix) unpacking convenience
        return iter((self.prefix, self.blocks, self.suffix))


def split_stages(graph, boundaries: Sequence[str]) -> StagePlan:
    """Cut `graph` at `boundaries`. Nodes reachable from more than one
    block's slice (masks computed from shared inputs) are hoisted into the
    prefix; graph outputs produced inside a block (KV presents) become
    that block's extra outputs. Every node lands in exactly one stage."""
    bnds = list(boundaries)
    if len(bnds) < 2:
        raise PipelineError("need at least [trunk_in, one layer boundary]")
    producers = graph.producers()

    # 1st pass: independent block slices; multiply-claimed nodes → shared
    raw = [_backward_slice(graph, [bnds[i + 1]], stop={bnds[i]})
           for i in range(len(bnds) - 1)]
    counts: Dict[int, int] = {}
    for sl in raw:
        for n in sl:
            counts[id(n)] = counts.get(id(n), 0) + 1
    shared_nodes = {i for i, c in counts.items() if c > 1}
    shared_tensors = {o for n in graph.nodes if id(n) in shared_nodes
                      for o in n.outputs if o}

    # 2nd pass with shared tensors as stops → exclusive per-layer nodes
    block_nodes = [
        _backward_slice(graph, [bnds[i + 1]], stop={bnds[i]} | shared_tensors)
        for i in range(len(bnds) - 1)
    ]
    owner: Dict[int, int] = {}
    for i, sl in enumerate(block_nodes):
        for n in sl:
            prev = owner.get(id(n))
            if prev is not None:
                raise PipelineError(
                    f"node '{n.outputs[0]}' is entangled between layers "
                    f"{prev} and {i} even after hoisting shared tensors — "
                    "boundaries do not partition the trunk")
            owner[id(n)] = i

    # prefix: trunk input + every shared tensor the blocks actually read
    from ..graph import node_deps

    shared_used = sorted({d for sl in block_nodes for n in sl
                          for d in node_deps(n) if d in shared_tensors})
    prefix_nodes = _backward_slice(graph, [bnds[0]] + shared_used,
                                   stop=set())
    for n in prefix_nodes:
        if id(n) in owner:
            raise PipelineError(
                f"prefix and block {owner[id(n)]} overlap at "
                f"'{n.outputs[0]}' — a shared tensor depends on a boundary")

    # outputs: claimed-tensor stops route each output to its producer
    # stage (-1 = prefix, -2 = suffix, >= 0 = block index)
    claimed = dict(owner)
    for n in prefix_nodes:
        claimed[id(n)] = -1
    claimed_tensors = {o for n in graph.nodes if id(n) in claimed
                       for o in n.outputs if o}
    block_extra: List[List[str]] = [[] for _ in block_nodes]
    suffix_targets: List[str] = []
    for o in graph.outputs:
        if o in claimed_tensors:  # produced by an already-assigned node
            seg = claimed[id(producers[o])]
            if seg == -1:
                raise PipelineError(
                    f"output '{o}' is produced by the prefix — not supported")
            (suffix_targets if seg == -2 else block_extra[seg]).append(o)
            continue
        sl = _backward_slice(graph, [o], stop=claimed_tensors)
        segs = {claimed[id(producers[d])]
                for n in sl for d in node_deps(n)
                if d in claimed_tensors and d != bnds[-1]}
        block_deps = {x for x in segs if x >= 0}
        if len(block_deps) > 1:
            raise PipelineError(
                f"output '{o}' depends on several layers: "
                f"{sorted(block_deps)}")
        seg = block_deps.pop() if block_deps else -2
        if seg >= 0 and -2 in segs:
            raise PipelineError(
                f"output '{o}' mixes layer and suffix dataflow")
        for n in sl:
            claimed[id(n)] = seg
            claimed_tensors.update(x for x in n.outputs if x)
            if seg >= 0:
                owner[id(n)] = seg
        if seg >= 0:
            block_nodes[seg] = [n for n in graph.nodes
                                if owner.get(id(n)) == seg]
            block_extra[seg].append(o)
        else:
            suffix_targets.append(o)
    suffix_nodes = [n for n in graph.nodes if claimed.get(id(n)) == -2]

    # completeness: every node in exactly one stage
    total = len(prefix_nodes) + len(suffix_nodes) + sum(
        len(b) for b in block_nodes)
    if total != len(graph.nodes):
        missing = [n.outputs[0] for n in graph.nodes
                   if id(n) not in claimed]
        raise PipelineError(f"nodes outside every stage: {missing[:5]}")

    prefix = _subgraph(graph, prefix_nodes, graph.input_names,
                       [bnds[0]] + shared_used, f"{graph.name}:prefix")
    blocks = [
        _subgraph(graph, block_nodes[i], [bnds[i]] + shared_used,
                  [bnds[i + 1]] + block_extra[i], f"{graph.name}:blk{i}")
        for i in range(len(block_nodes))
    ]
    suffix = _subgraph(graph, suffix_nodes,
                       [bnds[-1]] + shared_used + graph.input_names,
                       suffix_targets, f"{graph.name}:suffix")
    return StagePlan(prefix, blocks, suffix, bnds, shared_used, block_extra)


@dataclasses.dataclass
class AlignedBlocks:
    """Isomorphism proof + canonicalisation of a StagePlan's blocks."""

    canonical: object                       # block 0's graph, layer consts removed
    stacked: Dict[str, np.ndarray]          # canon const name → [n_layers, ...]
    layer_inputs: Dict[str, List[str]]      # canon input name → per-layer names
    shared_inputs: List[str]                # names read identically by all blocks
    extra_outputs: Dict[str, List[str]]     # canon output name → per-layer names


def align_blocks(plan: StagePlan) -> AlignedBlocks:
    """Verify the blocks are isomorphic; classify their non-boundary inputs
    as stacked constants (per-layer weights), stacked layer inputs
    (per-layer graph inputs, e.g. KV caches), or shared inputs; map their
    extra outputs positionally."""
    blocks = plan.blocks
    b0 = blocks[0]
    sig0 = [(n.op_type, n.domain, len(n.inputs)) for n in b0.nodes]
    for g in blocks[1:]:
        sig = [(n.op_type, n.domain, len(n.inputs)) for n in g.nodes]
        if sig != sig0:
            raise PipelineError(
                f"blocks are not isomorphic: {b0.name} vs {g.name} differ in "
                "op sequence — cannot stack stage weights")
    for g in blocks:
        for n in g.nodes:
            if "__captures__" in n.attrs or any(
                    hasattr(v, "nodes") for v in n.attrs.values()):
                raise PipelineError(
                    f"control-flow subgraph inside block ({n.op_type}) — "
                    "pipelining does not support nested graphs")

    n_layers = len(blocks)
    interior = [{o for n in g.nodes for o in n.outputs if o} for g in blocks]
    const_corr: Dict[str, List[str]] = {}
    layer_inputs: Dict[str, List[str]] = {}
    shared_inputs: List[str] = []
    seen_shared: set = set()

    for t, n0 in enumerate(b0.nodes):
        for slot, i0 in enumerate(n0.inputs):
            if not i0:
                continue
            names = [blocks[j].nodes[t].inputs[slot] for j in range(n_layers)]
            kinds = set()
            for j, nm in enumerate(names):
                if nm in blocks[j].constants:
                    kinds.add("const")
                elif nm in interior[j]:
                    kinds.add("interior")
                elif nm == plan.boundaries[j]:
                    kinds.add("boundary")
                else:
                    kinds.add("input")
            if len(kinds) != 1:
                raise PipelineError(
                    f"input slot {slot} of node {t} has mixed roles across "
                    f"layers: {sorted(kinds)}")
            kind = kinds.pop()
            if kind in ("interior", "boundary"):
                continue
            if kind == "const":
                prev = const_corr.get(i0)
                if prev is not None and prev != names:
                    raise PipelineError(
                        f"constant '{i0}' corresponds inconsistently")
                const_corr[i0] = names
                continue
            # graph-input slot: identical everywhere → shared; all-distinct
            # per-layer names → stacked layer input
            if len(set(names)) == 1:
                if i0 not in seen_shared:
                    seen_shared.add(i0)
                    shared_inputs.append(i0)
            elif len(set(names)) == n_layers:
                prev = layer_inputs.get(i0)
                if prev is not None and prev != names:
                    raise PipelineError(
                        f"layer input '{i0}' corresponds inconsistently")
                layer_inputs[i0] = names
            else:
                raise PipelineError(
                    f"input slot {slot} of node {t} is neither shared nor "
                    f"per-layer: {names}")

    # extra outputs correspond positionally (same (node, slot) per layer)
    extra_outputs: Dict[str, List[str]] = {}
    out_pos0 = {}
    for t, n0 in enumerate(b0.nodes):
        for slot, o0 in enumerate(n0.outputs):
            if o0 and o0 in plan.block_outputs[0]:
                out_pos0[o0] = (t, slot)
    if len(out_pos0) != len(plan.block_outputs[0]):
        raise PipelineError("block 0 extra outputs not all node outputs")
    for o0, (t, slot) in out_pos0.items():
        names = [blocks[j].nodes[t].outputs[slot] for j in range(n_layers)]
        for j, nm in enumerate(names):
            if nm not in plan.block_outputs[j]:
                raise PipelineError(
                    f"output slot {slot} of node {t} is a graph output in "
                    f"block 0 ({o0}) but not in block {j} ({nm})")
        extra_outputs[o0] = names

    stacked: Dict[str, np.ndarray] = {}
    shared_consts: Dict[str, np.ndarray] = {}
    for i0, names in const_corr.items():
        vals = [np.asarray(blocks[j].constants[names[j]])
                for j in range(n_layers)]
        ref = vals[0]
        for v in vals[1:]:
            if v.shape != ref.shape or v.dtype != ref.dtype:
                raise PipelineError(
                    f"constant '{i0}' varies in shape/dtype across layers: "
                    f"{ref.shape}/{ref.dtype} vs {v.shape}/{v.dtype}")
        if all(np.array_equal(ref, v) for v in vals[1:]):
            shared_consts[i0] = ref
        else:
            stacked[i0] = np.stack(vals)

    from ..graph import Graph

    canonical = Graph(
        name=b0.name + ":canon",
        nodes=b0.nodes,
        constants=shared_consts,  # stacked ones arrive via the params dict
        inputs=list(b0.inputs),
        outputs=list(b0.outputs),
        opset=b0.opset,
        opsets=dict(b0.opsets),
        weight_names=[],
    )
    return AlignedBlocks(canonical, stacked, layer_inputs, shared_inputs,
                         extra_outputs)




# --------------------------------------------------------------------------
# Pipelined executor
# --------------------------------------------------------------------------
def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


class _Part:
    """One lowered graph (prefix, a layer block or suffix) with its device
    constants, run eagerly with the static values of each input signature
    kept (so that a run may be captured into a CUDA graph)."""

    def __init__(self, graph, device):
        from ..engine import lower_packed

        self.graph = graph
        self.fn = lower_packed(graph, device)
        self.statics: Dict[tuple, dict] = {}

    def __call__(self, params, packed, feed) -> Dict[str, torch.Tensor]:
        st = self.statics.setdefault(signature(feed), {})
        return self.fn(params, packed, feed, st)


class PipelinedDecoder:
    """Run a decoder forward (or decode step) with its trunk pipelined over
    the mesh dim `axis`, one process a stage. Output matches the
    unpipelined Engine to fp32 reduction-order noise (the same nodes run
    on the same values, one microbatch at a time).

    Parameters
    ----------
    graph: imported Graph (e.g. import_model(build_gpt2_decode(...))).
    mesh: DeviceMesh with a dim named `axis`; other dims replicate.
    boundaries: residual tensor names; inferred for the repo's families.
    microbatches: GPipe M (default: the stage count). batch % M == 0.
    batch_inputs: names of graph inputs whose dim 0 is the batch (the
        microbatch-sliced set). Default: inputs with a symbolic dim 0; if
        the graph declares none, a shape heuristic (dim == B). Which
        prefix-computed shared tensors carry the batch is found by running
        the prefix on the CPU's plain versions at B and 2B.
    dtype: "float32" or "bfloat16", the Engine's policy (float weights
        held in it, float inputs cast in, float outputs cast back).
    device: where this rank runs ("cuda" unless told "cpu").

    Call styles
    -----------
    __call__(inputs): Engine-like dict in and out (per-layer inputs under
        their ONNX names; each rank stacks its own layers' rows).
    stacked_call(inputs, stacked_ins): per-layer inputs pre-stacked as this
        stage's rows [lps, ...] under canonical (layer-0) names; returns
        (suffix outputs, this stage's rows of the extra outputs) -- the
        device-resident KV path for generation loops.
    """

    def __init__(self, graph, mesh, *, axis: str = "pipe",
                 boundaries: Optional[Sequence[str]] = None,
                 microbatches: Optional[int] = None,
                 batch_inputs: Optional[Sequence[str]] = None,
                 dtype: str = "float32", device="cuda"):
        from ..engine import _policy_dtype
        from ..weights import params_from_numpy, prepack_int8_weights

        self.device = resolve_device(device)
        if mesh.device_type != self.device.type:
            raise PipelineError(f"a {mesh.device_type} mesh for a pipeline "
                                f"on {self.device}")
        self._cast = _policy_dtype(dtype)
        if axis not in mesh.mesh_dim_names:
            raise PipelineError(
                f"mesh has no '{axis}' axis: {mesh.mesh_dim_names}")
        S = axis_size(mesh, axis)
        bnds = list(boundaries) if boundaries is not None \
            else infer_boundaries(graph)
        plan = split_stages(graph, bnds)
        n_layers = len(plan.blocks)
        if n_layers % S:
            raise PipelineError(
                f"{n_layers} layers do not divide over {S} pipeline stages")
        lps = n_layers // S
        al = align_blocks(plan)

        self.graph, self.mesh, self.axis = graph, mesh, axis
        self.n_stages, self.n_layers = S, n_layers
        self.layers_per_stage = lps
        self.microbatches = microbatches or S
        self.plan, self.aligned = plan, al
        self._b_in, self._b_out = bnds[0], bnds[-1]

        specs = {sp.name: sp for sp in graph.inputs}
        if batch_inputs is None and any(
                isinstance(d, str) for sp in graph.inputs for d in sp.shape):
            batch_inputs = [sp.name for sp in graph.inputs
                            if sp.shape and isinstance(sp.shape[0], str)]
        self._static_mb = None
        if batch_inputs is not None:
            unknown = set(batch_inputs) - set(specs)
            if unknown:
                raise PipelineError(
                    f"batch_inputs not graph inputs: {sorted(unknown)}")
            is_batch = {n: n in set(batch_inputs) for n in specs}
            prefix_batch = self._probe_prefix(plan.prefix, specs, is_batch)
            self._static_mb = (
                {canon: is_batch[canon] for canon in al.layer_inputs},
                {k: (prefix_batch[k] if k in prefix_batch else is_batch[k])
                 for k in al.shared_inputs})

        # every PipelineError is raised above, before the process group
        self.stage = s = mesh.get_local_rank(axis)
        self.stage_rows = (s * lps, (s + 1) * lps)
        self._group = mesh.get_group(axis)
        C.register_mesh(mesh)
        self._key = C.group_key(mesh, axis)
        self._peer = {k: dist.get_global_rank(self._group, k)
                      for k in range(S)}
        cast = self._cast
        rows = slice(s * lps, (s + 1) * lps)
        self.params = {
            "prefix": params_from_numpy(
                {k: plan.prefix.constants[k] for k in plan.prefix.weight_names},
                self.device, float32_as=cast),
            # this stage's rows of every stacked per-layer constant
            "layers": params_from_numpy(
                {k: np.ascontiguousarray(v[rows])
                 for k, v in al.stacked.items()},
                self.device, float32_as=cast),
            "suffix": params_from_numpy(
                {k: plan.suffix.constants[k] for k in plan.suffix.weight_names},
                self.device, float32_as=cast),
        }
        self._prefix = _Part(plan.prefix, self.device)
        self._block = _Part(al.canonical, self.device)
        self._suffix = _Part(plan.suffix, self.device)
        self._packed = {
            "prefix": prepack_int8_weights(plan.prefix,
                                           self.params["prefix"]),
            "suffix": prepack_int8_weights(plan.suffix,
                                           self.params["suffix"])}
        self._layer_params = [
            {k: v[j] for k, v in self.params["layers"].items()}
            for j in range(lps)]
        self._layer_packed = [prepack_int8_weights(al.canonical, p)
                              for p in self._layer_params]
        self._stream = None
        self._pool = None
        self._graphs: Dict[tuple, tuple] = {}  # signature -> its graph

    # -- the batch probe -------------------------------------------------
    @staticmethod
    def _probe_prefix(prefix, specs, is_batch) -> Dict[str, bool]:
        """Which prefix outputs carry the batch: the prefix run on the CPU
        (the kernels' plain versions) at B and 2B, outputs compared."""
        from ..engine import lower
        from ..weights import params_from_numpy

        fn = lower(prefix, "cpu")
        params = params_from_numpy(
            {k: prefix.constants[k] for k in prefix.weight_names}, "cpu")

        def feed(mult):
            out = {}
            for n, sp in specs.items():
                shape = list(sp.concrete_shape(2))
                if is_batch[n] and shape:
                    shape[0] *= mult
                out[n] = torch.zeros(shape, dtype=_torch_dtype(sp.dtype))
            return out

        with torch.no_grad():
            base, dbl = fn(params, feed(1)), fn(params, feed(2))
        return {k: tuple(base[k].shape) != tuple(dbl[k].shape)
                for k in base}

    # -- what a capture needs (engine.run_captured) ------------------------
    def side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    # -- the schedule -------------------------------------------------------
    def _policy_in(self, d: Dict[str, torch.Tensor]):
        c = self._cast
        return {k: (v.to(c) if v.dtype == torch.float32 else v)
                for k, v in d.items()}

    def _policy_out(self, d: Dict[str, torch.Tensor]):
        c = self._cast
        if c == torch.float32:
            return d
        return {k: (v.to(torch.float32) if v.dtype == c else v)
                for k, v in d.items()}

    def _forward(self, inputs, stacked_ins):
        S, s, M = self.n_stages, self.stage, self.microbatches
        al, lps = self.aligned, self.layers_per_stage
        pre = self._prefix(self.params["prefix"], self._packed["prefix"],
                           inputs)
        h = pre[self._b_in]
        B = h.shape[0]
        if B % M:
            raise PipelineError(f"batch {B} % microbatches {M} != 0")
        mb = B // M
        prefix_outs = {self._b_in, *self.plan.shared}
        shared = {k: (pre[k] if k in prefix_outs else inputs[k])
                  for k in al.shared_inputs}
        if self._static_mb is not None:
            mb_ins = {k: self._static_mb[0][k] for k in stacked_ins}
            mb_shared = {k: self._static_mb[1][k] for k in shared}
        else:
            mb_ins = {k: v.dim() >= 2 and v.shape[1] == B
                      for k, v in stacked_ins.items()}
            mb_shared = {k: v.dim() >= 1 and v.shape[0] == B
                         for k, v in shared.items()}
        blk_in, blk_out = self.plan.boundaries[0], al.canonical.outputs[0]
        extra_names = list(al.extra_outputs)
        micro_shape = (mb,) + tuple(h.shape[1:])
        outs_h: List[torch.Tensor] = []
        extras = {k: [[None] * M for _ in range(lps)] for k in extra_names}
        recv = None
        for t in range(M + S - 1):
            m = t - s
            ops = []
            if 0 <= m < M:
                hh = h[m * mb:(m + 1) * mb] if s == 0 else recv
                rows = slice(m * mb, (m + 1) * mb)
                fshared = {k: (v[rows] if mb_shared[k] else v)
                           for k, v in shared.items()}
                for j in range(lps):
                    feed = {blk_in: hh, **fshared}
                    for k, v in stacked_ins.items():
                        feed[k] = v[j][rows] if mb_ins[k] else v[j]
                    out = self._block(self._layer_params[j],
                                      self._layer_packed[j], feed)
                    hh = out[blk_out]
                    for k in extra_names:
                        extras[k][j][m] = out[k]
                if tuple(hh.shape) != micro_shape or hh.dtype != h.dtype:
                    raise PipelineError(
                        f"boundary {blk_out} {tuple(hh.shape)} {hh.dtype} "
                        f"differs from {blk_in} {micro_shape} {h.dtype}")
                if s == S - 1:
                    outs_h.append(hh)
                else:
                    ops.append(dist.P2POp(dist.isend, hh.contiguous(),
                                          self._peer[s + 1], self._group))
            if s > 0 and 0 <= t + 1 - s < M:
                recv = torch.empty(micro_shape, dtype=h.dtype,
                                   device=h.device)
                ops.append(dist.P2POp(dist.irecv, recv, self._peer[s - 1],
                                      self._group))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        h_full = torch.cat(outs_h) if s == S - 1 else torch.empty_like(h)
        dist.broadcast(h_full, src=self._peer[S - 1], group=self._group)
        out = self._suffix(self.params["suffix"], self._packed["suffix"],
                           {self._b_out: h_full, **shared, **inputs})
        local = {k: torch.stack([torch.cat(extras[k][j])
                                 for j in range(lps)])
                 for k in extra_names}
        return out, local

    # -- call styles ----------------------------------------------------
    def stacked_call(self, inputs: Dict[str, torch.Tensor],
                     stacked_ins: Optional[Dict[str, torch.Tensor]] = None,
                     eager: bool = False,
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
        """inputs: prefix/shared graph inputs; stacked_ins: this stage's
        rows [lps, ...] of each per-layer input, under canonical names.
        Returns (suffix outputs, this stage's rows of the extra outputs).
        On the card, as `Engine.__call__` does, the first call of an input
        signature runs eagerly and captures the schedule (its
        collectives included) into one CUDA graph, and later calls copy
        the inputs in and replay it; `eager` (a caller that captures
        several calls in one graph, a K-step block) runs it eagerly."""
        from ..runtime import captures
        from ..weights import as_device_tensor

        stacked_ins = dict(stacked_ins or {})
        missing = set(self.aligned.layer_inputs) - set(stacked_ins)
        if missing:
            raise PipelineError(f"missing stacked layer inputs: {missing}")
        lps = self.layers_per_stage
        for k, v in stacked_ins.items():
            if v.shape[0] != lps:
                raise PipelineError(
                    f"stacked input {k}: {v.shape[0]} rows, this stage "
                    f"holds {lps} layers")
        inputs = {k: as_device_tensor(v, self.device)
                  for k, v in inputs.items()}
        stacked_ins = {k: as_device_tensor(v, self.device)
                       for k, v in stacked_ins.items()}
        with torch.no_grad():
            if eager or not captures(self.device):
                return self._run(inputs, stacked_ins)
            return self._replayed(inputs, stacked_ins)

    def _run(self, inputs, stacked_ins):
        out, extras = self._forward(self._policy_in(inputs),
                                    self._policy_in(stacked_ins))
        return self._policy_out(out), self._policy_out(extras)

    def _replayed(self, inputs, stacked_ins):
        """The captured schedule of this signature: captured on its first
        call (whose eager run is the result), replayed after."""
        from ..runtime import capture, side_stream

        feed = {**inputs, **{f"stacked:{k}": v
                             for k, v in stacked_ins.items()}}
        key = signature(feed)
        cap = self._graphs.get(key)
        if cap is None:
            with side_stream(self.side_stream()) as s:
                result = self._run(inputs, stacked_ins)
                static = {k: v.clone() for k, v in feed.items()}
                st_in = {k: static[k] for k in inputs}
                st_stacked = {k: static[f"stacked:{k}"] for k in stacked_ins}
                outs, replay = capture(lambda: self._run(st_in, st_stacked),
                                       stream=s, pool=self.graph_pool())
            self._graphs[key] = (static, outs, replay)
            return result
        static, outs, replay = cap
        for k, v in feed.items():
            static[k].copy_(v)
        replay()
        return tuple({k: v.clone() for k, v in d.items()} for d in outs)

    def __call__(self, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        from ..weights import as_device_tensor

        inputs = dict(inputs)
        lo, hi = self.stage_rows
        stacked_ins = {}
        for canon, names in self.aligned.layer_inputs.items():
            vals = [inputs.pop(n) for n in names]
            stacked_ins[canon] = torch.stack(
                [as_device_tensor(v, self.device) for v in vals[lo:hi]])
        out, extras = self.stacked_call(inputs, stacked_ins)
        named = dict(out)
        for canon, names in self.aligned.extra_outputs.items():
            arr = C.all_gather(extras[canon], 0, self._key)
            for i, n in enumerate(names):
                named[n] = arr[i]
        return named
