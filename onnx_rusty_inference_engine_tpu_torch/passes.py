"""Graph optimization passes (beyond the import-time canonicalization in
graph.py): the port's copy of onnx_rusty_inference_engine_tpu/passes.py.

These run before quantization/lowering:

- fuse_conv_bias_add: Conv followed by Add of a constant per-channel bias
  becomes Conv-with-bias (the CNTK MNIST export uses separate Add nodes with
  [C,1,1] initializers — reference handles this as its "mode 1" add,
  add_op.rs:75). Numerically identical; lets the quantizer treat conv+bias
  as one int8 op instead of leaving an fp32 island between QLinearConvs.
- fold_batchnorm: inference-mode BatchNormalization after a Conv folds into
  the conv weights/bias (w' = w·k, b' = (b−mean)·k + beta, k = γ/√(var+ε)).
  Turns ResNet's Conv→BN→Relu backbone into Conv→Relu so the whole spine
  stays in the int8 domain after quantization.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .graph import Graph, Node, node_deps, prune_dead

__all__ = ["fuse_conv_bias_add", "fold_batchnorm",
           "fuse_layernorm", "fuse_gelu_erf",
           "eliminate_common_subexpressions", "optimize"]


def _consumer_count(g: Graph) -> Dict[str, int]:
    """Readers of each tensor: node inputs, graph outputs, and the
    If/Loop/Scan nodes whose subgraphs read it from the outer scope (their
    `__captures__`, graph._subgraph_captures). Without the captures a
    fusion would take a tensor only a subgraph also reads for a private
    intermediate and rename it away (the JAX package's passes.py:30-37
    counts node inputs only)."""
    counts: Dict[str, int] = {}
    for n in g.nodes:
        for i in node_deps(n):
            counts[i] = counts.get(i, 0) + 1
    for o in g.outputs:
        counts[o] = counts.get(o, 0) + 1
    return counts


def fuse_conv_bias_add(g: Graph) -> int:
    """Returns number of fusions performed (mutates g)."""
    producers = {o: idx for idx, n in enumerate(g.nodes) for o in n.outputs}
    counts = _consumer_count(g)
    fused = 0
    new_nodes: List[Node] = []
    skip: set = set()
    for idx, n in enumerate(g.nodes):
        if idx in skip:
            continue
        if n.op_type == "Add":
            a, b = n.inputs[0], n.inputs[1]
            conv_idx = producers.get(a)
            bias = g.constants.get(b)
            if (conv_idx is not None and bias is not None
                    and g.nodes[conv_idx].op_type == "Conv"
                    and counts.get(a, 0) == 1
                    and conv_idx < idx):
                conv = g.nodes[conv_idx]
                out_c = None
                w = g.constants.get(conv.inputs[1])
                if w is not None:
                    out_c = w.shape[0]
                flat = bias.reshape(-1)
                # bias must be exactly one value per output channel
                if out_c is not None and flat.size == out_c and \
                        bias.size == flat.size:
                    if len(conv.inputs) > 2 and conv.inputs[2]:
                        old = g.constants[conv.inputs[2]]
                        flat = flat + old.reshape(-1)
                    bias_name = f"{conv.outputs[0]}__fused_b"
                    g.constants[bias_name] = flat.astype(np.float32)
                    g.weight_names.append(bias_name)
                    conv.inputs = [conv.inputs[0], conv.inputs[1], bias_name]
                    conv.outputs = [n.outputs[0]]  # take over Add's output name
                    fused += 1
                    continue  # drop the Add node
        new_nodes.append(n)
    if fused:
        g.nodes = new_nodes
        prune_dead(g)
    return fused


def fold_batchnorm(g: Graph) -> int:
    """Returns number of BN nodes folded (mutates g)."""
    producers = {o: idx for idx, n in enumerate(g.nodes) for o in n.outputs}
    counts = _consumer_count(g)
    folded = 0
    new_nodes: List[Node] = []
    for idx, n in enumerate(g.nodes):
        if n.op_type == "BatchNormalization":
            x = n.inputs[0]
            conv_idx = producers.get(x)
            params = [g.constants.get(i) for i in n.inputs[1:5]]
            if (conv_idx is not None and g.nodes[conv_idx].op_type == "Conv"
                    and counts.get(x, 0) == 1
                    and all(p is not None for p in params)):
                conv = g.nodes[conv_idx]
                w = g.constants.get(conv.inputs[1])
                group = int(conv.attr("group", 1))
                if w is not None and group == 1:
                    gamma, beta, mean, var = [p.astype(np.float64)
                                              for p in params]
                    eps = float(n.attr("epsilon", 1e-5))
                    k = gamma / np.sqrt(var + eps)  # [C_out]
                    w_new = (w.astype(np.float64)
                             * k.reshape(-1, *([1] * (w.ndim - 1))))
                    if len(conv.inputs) > 2 and conv.inputs[2]:
                        b_old = g.constants[conv.inputs[2]].astype(np.float64)
                    else:
                        b_old = np.zeros(w.shape[0])
                    b_new = (b_old - mean) * k + beta

                    w_name = f"{conv.inputs[1]}__bnfold"
                    b_name = f"{conv.outputs[0]}__bnfold_b"
                    g.constants[w_name] = w_new.astype(np.float32)
                    g.constants[b_name] = b_new.astype(np.float32)
                    g.weight_names += [w_name, b_name]
                    conv.inputs = [conv.inputs[0], w_name, b_name]
                    conv.outputs = [n.outputs[0]]  # take over BN's output name
                    folded += 1
                    continue  # drop the BN node
        new_nodes.append(n)
    if folded:
        g.nodes = new_nodes
        prune_dead(g)
    return folded


def optimize(g: Graph) -> Graph:
    """Run all fusions to fixpoint (mutates and returns g)."""
    for _ in range(3):
        changed = (fuse_conv_bias_add(g) + fold_batchnorm(g)
                   + fuse_layernorm(g) + fuse_gelu_erf(g)
                   + eliminate_common_subexpressions(g))
        if not changed:
            break
    return g


# ops whose outputs differ across calls even with identical inputs — never
# merged (Dropout is identity at inference but kept out for its mask/seed)
_NONDETERMINISTIC = {
    "RandomNormal", "RandomUniform", "RandomNormalLike",
    "RandomUniformLike", "Multinomial", "Bernoulli", "Dropout",
}


def _attr_key(v):
    """Canonical hashable form of one attribute value (None = unhashable:
    the node is skipped). Tensor attrs hash by content."""
    import hashlib

    if isinstance(v, (int, float, str, bytes, bool)):
        return v
    if isinstance(v, np.ndarray):
        return ("nd", v.shape, v.dtype.str,
                hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        parts = tuple(_attr_key(x) for x in v)
        return None if any(p is None for p in parts) else ("seq", parts)
    return None  # subgraphs and anything exotic: don't CSE


def eliminate_common_subexpressions(g: Graph) -> int:
    """Merge nodes that compute the same value: identical (op_type, domain,
    attrs, inputs) after upstream merges. Real exporter output repeats
    whole Shape/Slice/position-encoding chains per layer; one pass over the
    topo-sorted node list collapses each chain to its first occurrence.

    Never touches: nondeterministic ops, control-flow ops (their subgraph
    bodies reference outer names via capture edges — renaming those would
    need a body rewrite), nodes whose outputs are graph outputs (output
    names are the API), and tensors captured by any subgraph.

    The reference has no graph optimizer at all (nodes run as parsed,
    reference: src/model_inference.rs:29-120). Returns #eliminated."""
    # names a subgraph body closes over — renaming them would break the
    # body's internal references, so their defining nodes never merge away
    captured = set()
    for n in g.nodes:
        captured.update(n.attrs.get("__captures__", ()))
    outputs = set(g.outputs)

    seen: Dict[tuple, Node] = {}
    rename: Dict[str, str] = {}
    kept: List[Node] = []
    eliminated = 0
    for n in g.nodes:
        n.inputs = [rename.get(i, i) for i in n.inputs]
        if (n.op_type in _NONDETERMINISTIC
                or n.op_type in ("If", "Loop", "Scan")
                or any(o in outputs or o in captured for o in n.outputs)):
            kept.append(n)
            continue
        attr_parts = []
        hashable = True
        for k in sorted(n.attrs):
            ak = _attr_key(n.attrs[k])
            if ak is None:
                hashable = False
                break
            attr_parts.append((k, ak))
        if not hashable:
            kept.append(n)
            continue
        # key the outputs' EMPTINESS MASK, not just the count: two
        # otherwise-identical nodes may use different optional-output
        # slots (MaxPool Indices, LSTM Y_h/Y_c) — merging a node whose
        # live output sits where the representative has "" would rename
        # a live tensor to the empty string and rewire its consumers to
        # an omitted input.
        key = (n.op_type, n.domain, tuple(n.inputs), tuple(attr_parts),
               tuple(bool(o) for o in n.outputs))
        rep = seen.get(key)
        if rep is None:
            seen[key] = n
            kept.append(n)
        else:
            for old, new in zip(n.outputs, rep.outputs):
                if old and new:
                    rename[old] = new
            eliminated += 1
    if eliminated:
        g.nodes = kept
        prune_dead(g)
    return eliminated


def _const_scalar(g: Graph, name: str) -> Optional[float]:
    c = g.constants.get(name)
    if c is not None and np.asarray(c).size == 1:
        return float(np.asarray(c).reshape(()))
    return None


def _reduce_axes_of(g: Graph, n: Node) -> Optional[List[int]]:
    axes = n.attr("axes")
    if axes is None and len(n.inputs) > 1 and n.inputs[1]:
        c = g.constants.get(n.inputs[1])
        if c is None:
            return None
        axes = np.asarray(c).reshape(-1).tolist()
    return None if axes is None else [int(a) for a in axes]


def fuse_layernorm(g: Graph) -> int:
    """Rewrite the decomposed LayerNorm chain torch emits at opset <= 16
    (ReduceMean -> Sub -> Pow/ReduceMean -> Add eps -> Sqrt -> Div
    [-> Mul gamma -> Add beta]) into one LayerNormalization node.

    The win is semantic: the graph matches what opset-17 exporters
    produce, the quantizer treats LN as a single boundary, and a probe
    shows one node, not seven.
    Only last-axis normalization (axes == [-1], keepdims=1) is matched —
    exactly the torch.nn.LayerNorm export shape."""
    prod = {o: n for n in g.nodes for o in n.outputs}
    counts = _consumer_count(g)
    fused = 0
    replaced: Dict[int, Node] = {}   # node-list index -> replacement
    consumed: set = set()

    def single(name: str) -> bool:
        return counts.get(name, 0) == 1

    for idx, n in enumerate(g.nodes):
        if n.op_type != "Div" or idx in consumed:
            continue
        sub = prod.get(n.inputs[0])
        sqrt = prod.get(n.inputs[1])
        if (sub is None or sub.op_type != "Sub"
                or sqrt is None or sqrt.op_type != "Sqrt"):
            continue
        x = sub.inputs[0]
        mu = prod.get(sub.inputs[1])
        if (mu is None or mu.op_type != "ReduceMean"
                or mu.inputs[0] != x
                or _reduce_axes_of(g, mu) != [-1]
                or int(mu.attr("keepdims", 1)) != 1):
            continue
        addeps = prod.get(sqrt.inputs[0])
        if addeps is None or addeps.op_type != "Add":
            continue
        var = prod.get(addeps.inputs[0])
        eps = _const_scalar(g, addeps.inputs[1])
        if var is None or var.op_type != "ReduceMean":
            var, eps = prod.get(addeps.inputs[1]), _const_scalar(
                g, addeps.inputs[0])
        if (var is None or var.op_type != "ReduceMean" or eps is None
                or _reduce_axes_of(g, var) != [-1]
                or int(var.attr("keepdims", 1)) != 1):
            continue
        pw = prod.get(var.inputs[0])
        if (pw is None or pw.op_type != "Pow"
                or pw.inputs[0] != sub.outputs[0]
                or _const_scalar(g, pw.inputs[1]) != 2.0):
            continue
        # interior values must have no other consumers (Sub's output feeds
        # both Div and Pow -> count 2)
        if not (single(mu.outputs[0]) and counts.get(sub.outputs[0], 0) == 2
                and single(pw.outputs[0]) and single(var.outputs[0])
                and single(addeps.outputs[0]) and single(sqrt.outputs[0])):
            continue

        # optional affine tail: Mul by const gamma, then Add const beta
        final = n
        gamma_name = beta_name = None
        y = n.outputs[0]
        nxt = [m for m in g.nodes if y in m.inputs]
        if len(nxt) == 1 and nxt[0].op_type == "Mul" and single(y):
            mul = nxt[0]
            gname = mul.inputs[1] if mul.inputs[0] == y else mul.inputs[0]
            gc = g.constants.get(gname)
            if gc is not None and gc.ndim == 1:  # torch gamma is [D]
                gamma_name = gname
                final = mul
                y2 = mul.outputs[0]
                nxt2 = [m for m in g.nodes if y2 in m.inputs]
                if len(nxt2) == 1 and nxt2[0].op_type == "Add" and \
                        single(y2):
                    add2 = nxt2[0]
                    bname = (add2.inputs[1] if add2.inputs[0] == y2
                             else add2.inputs[0])
                    bc = g.constants.get(bname)
                    if bc is not None and bc.ndim == 1:
                        beta_name = bname
                        final = add2
        if gamma_name is None:
            # LayerNormalization requires a scale input and the feature
            # size isn't statically known here — skip scale-less forms
            # (torch.nn.LayerNorm always exports the affine pair)
            continue
        g.constants[gamma_name] = np.asarray(
            g.constants[gamma_name]).reshape(-1).astype(np.float32)
        if beta_name is not None:
            g.constants[beta_name] = np.asarray(
                g.constants[beta_name]).reshape(-1).astype(np.float32)
        ln_inputs = [x, gamma_name] + (
            [beta_name] if beta_name is not None else [])
        fidx = g.nodes.index(final)
        replaced[fidx] = Node(
            "LayerNormalization", ln_inputs, list(final.outputs),
            final.name or f"{final.outputs[0]}_ln",
            {"axis": -1, "epsilon": float(eps)})
        consumed.add(idx)
        fused += 1

    if fused:
        g.nodes = [replaced.get(i, n) for i, n in enumerate(g.nodes)]
        prune_dead(g)
    return fused


def fuse_gelu_erf(g: Graph) -> int:
    """Rewrite the exact-GELU chain every torch opset emits
    (Div by sqrt(2) -> Erf -> Add 1 -> Mul x -> Mul 0.5, with the two
    Muls in either order) into one Gelu(approximate=none) node."""
    prod = {o: n for n in g.nodes for o in n.outputs}
    counts = _consumer_count(g)
    fused = 0
    replaced: Dict[int, Node] = {}

    def single(name: str) -> bool:
        return counts.get(name, 0) == 1

    for n in g.nodes:
        if n.op_type != "Erf":
            continue
        div = prod.get(n.inputs[0])
        if div is None or div.op_type != "Div":
            continue
        c = _const_scalar(g, div.inputs[1])
        if c is None or abs(c - np.sqrt(2.0)) > 1e-3:
            continue
        x = div.inputs[0]
        adds = [m for m in g.nodes if n.outputs[0] in m.inputs]
        if len(adds) != 1 or adds[0].op_type != "Add" or \
                not single(n.outputs[0]):
            continue
        add = adds[0]
        one = (add.inputs[1] if add.inputs[0] == n.outputs[0]
               else add.inputs[0])
        if _const_scalar(g, one) != 1.0:
            continue
        muls = [m for m in g.nodes if add.outputs[0] in m.inputs]
        if len(muls) != 1 or muls[0].op_type != "Mul" or \
                not single(add.outputs[0]):
            continue
        m1 = muls[0]
        other = m1.inputs[1] if m1.inputs[0] == add.outputs[0] \
            else m1.inputs[0]
        final = None
        if other == x:
            # ... * x, then * 0.5
            m2s = [m for m in g.nodes if m1.outputs[0] in m.inputs]
            if len(m2s) == 1 and m2s[0].op_type == "Mul" and \
                    single(m1.outputs[0]):
                m2 = m2s[0]
                h = (m2.inputs[1] if m2.inputs[0] == m1.outputs[0]
                     else m2.inputs[0])
                if _const_scalar(g, h) == 0.5:
                    final = m2
        else:
            # other = Mul(x, 0.5) (or Mul(0.5, x))
            half = prod.get(other)
            if half is not None and half.op_type == "Mul":
                hins = set(half.inputs)
                if x in hins and any(
                        _const_scalar(g, i) == 0.5 for i in half.inputs
                        if i != x):
                    final = m1
        if final is None:
            continue
        fidx = g.nodes.index(final)
        replaced[fidx] = Node("Gelu", [x], list(final.outputs),
                              final.name or f"{final.outputs[0]}_gelu",
                              {"approximate": "none"})
        fused += 1

    if fused:
        g.nodes = [replaced.get(i, n) for i, n in enumerate(g.nodes)]
        prune_dead(g)
    return fused
