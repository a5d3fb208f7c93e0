"""Multi-LoRA: batched low-rank adapters selected per batch row, the
port's copy of onnx_rusty_inference_engine_tpu/lora.py.

One graph serves a mixed batch where every row may use a different
adapter: selection is a [B, n_adapters] one-hot MatMul against the stacked
adapter weights, and the delta path is two small batched MatMuls beside
the base projection:

    y = x @ W  +  (alpha/r) * (x @ A[idx]) @ B[idx]
        A_sel [B,D,r] = onehot(idx) @ A.reshape(n, D*r)
        B_sel [B,r,F] = onehot(idx) @ B.reshape(n, r*F)

`attach_lora` rewrites an imported Graph in standard ONNX ops (Equal/
Cast/MatMul/Reshape/Mul/Add), so the adapted graph still round-trips
through the exporter and composes with the int4 and W8A8 rewrites. The
adapter stacks are graph weights, and `lora_idx` is a graph input read at
run time: a captured graph reads it from its input buffer, so a server
changes a slot's adapter between replays without a new capture. The
small delta MatMuls run fp32-exact like every emitter product
(utils/fp32.py).

Convention: adapter index 0 is the base model (A[0] = B[0] = 0, which
`make_adapter_stack(zero_first=True)` keeps); rows with idx 0 then add an
exact zero delta. The same graph, bank and seed give the JAX package's
graph node for node and weight for weight.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, InputSpec, Node

__all__ = ["attach_lora", "make_adapter_stack", "fold_adapter"]


def _canon_wname(name: str) -> str:
    """INT4-quantized trunks rename weights (quant.quantize_weights_int4:
    'w' -> 'w__w4' packed); the bank stays keyed by the original name so
    the same bank attaches to fp32 and int4 graphs."""
    return name[:-4] if name.endswith("__w4") else name


def _lora_targets(graph: Graph, patterns: Sequence[str]) -> List[Node]:
    """MatMul / MatMulNBits nodes whose 2-D constant weight's (canonical)
    name contains a pattern."""
    out = []
    for node in graph.nodes:
        if node.op_type == "MatMul" and len(node.inputs) == 2:
            wn = node.inputs[1]
        elif node.op_type == "MatMulNBits":
            wn = node.inputs[1]
        else:
            continue
        w = graph.constants.get(wn)
        if w is None or w.ndim != 2:
            continue
        if any(p in _canon_wname(wn) for p in patterns):
            out.append(node)
    return out


def make_adapter_stack(
    graph: Graph,
    n_adapters: int,
    rank: int = 8,
    targets: Sequence[str] = ("attn",),
    seed: int = 0,
    scale: float = 0.02,
    zero_first: bool = True,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Random adapter bank: {weight_name: (A [n,D,r], B [n,r,F])}.

    Standard LoRA init is A ~ N(0, s), B = 0 (delta starts at zero); here
    B is random too so tests see a real delta — pass `zero_first=True`
    (default) to keep index 0 as the exact base model."""
    rng = np.random.default_rng(seed)
    bank = {}
    for node in _lora_targets(graph, targets):
        wn = node.inputs[1]
        d_in, d_out = graph.constants[wn].shape
        A = (rng.standard_normal((n_adapters, d_in, rank)) * scale
             ).astype(np.float32)
        B = (rng.standard_normal((n_adapters, rank, d_out)) * scale
             ).astype(np.float32)
        if zero_first:
            A[0] = 0.0
            B[0] = 0.0
        bank[wn] = (A, B)
    return bank


def fold_adapter(graph: Graph, bank: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 idx: int, alpha: float = 16.0) -> Graph:
    """Reference semantics: the base graph with W + (alpha/r) A[idx]@B[idx]
    folded into each targeted weight (what a single-adapter deployment
    would ship). Used by tests as the ground truth for `attach_lora`."""
    consts = dict(graph.constants)
    for wn, (A, B) in bank.items():
        r = A.shape[-1]
        consts[wn] = (consts[wn]
                      + (alpha / r) * (A[idx] @ B[idx])).astype(np.float32)
    return Graph(
        name=f"{graph.name}_fold{idx}",
        nodes=list(graph.nodes),
        constants=consts,
        inputs=list(graph.inputs),
        outputs=list(graph.outputs),
        opset=graph.opset,
        opsets=dict(graph.opsets),
        weight_names=list(graph.weight_names),
    )


def attach_lora(
    graph: Graph,
    bank: Dict[str, Tuple[np.ndarray, np.ndarray]],
    alpha: float = 16.0,
    idx_input: str = "lora_idx",
    batch: Optional[int] = None,
) -> Graph:
    """Rewrite `graph` so every banked MatMul adds its selected adapter's
    low-rank delta; adds the `lora_idx` [B] int64 graph input."""
    if not bank:
        raise ValueError("empty adapter bank")
    n = next(iter(bank.values()))[0].shape[0]
    for wn, (A, B) in bank.items():
        if A.shape[0] != n or B.shape[0] != n:
            raise ValueError(f"adapter counts disagree for '{wn}'")
        if wn not in graph.constants and f"{wn}__w4" not in graph.constants:
            raise ValueError(f"no such weight: '{wn}'")
    if batch is None:
        spec = graph.inputs[0]
        batch = int(spec.concrete_shape(batch=1)[0])

    consts = dict(graph.constants)
    weights = list(graph.weight_names)
    nodes: List[Node] = []

    # one-hot selector, built once: Equal(iota [n], idx [B,1]) -> [B, n]
    consts["lora__iota"] = np.arange(n, dtype=np.int64)
    consts["lora__idx_shape"] = np.array([batch, 1], np.int64)
    pre = [
        Node("Reshape", [idx_input, "lora__idx_shape"], ["lora__idx_col"]),
        Node("Equal", ["lora__iota", "lora__idx_col"], ["lora__eq"]),
        Node("Cast", ["lora__eq"], ["lora__onehot"], attrs={"to": 1}),
    ]

    targets = {_canon_wname(node.inputs[1]): node
               for node in _lora_targets(graph, list(bank))
               if _canon_wname(node.inputs[1]) in bank}
    missing = set(bank) - set(targets)
    if missing:
        raise ValueError(f"banked weights not used by any MatMul: "
                         f"{sorted(missing)}")

    emitted_pre = False
    for node in graph.nodes:
        if (node.inputs[1:2]
                and targets.get(_canon_wname(node.inputs[1])) is node):
            if not emitted_pre:
                nodes.extend(pre)
                emitted_pre = True
            wn = _canon_wname(node.inputs[1])
            A, B = bank[wn]
            _, d_in, r = A.shape
            d_out = B.shape[-1]
            tag = f"lora__{wn}"
            consts[f"{tag}_Af"] = np.ascontiguousarray(
                A.reshape(n, d_in * r))
            consts[f"{tag}_Bf"] = np.ascontiguousarray(
                B.reshape(n, r * d_out))
            weights += [f"{tag}_Af", f"{tag}_Bf"]
            consts[f"{tag}_ashape"] = np.array([batch, d_in, r], np.int64)
            consts[f"{tag}_bshape"] = np.array([batch, r, d_out], np.int64)
            consts[f"{tag}_scale"] = np.float32(alpha / r)
            out = node.outputs[0]
            base = f"{tag}_base"
            nodes.append(Node(node.op_type, list(node.inputs), [base],
                              node.name, dict(node.attrs), node.domain))
            nodes.extend([
                Node("MatMul", ["lora__onehot", f"{tag}_Af"],
                     [f"{tag}_af"]),
                Node("Reshape", [f"{tag}_af", f"{tag}_ashape"],
                     [f"{tag}_a"]),
                Node("MatMul", ["lora__onehot", f"{tag}_Bf"],
                     [f"{tag}_bf"]),
                Node("Reshape", [f"{tag}_bf", f"{tag}_bshape"],
                     [f"{tag}_b"]),
                Node("MatMul", [node.inputs[0], f"{tag}_a"],
                     [f"{tag}_xa"]),
                Node("MatMul", [f"{tag}_xa", f"{tag}_b"],
                     [f"{tag}_delta"]),
                Node("Mul", [f"{tag}_delta", f"{tag}_scale"],
                     [f"{tag}_scaled"]),
                Node("Add", [base, f"{tag}_scaled"], [out]),
            ])
        else:
            nodes.append(node)

    return Graph(
        name=f"{graph.name}_lora",
        nodes=nodes,
        constants=consts,
        inputs=list(graph.inputs) + [
            InputSpec(idx_input, (batch,), np.dtype(np.int64))],
        outputs=list(graph.outputs),
        opset=graph.opset,
        opsets=dict(graph.opsets),
        weight_names=weights,
    )
