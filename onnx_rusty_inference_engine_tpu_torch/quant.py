"""Post-training INT8 quantization: calibration + QDQ graph transform.

The port's counterpart of onnx_rusty_inference_engine_tpu/quant.py. The
graph transform (`quantize_graph`) is the JAX package's, line for line: it
is numpy over the Graph IR, so the same graph and the same `ranges` give
the same quantized graph in both packages. Calibration runs the port's own
engine (`lower`) on the device the caller names.

Scheme
------
- activations: per-tensor symmetric int8 (zero_point = 0), which keeps
  Relu/MaxPool/Concat exact in the int8 domain;
- weights: per-output-channel symmetric int8;
- biases: int32 at scale x_scale * w_scale (ONNX convention);
- compute: QLinearConv on the int8 kernel (ops/kernels/qconv_int8.py).

INT4 weight-only (`pack_int4`, `pack_int4_planar`, `quantize_weights_int4`)
and the int4 KV cache's packing (`pack_int4_kv`) are the JAX package's
arithmetic, line for line, so both packages pack the same bytes and
scales. Dynamic W8A8 (`quantize_matmuls_w8a8`) is the JAX package's
rewrite node for node, with the same constants bit for bit. The "mse"
calibration method and `bias_correct` are the JAX package's algorithms on
the port's engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import lower, resolve_device
from .graph import Graph, Node, prune_dead, topo_sort
from .models._builder import memo

__all__ = ["calibrate", "quantize_graph", "QuantConfig", "bias_correct",
           "pack_int4", "pack_int4_planar", "quantize_weights_int4",
           "quantize_matmuls_w8a8", "pack_int4_kv"]


@dataclasses.dataclass
class QuantConfig:
    per_channel_weights: bool = True
    # ops converted to QLinear form
    quantize_ops: Tuple[str, ...] = ("Conv", "MatMul", "Gemm")
    # ops that pass int8 through unchanged (symmetric scheme keeps them exact)
    int8_transparent: Tuple[str, ...] = ("Relu", "MaxPool", "Reshape",
                                         "Flatten", "Transpose", "Identity")
    # mixed precision: nodes for which this predicate returns True keep
    # their fp32 form (e.g. lambda n: int(n.attr("group", 1)) > 1 to leave
    # depthwise convs unquantized)
    exclude: Optional[callable] = None
    # activation-range calibration: "minmax" records plain min/max;
    # "percentile" clips to the given |x| percentile (outlier-robust);
    # "mse" picks the clip that minimizes int8 reconstruction error
    calibration: str = "minmax"
    percentile: float = 99.99


# --------------------------------------------------------------------------
# Calibration
# --------------------------------------------------------------------------
def _percentile(a: torch.Tensor, q: float) -> float:
    """The linear-interpolation percentile of a flattened float32 tensor,
    computed in float32 as jnp.percentile computes it (position, weights
    and blend all in float32)."""
    flat = torch.sort(a.reshape(-1).to(torch.float32)).values
    pos = (torch.tensor(q, dtype=torch.float32) / 100.0
           * torch.tensor(flat.numel() - 1, dtype=torch.float32))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    return float(flat[int(lo)].cpu() * w_lo + flat[int(hi)].cpu() * w_hi)


def calibrate(
    graph: Graph,
    calibration_inputs: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    max_tensors: int = 4096,
    method: str = "minmax",
    percentile: float = 99.99,
    device="cuda",
) -> Dict[str, Tuple[float, float]]:
    """Run the fp32 graph on calibration batches and record a per-tensor
    quantization range for every intermediate value.

    method="minmax" records plain (min, max); "percentile" records the
    symmetric range at the given |x| percentile; "mse" sweeps candidate
    clips (0.3..1.0 of amax, one grid per tensor from its amax over every
    batch) and keeps the one whose int8 round trip has the least squared
    error summed over every batch (the JAX package's two passes and single
    global argmin)."""
    if method not in ("minmax", "percentile", "mse"):
        raise ValueError(f"unknown calibration method: {method!r}")
    if calibration_inputs is None:
        rng = np.random.default_rng(0)
        feed = {
            spec.name: rng.standard_normal(spec.concrete_shape(batch=1)).astype(
                spec.dtype
            )
            for spec in graph.inputs
        }
        calibration_inputs = [feed]

    # Probe graph whose outputs are every intermediate (debug.py builds it;
    # logs when max_tensors truncates).
    from .debug import probe_graph
    from .weights import as_device_tensor, params_from_numpy

    device = resolve_device(device)
    probe = probe_graph(graph, max_tensors=max_tensors)
    fn = lower(probe, device)
    params = params_from_numpy(
        {k: graph.constants[k] for k in graph.weight_names}, device)

    def batch_range(val: torch.Tensor) -> Tuple[float, float]:
        if method == "minmax":
            return float(val.min()), float(val.max())
        amax = _percentile(val.to(torch.float32).abs(), percentile)
        return -amax, amax

    def runs():
        with torch.no_grad():
            for feed in calibration_inputs:
                out = fn(params, {k: as_device_tensor(v, device)
                                  for k, v in feed.items()})
                yield {k: v for k, v in out.items() if v.is_floating_point()}

    if method == "mse":
        return _mse_ranges(runs)
    ranges: Dict[str, Tuple[float, float]] = {}
    for out in runs():
        for name, val in out.items():
            lo, hi = batch_range(val)
            if name in ranges:
                plo, phi = ranges[name]
                ranges[name] = (min(plo, lo), max(phi, hi))
            else:
                ranges[name] = (lo, hi)
    return ranges


def _mse_errors(val: torch.Tensor, cands: np.ndarray) -> np.ndarray:
    """Each candidate clip's summed int8 round-trip squared error of |val|,
    the JAX package's f32 arithmetic per element (scales cands / 127 in
    f32, round half to even, clip to [0, 127]), summed in float64."""
    a = val.to(torch.float32).abs().reshape(-1)
    scales = torch.tensor(cands, dtype=torch.float32,
                          device=a.device) / 127.0
    out = np.empty(len(cands))
    for i, s in enumerate(scales):
        q = torch.clamp(torch.round(a / s), 0, 127)
        out[i] = float(((q * s - a) ** 2).sum(dtype=torch.float64))
    return out


def _mse_ranges(runs) -> Dict[str, Tuple[float, float]]:
    """calibrate(method="mse"): pass 1 records each tensor's global amax,
    which fixes one shared candidate grid; pass 2 sums each candidate's
    error over the batches and takes one global argmin (with one batch, the
    one-shot sweep)."""
    amaxes: Dict[str, float] = {}
    for out in runs():
        for name, val in out.items():
            a = float(val.to(torch.float32).abs().max())
            amaxes[name] = max(amaxes.get(name, 0.0), a)
    grids = {name: max(a, 1e-8) * np.linspace(0.3, 1.0, 15)
             for name, a in amaxes.items()}
    errs: Dict[str, np.ndarray] = {}
    for out in runs():
        for name, val in out.items():
            if name in grids:
                errs[name] = errs.get(name, 0.0) + _mse_errors(val,
                                                               grids[name])
    return {name: (-float(grids[name][np.argmin(e)]),
                   float(grids[name][np.argmin(e)]))
            for name, e in errs.items()}


def _static_clip_bounds(graph: Graph, node: Node
                        ) -> Optional[Tuple[float, float]]:
    """(min, max) of a Clip node when both bounds are static, else None."""

    def bound(attr_name: str, input_idx: int):
        v = node.attr(attr_name)
        if v is not None:
            return float(v)
        if len(node.inputs) > input_idx and node.inputs[input_idx]:
            c = graph.constants.get(node.inputs[input_idx])
            if c is not None and c.size == 1:
                return float(np.asarray(c).reshape(()))
            return None  # dynamic bound
        return None

    lo = bound("min", 1)
    hi = bound("max", 2)
    if lo is None or hi is None:
        return None
    return lo, hi


def _act_scale(ranges: Dict[str, Tuple[float, float]], name: str) -> float:
    lo, hi = ranges.get(name, (-1.0, 1.0))
    amax = max(abs(lo), abs(hi), 1e-8)
    return amax / 127.0


def _quantize_weight(w: np.ndarray, per_channel: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8; per-channel along axis 0 (conv O) when requested."""
    if per_channel and w.ndim >= 2:
        axes = tuple(range(1, w.ndim))
        amax = np.maximum(np.max(np.abs(w), axis=axes), 1e-8)
    else:
        amax = np.maximum(np.max(np.abs(w)), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / np.reshape(scale, (-1,) + (1,) * (w.ndim - 1))
                         if np.ndim(scale) else w / scale),
                -127, 127).astype(np.int8)
    return q, np.atleast_1d(scale)


# --------------------------------------------------------------------------
# Transform
# --------------------------------------------------------------------------
def quantize_graph(
    graph: Graph,
    calibration_inputs: Optional[Sequence[Dict[str, np.ndarray]]] = None,
    ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    config: QuantConfig = QuantConfig(),
    device="cuda",
) -> Graph:
    """Return a new Graph in QLinear form (fp32 Graph is unmodified).
    `device` is where calibration runs when `ranges` is not given."""
    if ranges is None:
        ranges = calibrate(graph, calibration_inputs,
                           method=config.calibration,
                           percentile=config.percentile, device=device)

    consumers: Dict[str, List[Node]] = {}
    for n in graph.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)

    # --- unify scales across Concat inputs (one pass; SqueezeNet fires) ----
    scale_override: Dict[str, float] = {}
    for n in graph.nodes:
        if n.op_type == "Concat":
            s = max(_act_scale(ranges, i) for i in n.inputs)
            for i in n.inputs:
                scale_override[i] = s
            scale_override[n.outputs[0]] = s
    # Relu output shares its input scale only if we fold; we keep Relu in
    # int8 domain, so give Relu output its own (post-relu) range — but its
    # *input* must use the same scale as its output for exactness. Clip with
    # static bounds (ReLU6 in MobileNet) gets the same treatment: the int8
    # saturation at 127·s realizes the upper bound, and the remaining lower
    # bound is applied as an int8-domain clip.
    for n in graph.nodes:
        if n.op_type == "Relu" or (
                n.op_type == "Clip" and _static_clip_bounds(graph, n)):
            out_s = scale_override.get(n.outputs[0], _act_scale(ranges, n.outputs[0]))
            scale_override[n.inputs[0]] = out_s

    def act_scale(name: str) -> float:
        return scale_override.get(name, _act_scale(ranges, name))

    new_nodes: List[Node] = []
    new_consts: Dict[str, np.ndarray] = dict(graph.constants)
    new_weights: List[str] = []
    # tensor name -> ("int8", scale) for values materialized in int8 domain
    qdomain: Dict[str, float] = {}

    def add_const(name: str, arr: np.ndarray, is_weight=True) -> str:
        new_consts[name] = arr
        if is_weight:
            new_weights.append(name)
        return name

    def scale_const(qname: str) -> str:
        s_name = f"{qname}__s"
        if s_name not in new_consts:
            add_const(s_name, np.float32(qdomain[qname]), is_weight=False)
        return s_name

    def ensure_int8(name: str) -> Tuple[str, str]:
        """Return (int8_tensor_name, scale_const_name) for a value, inserting
        QuantizeLinear if it currently lives in fp32."""
        if name in qdomain:
            return name, scale_const(name)
        q_name = f"{name}__q8"
        if q_name not in qdomain:
            s = act_scale(name)
            s_name = add_const(f"{name}__scale", np.float32(s), is_weight=False)
            zp_name = add_const(f"{name}__zp", np.int8(0), is_weight=False)
            new_nodes.append(Node("QuantizeLinear", [name, s_name, zp_name],
                                  [q_name], name=f"quant_{name}"))
            qdomain[q_name] = s
        return q_name, scale_const(q_name)

    def ensure_fp32(name: str) -> str:
        """Dequantize an int8-domain tensor back to fp32."""
        if name not in qdomain:
            return name
        d_name = f"{name}__dq"
        s = qdomain[name]
        s_name = add_const(f"{name}__dqs", np.float32(s), is_weight=False)
        zp_name = add_const(f"{name}__dqzp", np.int8(0), is_weight=False)
        new_nodes.append(Node("DequantizeLinear", [name, s_name, zp_name],
                              [d_name], name=f"dequant_{name}"))
        return d_name

    for node in graph.nodes:
        op = node.op_type
        if op in config.quantize_ops and not (
                config.exclude is not None and config.exclude(node)):
            w_name = node.inputs[1]
            w = new_consts.get(w_name)
            # dynamic weights (e.g. activation x activation matmul) stay fp32
            if w is None or not np.issubdtype(w.dtype, np.floating):
                new_nodes.append(Node(op, [ensure_fp32(i) for i in node.inputs],
                                      node.outputs, node.name, dict(node.attrs)))
                continue
            if op == "Gemm" and (
                    int(node.attr("transA", 0))
                    or float(node.attr("alpha", 1.0)) != 1.0
                    or float(node.attr("beta", 1.0)) not in (0.0, 1.0)):
                # QLinearMatMul has no alpha/beta; non-default Gemms stay fp32
                new_nodes.append(Node(op, [ensure_fp32(i) for i in node.inputs],
                                      node.outputs, node.name, dict(node.attrs)))
                continue

            x_q, x_s = ensure_int8(node.inputs[0])
            w_mat = w
            attrs = dict(node.attrs)
            if op == "Gemm" and int(node.attr("transB", 0)):
                w_mat = np.ascontiguousarray(w_mat.T)
                attrs.pop("transB", None)
            per_ch = config.per_channel_weights and op == "Conv"
            if op in ("MatMul", "Gemm") and config.per_channel_weights \
                    and w_mat.ndim == 2:
                # per-output-column scales: quantize along axis 1
                amax = np.maximum(np.max(np.abs(w_mat), axis=0), 1e-8)
                w_scale = (amax / 127.0).astype(np.float32)
                w_q = np.clip(np.round(w_mat / w_scale), -127, 127).astype(np.int8)
            else:
                w_q, w_scale = _quantize_weight(w_mat, per_ch)

            wq_name = add_const(f"{w_name}__w8", w_q)
            ws_name = add_const(f"{w_name}__ws", w_scale, is_weight=False)
            wzp_name = add_const(f"{w_name}__wzp",
                                 np.zeros_like(w_scale, dtype=np.int8),
                                 is_weight=False)

            y_name = node.outputs[0]
            y_s = act_scale(y_name)
            ys_name = add_const(f"{y_name}__ys", np.float32(y_s), is_weight=False)
            yzp_name = add_const(f"{y_name}__yzp", np.int8(0), is_weight=False)

            qop = "QLinearConv" if op == "Conv" else "QLinearMatMul"
            x_scale_val = qdomain[x_q]
            x_zp = add_const(f"{x_q}__xzp", np.int8(0), is_weight=False)
            inputs = [x_q, x_s, x_zp, wq_name, ws_name, wzp_name,
                      ys_name, yzp_name]
            # bias -> int32 at scale x_s * w_s (skipped when Gemm beta == 0)
            if len(node.inputs) > 2 and node.inputs[2] and \
                    float(node.attr("beta", 1.0)) != 0.0:
                b = new_consts.get(node.inputs[2])
                if b is not None:
                    b32 = np.round(
                        b / (x_scale_val * w_scale.reshape(-1)[: b.size]
                             if w_scale.size > 1 else x_scale_val * w_scale)
                    ).astype(np.int32)
                    inputs.append(add_const(f"{node.inputs[2]}__b32", b32))
            new_nodes.append(Node(qop, inputs, node.outputs, node.name, attrs))
            qdomain[y_name] = y_s

        elif op == "Clip" and node.inputs[0] in qdomain \
                and _static_clip_bounds(graph, node):
            # ReLU6-style: clip in the int8 domain at round(bound / s)
            lo, hi = _static_clip_bounds(graph, node)
            s = qdomain[node.inputs[0]]
            lo_q = np.int8(np.clip(round(lo / s), -128, 127))
            hi_q = np.int8(np.clip(round(hi / s), -128, 127))
            lo_name = add_const(f"{node.outputs[0]}__cliplo", lo_q,
                                is_weight=False)
            hi_name = add_const(f"{node.outputs[0]}__cliphi", hi_q,
                                is_weight=False)
            new_nodes.append(Node("Clip", [node.inputs[0], lo_name, hi_name],
                                  node.outputs, node.name))
            qdomain[node.outputs[0]] = s

        elif op in config.int8_transparent and node.inputs[0] in qdomain:
            # stays in int8 domain
            new_nodes.append(Node(op, list(node.inputs), node.outputs,
                                  node.name, dict(node.attrs)))
            qdomain[node.outputs[0]] = qdomain[node.inputs[0]]

        elif op == "Add" and len(node.inputs) == 2 and \
                all(i in qdomain for i in node.inputs):
            # residual adds stay in the int8 domain via the ORT-contrib
            # QLinearAdd (dequant-add-requant fused on the VPU) instead of
            # an fp32 island between QLinearConvs
            a, b_in = node.inputs
            y_name = node.outputs[0]
            y_s = act_scale(y_name)
            ys_name = add_const(f"{y_name}__ys", np.float32(y_s),
                                is_weight=False)
            yzp_name = add_const(f"{y_name}__yzp", np.int8(0),
                                 is_weight=False)
            zp_a = add_const(f"{a}__azp", np.int8(0), is_weight=False)
            zp_b = add_const(f"{b_in}__bzp", np.int8(0), is_weight=False)
            new_nodes.append(Node(
                "QLinearAdd",
                [a, scale_const(a), zp_a, b_in, scale_const(b_in), zp_b,
                 ys_name, yzp_name],
                node.outputs, node.name))
            qdomain[y_name] = y_s

        elif op == "Concat" and all(i in qdomain for i in node.inputs):
            scales = {round(qdomain[i], 12) for i in node.inputs}
            if len(scales) == 1:
                new_nodes.append(Node(op, list(node.inputs), node.outputs,
                                      node.name, dict(node.attrs)))
                qdomain[node.outputs[0]] = qdomain[node.inputs[0]]
            else:  # scales diverged — fall back to fp32 concat
                new_nodes.append(Node(op, [ensure_fp32(i) for i in node.inputs],
                                      node.outputs, node.name, dict(node.attrs)))

        else:
            # fp32 island: dequantize any int8 inputs
            new_nodes.append(Node(op, [ensure_fp32(i) for i in node.inputs],
                                  node.outputs, node.name, dict(node.attrs)))

    # graph outputs must come back to fp32 — keeping their original names
    final_outputs: List[str] = []
    for o in graph.outputs:
        if o in qdomain:
            raw = f"{o}__qraw"
            for n in new_nodes:  # rename the int8 producer's output
                n.outputs = [raw if x == o else x for x in n.outputs]
                n.inputs = [raw if x == o else x for x in n.inputs]
            qdomain[raw] = qdomain.pop(o)
            s_name = add_const(f"{raw}__dqs", np.float32(qdomain[raw]),
                               is_weight=False)
            zp_name = add_const(f"{raw}__dqzp", np.int8(0), is_weight=False)
            new_nodes.append(Node("DequantizeLinear", [raw, s_name, zp_name],
                                  [o], name=f"dequant_{o}"))
        final_outputs.append(o)

    qgraph = Graph(
        name=f"{graph.name}_int8",
        nodes=new_nodes,
        constants=new_consts,
        inputs=graph.inputs,
        outputs=final_outputs,
        opset=max(graph.opset, 10),
        weight_names=[w for w in dict.fromkeys(graph.weight_names + new_weights)
                      if w in new_consts],
    )
    avail = set(qgraph.constants) | {i.name for i in qgraph.inputs}
    qgraph.nodes = topo_sort(qgraph.nodes, avail)
    prune_dead(qgraph)
    return qgraph


def bias_correct(
    qgraph: Graph,
    fgraph: Graph,
    calibration_inputs: Sequence[Dict[str, np.ndarray]],
    device="cuda",
) -> Graph:
    """Post-quantization bias correction (DFQ-style, Nagel et al. 2019), the
    JAX package's algorithm on the port's engine.

    Quantization noise has a nonzero per-channel mean (weight rounding is
    deterministic), which shifts every activation distribution; absorbing
    E[fp32_out - int8_out] into the int32 bias removes the shift for free
    at inference. Every QLinearConv / QLinearMatMul gets a bias input
    (zeros) before the probe is built; then, in topological order, each
    target's per-channel mean error over the calibration set (saturated
    elements excluded: with clip- or relu-pinned output scales the int8
    saturation is the activation bound, not rounding noise), measured with
    every upstream correction applied, adds round(mean_err / (x_s * w_s))
    to its int32 bias. Mutates and returns qgraph."""
    from .weights import as_device_tensor, params_from_numpy

    device = resolve_device(device)
    targets = [n for n in qgraph.nodes
               if n.op_type in ("QLinearConv", "QLinearMatMul")]
    if not targets:
        return qgraph
    for n in targets:
        if not (len(n.inputs) > 8 and n.inputs[8]):
            w_s = np.asarray(qgraph.constants[n.inputs[4]]).reshape(-1)
            bname = f"{n.outputs[0]}__bcorr"
            qgraph.constants[bname] = np.zeros((w_s.size,), np.int32)
            qgraph.weight_names.append(bname)
            n.inputs = list(n.inputs)[:8] + [bname]

    out_names = [n.outputs[0] for n in targets]

    def make_probe(graph: Graph):
        made = {x for nd in graph.nodes for x in nd.outputs}
        p = Graph(name=graph.name, nodes=graph.nodes,
                  constants=graph.constants, inputs=graph.inputs,
                  outputs=[o for o in out_names if o in made],
                  opset=graph.opset, opsets=dict(graph.opsets),
                  weight_names=graph.weight_names)
        return lower(p, device)

    def run(fn, params) -> Dict[str, np.ndarray]:
        acc: Dict[str, list] = {}
        with torch.no_grad():
            for feed in calibration_inputs:
                out = fn(params, {k: as_device_tensor(v, device)
                                  for k, v in feed.items()})
                for k, v in out.items():
                    acc.setdefault(k, []).append(
                        v.cpu().numpy().astype(np.float64))
        return {k: np.concatenate(v) for k, v in acc.items()}

    def params_of(graph: Graph) -> Dict[str, torch.Tensor]:
        return params_from_numpy(
            {k: graph.constants[k] for k in graph.weight_names}, device)

    f_out = run(make_probe(fgraph), params_of(fgraph))
    q_fn = make_probe(qgraph)
    q_params = params_of(qgraph)
    for n in targets:
        name = n.outputs[0]
        if name not in f_out:
            continue
        q_out = run(q_fn, q_params)
        y_s = float(np.asarray(qgraph.constants[n.inputs[6]]).reshape(-1)[0])
        qv = q_out[name]
        err = f_out[name] - qv * y_s
        interior = (qv > -127) & (qv < 127)
        # per-output-channel mean: channel axis 1 for conv, -1 for matmul
        ch_axis = 1 if n.op_type == "QLinearConv" else err.ndim - 1
        axes = tuple(a for a in range(err.ndim) if a != ch_axis)
        cnt = np.maximum(interior.sum(axis=axes), 1)
        mean_err = np.where(interior, err, 0.0).sum(axis=axes) / cnt
        x_s = float(np.asarray(qgraph.constants[n.inputs[1]]).reshape(-1)[0])
        w_s = np.asarray(qgraph.constants[n.inputs[4]]).reshape(-1)
        delta = np.round(mean_err / (x_s * w_s)).astype(np.int64)
        bname = n.inputs[8]
        b = np.asarray(qgraph.constants[bname]).astype(np.int64)
        new_b = np.clip(b + delta, np.iinfo(np.int32).min,
                        np.iinfo(np.int32).max).astype(np.int32)
        qgraph.constants[bname] = new_b
        q_params[bname] = torch.from_numpy(new_b).to(device)
    return qgraph


# --------------------------------------------------------------------------
# INT4 weight-only (GPT-2 north-star config: BASELINE.json configs[4])
# --------------------------------------------------------------------------
def pack_int4(w: np.ndarray, block_size: int = 256
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-block INT4 packing of a [K, N] matmul weight, in the
    interleaved (ORT MatMulNBits) layout.

    Returns (packed uint8 [N, K//2] -- two nibbles per byte, k-major, value
    stored as q+8 in [0,15]; scales fp32 [N, K//block_size])."""
    K, N = w.shape
    assert K % 2 == 0, "K must be even for nibble packing"
    bs = min(block_size, K)
    while K % bs:
        bs //= 2
    n_blocks = K // bs
    wt = np.ascontiguousarray(w.T)  # [N, K]
    blocks = wt.reshape(N, n_blocks, bs)
    amax = np.maximum(np.abs(blocks).max(axis=2), 1e-8)
    scales = (amax / 7.0).astype(np.float32)  # [N, n_blocks]
    q = np.clip(np.round(blocks / scales[:, :, None]), -8, 7).astype(np.int8)
    q = q.reshape(N, K) + 8  # -> [0, 15]
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)  # [N, K//2]
    return packed, scales


def pack_int4_planar(w: np.ndarray, block_size: int = 256
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-block INT4 packing, PLANAR nibble layout: byte j holds
    q[j] (lo nibble) and q[j + K/2] (hi nibble) -- the two nibble planes are
    the contiguous halves of K. Each half is quantized with its own
    per-block scales (blocks are runs of bs consecutive columns of K).

    Returns (packed uint8 [N, K//2], scales fp32 [2*nbh, N] k-major -- the
    lo-half block scales in rows [0, nbh), the hi half in [nbh, 2*nbh));
    nbh = (K//2) / bs with bs = block_size shrunk by powers of two until
    it divides K//2 (ops/kernels/qmatmul_int4.planar_layout)."""
    from .ops.kernels.qmatmul_int4 import planar_layout

    K, N = w.shape
    assert K % 2 == 0, "K must be even for nibble packing"
    Kh = K // 2
    nbh, bs = planar_layout(K, block_size)
    wt = np.ascontiguousarray(w.T)  # [N, K]
    halves = wt.reshape(N, 2, nbh, bs)
    amax = np.maximum(np.abs(halves).max(axis=3), 1e-8)  # [N, 2, nbh]
    scales = (amax / 7.0).astype(np.float32)
    q = np.clip(np.round(halves / scales[..., None]), -8, 7).astype(np.int8)
    q = q.reshape(N, 2, Kh) + 8  # -> [0, 15]
    packed = (q[:, 0] | (q[:, 1] << 4)).astype(np.uint8)  # [N, Kh]
    return packed, np.ascontiguousarray(
        scales.transpose(1, 2, 0).reshape(2 * nbh, N))


def _pack_planar(w: np.ndarray, block_size: int):
    """pack_int4_planar of one weight array, inside models.host_memo once
    per array (the entry keeps the array, so its id stays its own)."""
    _, packed, scales = memo(
        ("int4_planar", id(w), block_size),
        lambda: (w, *pack_int4_planar(w.astype(np.float32), block_size)))
    return packed, scales


def _int4_scan_body(node: Node, consts: Dict[str, np.ndarray],
                    weights: List[str], min_elems: int,
                    block_size: int) -> Node:
    """INT4-quantize the stacked per-layer weights of a scan-over-layers
    decode graph (models/gpt2._build_gpt2_decode_scan): the JAX package's
    `_int4_scan_body`, constant for constant.

    For each Scan input that is a stacked 3-D float constant [n_layer,K,N]
    consumed in the body ONLY as the B operand of one MatMul: pack every
    layer (pack_int4_planar), stack to packed [n_layer,Nw,K//2] + scales
    [n_layer,2*nbh,Nw], replace the single scan input with these two, and
    rewrite the body MatMul to MatMulNBits over the per-iteration slices.
    Inside models.host_memo each layer is packed once: a stack built by
    models._builder.stacked is packed from its per-layer arrays, the very
    packings the per-layer graph's quantization makes, and the stacked
    packing itself is made once per stack."""
    from . import onnx_io
    from .models._builder import _attr, stack_parts
    from .ops.kernels.qmatmul_int4 import planar_layout

    body = node.attr("body")
    n_scan = int(node.attr("num_scan_inputs"))
    n_state = len(node.inputs) - n_scan
    body_in_names = [vi.name for vi in body.inputs]
    outer_for = {body_in_names[j]: j for j in range(n_state,
                                                    len(body_in_names))}

    # body tensor usage counts (a weight consumed twice can't be rewritten)
    use_count: Dict[str, int] = {}
    for bn in body.nodes:
        for i in bn.input:
            if i:
                use_count[i] = use_count.get(i, 0) + 1

    scan_inputs = list(node.inputs)
    body_inputs = list(body.inputs)
    new_body_nodes = []
    changed = False

    def pack_stack(w_stack):
        parts = stack_parts(w_stack)
        if parts is None:
            parts = [w_stack[l] for l in range(w_stack.shape[0])]
        packs, scls = zip(*(_pack_planar(p, block_size) for p in parts))
        packed = np.stack(packs)   # [NL, N, K//2]
        scales = np.stack(scls)    # [NL, 2*nbh, N] (k-major)
        n_pad = -(-packed.shape[1] // 256) * 256 - packed.shape[1]
        if n_pad:  # N pre-padded to a multiple of 256, as in JAX
            packed = np.pad(packed, ((0, 0), (0, n_pad), (0, 0)))
            scales = np.pad(scales, ((0, 0), (0, 0), (0, n_pad)))
        return w_stack, packed, scales

    for bn in body.nodes:
        if (bn.op_type == "MatMul" and len(bn.input) == 2
                and bn.input[1] in outer_for
                and use_count.get(bn.input[1], 0) == 1):
            slice_name = bn.input[1]
            outer_name = scan_inputs[
                [vi.name for vi in body_inputs].index(slice_name)]
            w_stack = consts.get(outer_name)
            if (w_stack is not None and w_stack.ndim == 3
                    and w_stack[0].size >= min_elems
                    and np.issubdtype(w_stack.dtype, np.floating)
                    and w_stack.shape[1] % 2 == 0):
                _, K, N = w_stack.shape
                _, packed, scales = memo(
                    ("int4_planar_stack", id(w_stack), block_size),
                    lambda w_stack=w_stack: pack_stack(w_stack))
                pname, sname = f"{outer_name}__w4", f"{outer_name}__w4s"
                consts[pname] = packed
                consts[sname] = scales
                weights.append(pname)
                weights.append(sname)
                # swap the outer scan input, append the scales input
                j = scan_inputs.index(outer_name)
                scan_inputs[j] = pname
                scan_inputs.insert(j + 1, sname)
                bslice_p, bslice_s = f"{slice_name}__w4", f"{slice_name}__w4s"
                jb = [vi.name for vi in body_inputs].index(slice_name)
                body_inputs[jb] = onnx_io.ValueInfo(
                    name=bslice_p, elem_type=onnx_io.NUMPY_TO_DTYPE[
                        np.dtype(np.uint8)],
                    shape=list(packed.shape[1:]))
                body_inputs.insert(jb + 1, onnx_io.ValueInfo(
                    name=bslice_s, elem_type=onnx_io.NUMPY_TO_DTYPE[
                        np.dtype(np.float32)],
                    shape=list(scales.shape[1:])))
                nb = onnx_io.NodeProto(
                    op_type="MatMulNBits",
                    input=[bn.input[0], bslice_p, bslice_s],
                    output=list(bn.output), name=bn.name,
                    domain="com.microsoft")
                for k_, v_ in {"K": K, "N": N, "bits": 4,
                               "layout": "planar",
                               "block_size":
                               planar_layout(K, block_size)[1]}.items():
                    nb.attributes[k_] = _attr(k_, v_)
                new_body_nodes.append(nb)
                changed = True
                n_scan += 1
                continue
        new_body_nodes.append(bn)

    if not changed:
        return node
    # never mutate the caller's body GraphProto: node.attr("body") is the
    # SAME object the input graph's Scan node holds; rewriting it in place
    # would leave that graph's Scan feeding fp32 stacks to a body that
    # expects packed uint8 + scales. Shallow-copy and give it fresh lists.
    import copy

    body = copy.copy(body)
    body.nodes = new_body_nodes
    body.inputs = body_inputs
    attrs = dict(node.attrs)
    attrs["body"] = body
    attrs["num_scan_inputs"] = n_scan
    return Node(node.op_type, scan_inputs, list(node.outputs), node.name,
                attrs, node.domain)


def quantize_weights_int4(
    graph: Graph,
    min_elems: int = 4096,
    block_size: int = 256,
) -> Graph:
    """Rewrite MatMul nodes with large constant 2-D weights into
    MatMulNBits(bits=4, layout="planar") nodes (weight-only; activations
    stay floating), and the stacked weights a Scan body multiplies by into
    the same over each iteration's slice (`_int4_scan_body`). Embedding
    Gathers and small weights are untouched."""
    from .ops.kernels.qmatmul_int4 import planar_layout

    new_nodes: List[Node] = []
    consts = dict(graph.constants)
    weights = list(graph.weight_names)
    for node in graph.nodes:
        if node.op_type == "Scan":
            new_nodes.append(_int4_scan_body(node, consts, weights,
                                             min_elems, block_size))
            continue
        if node.op_type == "MatMul" and len(node.inputs) == 2:
            w = consts.get(node.inputs[1])
            if (w is not None and w.ndim == 2 and w.size >= min_elems
                    and np.issubdtype(w.dtype, np.floating)
                    and w.shape[0] % 2 == 0):
                K, N = w.shape
                packed, scales = _pack_planar(w, block_size)
                # N pre-padded to a multiple of 256, as the JAX quantizer
                # pads it for its TPU kernel's blocks: the graphs of the two
                # packages stay equal (the kernel here writes only N columns)
                n_pad = -(-N // 256) * 256 - N
                if n_pad:
                    packed = np.pad(packed, ((0, n_pad), (0, 0)))
                    scales = np.pad(scales, ((0, 0), (0, n_pad)))
                pname = f"{node.inputs[1]}__w4"
                sname = f"{node.inputs[1]}__w4s"
                consts[pname] = packed
                consts[sname] = scales
                weights.append(pname)
                weights.append(sname)
                new_nodes.append(Node(
                    "MatMulNBits",
                    [node.inputs[0], pname, sname],
                    list(node.outputs),
                    node.name,
                    {"K": K, "N": N, "bits": 4, "layout": "planar",
                     "block_size": planar_layout(K, block_size)[1]},
                ))
                continue
        new_nodes.append(node)

    g4 = Graph(
        name=f"{graph.name}_w4",
        nodes=new_nodes,
        constants=consts,
        inputs=graph.inputs,
        outputs=list(graph.outputs),
        opset=graph.opset,
        weight_names=weights,
    )
    prune_dead(g4)
    return g4


def _w8(w: np.ndarray):
    """W8A8's weight: (int8 values, f32 per-column scales max|w| / 127)."""
    w_scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    wq = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    return wq, w_scale


def quantize_matmuls_w8a8(graph: Graph, min_elems: int = 4096) -> Graph:
    """Dynamic W8A8: every MatMul whose weight is a constant 2-D float
    tensor of at least `min_elems` elements becomes an int8 x int8
    MatMulInteger between per-row quantized activations and per-column
    quantized weights, then two Muls that dequantize.

    Weights: per-output-column symmetric int8, scale max|w| / 127 (floored
    at 1e-12 / 127), values clipped to [-127, 127]. Activations: quantized
    per row inside the graph (amax over the contraction axis / 127, at
    least 1e-12), so no calibration pass is needed. Between the Round and
    the int8 Cast a Clip to [-127, 127] saturates: under the bf16 Engine
    the rounded scale can put x / s at 127.5, which rounds to 128, and a
    conversion out of int8's range is undefined on the card (it may wrap
    to -128). On the card the MatMulInteger runs on the int8 tensor-core
    kernel (ops/kernels/qmatmul_int8.py, int32 epilogue).

    The JAX package's rewrite, node for node and constant for constant
    (its quant.py:782-854)."""
    new_nodes: List[Node] = []
    consts = dict(graph.constants)
    weights = list(graph.weight_names)
    for node in graph.nodes:
        w = consts.get(node.inputs[1]) if (
            node.op_type == "MatMul" and len(node.inputs) == 2) else None
        if (w is None or not isinstance(w, np.ndarray) or w.ndim != 2
                or w.size < min_elems
                or not np.issubdtype(w.dtype, np.floating)):
            new_nodes.append(node)
            continue
        x, y = node.inputs[0], node.outputs[0]
        # inside models.host_memo, one quantization per weight array (the
        # entry keeps the array, so its id stays its own)
        _, wq, w_scale = memo(("w8", id(w)), lambda w=w: (w, *_w8(w)))
        wqn, wsn = f"{node.inputs[1]}__w8", f"{node.inputs[1]}__w8s"
        consts[wqn] = wq
        consts[wsn] = w_scale.astype(np.float32)
        weights += [wqn, wsn]
        p = f"{y}__w8a8"
        consts[f"{p}_qmax"] = np.float32(127.0)
        consts[f"{p}_qmin"] = np.float32(-127.0)
        consts[f"{p}_eps"] = np.float32(1e-12)
        new_nodes += [
            Node("Abs", [x], [f"{p}_abs"]),
            Node("ReduceMax", [f"{p}_abs"], [f"{p}_amax"],
                 attrs={"axes": [-1], "keepdims": 1}),
            Node("Div", [f"{p}_amax", f"{p}_qmax"], [f"{p}_s0"]),
            Node("Max", [f"{p}_s0", f"{p}_eps"], [f"{p}_s"]),
            Node("Div", [x, f"{p}_s"], [f"{p}_xs"]),
            Node("Round", [f"{p}_xs"], [f"{p}_xr"]),
            # saturate before the int8 Cast (see above)
            Node("Clip", [f"{p}_xr", f"{p}_qmin", f"{p}_qmax"],
                 [f"{p}_xc"]),
            Node("Cast", [f"{p}_xc"], [f"{p}_xq"], attrs={"to": 3}),  # INT8
            Node("MatMulInteger", [f"{p}_xq", wqn], [f"{p}_i32"]),
            Node("Cast", [f"{p}_i32"], [f"{p}_f"], attrs={"to": 1}),
            Node("Mul", [f"{p}_f", f"{p}_s"], [f"{p}_da"]),
            Node("Mul", [f"{p}_da", wsn], list(node.outputs),
                 node.name),
        ]
    gq = Graph(
        name=f"{graph.name}_w8a8",
        nodes=new_nodes,
        constants=consts,
        inputs=graph.inputs,
        outputs=list(graph.outputs),
        opset=graph.opset,
        weight_names=weights,
    )
    prune_dead(gq)
    return gq


def pack_int4_kv(kv: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize + nibble-pack a KV tensor into the int4 cache layout the
    gpt2 and llama decode graphs read (models/q4.py): per-head scale
    [..., H, 1, 1]-broadcastable, q = clip(round(kv / s), -8, 7) packed as
    p = (q0+8) + 16*q1 over hd pairs -> int8 [..., hd/2], on kv's device.
    The graphs' unpack inverts it: change them together."""
    q = torch.clamp(torch.round(kv / scale), -8, 7)
    return ((q[..., 0::2] + 8) + 16 * q[..., 1::2]).to(torch.int8)
