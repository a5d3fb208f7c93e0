"""ONNX Runtime's QOperator INT8 form of a float CNN, for the port's tests
and chip_smoke.py: the file `onnxruntime.quantization.quantize_static(
quant_format=QOperator, per_channel=True, weight_type=QInt8,
activation_type=QUInt8 or QInt8)` writes, built here from calibrated
ranges (onnxruntime is not a dependency of either package).

What ORT writes, and this builds:
- activations per tensor and asymmetric: rmin = min(lo, 0), rmax = max(hi,
  0), scale = (rmax - rmin) / 255, zero point round(qmin - rmin / scale)
  (qmin 0 for QUInt8, -128 for QInt8: the QInt8 file is the QUInt8 one with
  every zero point less 128, its int8 twin);
- weights int8, symmetric, per output channel (per column for Gemm):
  scale amax / 127; biases int32 round(b / (x_s * w_s));
- Conv -> QLinearConv, with a following Relu or Clip folded into its output
  range; Concat -> QLinearConcat; GlobalAveragePool ->
  QLinearGlobalAveragePool; Add -> QLinearAdd; Gemm -> QGemm; MaxPool,
  Flatten, Reshape, Dropout run on the quantized tensor; a QuantizeLinear
  at the input and a DequantizeLinear at the logits, which end the graph
  (the trailing Softmax is dropped: at opset 13 SqueezeNet's 4-D Softmax
  would run over its last axis, of size 1).

It imports torch and the port, never JAX; the file is ONNX bytes
(`graph.export_model`, `onnx_io.serialize_model`) that both packages parse.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.graph import (Graph, Node,
                                                         export_model,
                                                         import_model,
                                                         prune_dead)

__all__ = ["qoperator_graph", "qoperator_bytes", "int8_twin", "QMIN",
           "LOGITS"]

# activation type -> (numpy dtype, qmin)
QMIN = {"uint8": (np.uint8, 0), "int8": (np.int8, -128)}

# the float graph's logits, where the QOperator graph ends, by graph name
LOGITS = {"squeezenet1.0": "pool10_1", "mobilenetv2-1.0": "logits"}

_PASS = ("MaxPool", "Flatten", "Reshape", "Dropout", "Identity")


def _act_params(lo: float, hi: float, activation: str):
    """ORT's asymmetric per-tensor (scale, zero point) of a range."""
    dtype, qmin = QMIN[activation]
    rmin, rmax = min(float(lo), 0.0), max(float(hi), 0.0)
    if rmin == rmax:
        return np.float32(1.0), dtype(qmin)
    scale = np.float32((rmax - rmin) / 255.0)
    zp = int(np.round(qmin - rmin / float(scale)))
    return scale, dtype(np.clip(zp, qmin, qmin + 255))


def _weight(w: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 per channel along `axis`: (q, scales)."""
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(np.max(np.abs(w), axis=red), 1e-8)
    scale = (amax / 127.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127)
    return q.astype(np.int8), scale


def qoperator_graph(graph: Graph, ranges: Dict[str, Tuple[float, float]],
                    activation: str = "uint8") -> Graph:
    """The QOperator form of a float CNN Graph (SqueezeNet, MobileNetV2),
    from `ranges` (quant.calibrate's, on the float graph), ending at its
    logits (LOGITS) dequantized to f32."""
    dtype, _ = QMIN[activation]
    logits = LOGITS[graph.name]
    consts = dict(graph.constants)
    weights: List[str] = []
    consumers: Dict[str, List[Node]] = {}
    for n in graph.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)
    # a Conv whose one consumer is a Relu or Clip takes that node's range,
    # and its output stands for the activation's (ORT fuses them first)
    alias: Dict[str, str] = {}
    for n in graph.nodes:
        if n.op_type == "Conv":
            (y,) = n.outputs
            nxt = consumers.get(y, [])
            if len(nxt) == 1 and nxt[0].op_type in ("Relu", "Clip"):
                alias[nxt[0].outputs[0]] = y
    q: Dict[str, Tuple[str, str, str]] = {}  # float name -> (q, s, zp)
    nodes: List[Node] = []

    def const(name: str, v, weight: bool = False) -> str:
        consts[name] = np.asarray(v)
        if weight:
            weights.append(name)
        return name

    def params(name: str) -> Tuple[str, str]:
        s, zp = _act_params(*ranges[name], activation)
        return const(f"{name}__s", s), const(f"{name}__zp", zp)

    def quantized(name: str) -> Tuple[str, str, str]:
        if name not in q:  # a float input: QuantizeLinear
            s, zp = params(name)
            out = f"{name}__q"
            nodes.append(Node("QuantizeLinear", [name, s, zp], [out],
                              name=f"quant_{name}"))
            q[name] = (out, s, zp)
        return q[name]

    def scale_of(s: str) -> float:
        return float(np.asarray(consts[s]).reshape(-1)[0])

    for n in graph.nodes:
        op, name = n.op_type, n.name
        if op in ("Relu", "Clip") and n.outputs[0] in alias:
            q[n.outputs[0]] = q[alias[n.outputs[0]]]
            continue
        if op == "Conv" or op == "Gemm":
            x, w_name = n.inputs[0], n.inputs[1]
            xq, xs, xzp = quantized(x)
            y = n.outputs[0]
            rng_name = next((a for a, c in alias.items() if c == y), y)
            ys, yzp = params(rng_name)
            w = consts[w_name]
            trans = op == "Gemm" and int(n.attr("transB", 0))
            wq, ws = _weight(w, 0 if op == "Conv" or trans else 1)
            inputs = [xq, xs, xzp, const(f"{w_name}__q", wq, True),
                      const(f"{w_name}__ws", ws),
                      const(f"{w_name}__wzp", np.zeros(ws.shape, np.int8))]
            b = (consts.get(n.inputs[2]) if len(n.inputs) > 2 and n.inputs[2]
                 else None)
            b32 = None
            if b is not None:
                b32 = const(f"{n.inputs[2]}__b32", np.round(
                    b / (scale_of(xs) * ws)).astype(np.int32), True)
            yq = f"{y}__q"
            if op == "Conv":
                nodes.append(Node("QLinearConv", inputs + [ys, yzp]
                                  + ([b32] if b32 else []), [yq], name,
                                  dict(n.attrs)))
            else:
                attrs = {k: v for k, v in n.attrs.items()
                         if k in ("transA", "transB", "alpha")}
                nodes.append(Node("QGemm", inputs + [b32 or "", ys, yzp],
                                  [yq], name, attrs, "com.microsoft"))
            q[y] = (yq, ys, yzp)
        elif op in _PASS and n.inputs[0] in q:
            xq, xs, xzp = q[n.inputs[0]]
            yq = f"{n.outputs[0]}__q"
            nodes.append(Node(op, [xq] + list(n.inputs[1:]), [yq], name,
                              dict(n.attrs)))
            q[n.outputs[0]] = (yq, xs, xzp)
        elif op == "Concat":
            ys, yzp = params(n.outputs[0])
            ins = [ys, yzp]
            for i in n.inputs:
                ins += list(quantized(i))
            yq = f"{n.outputs[0]}__q"
            nodes.append(Node("QLinearConcat", ins, [yq], name,
                              dict(n.attrs), "com.microsoft"))
            q[n.outputs[0]] = (yq, ys, yzp)
        elif op in ("GlobalAveragePool", "Add"):
            ys, yzp = params(n.outputs[0])
            ins = [v for i in n.inputs for v in quantized(i)]
            yq = f"{n.outputs[0]}__q"
            qop = ("QLinearGlobalAveragePool" if op == "GlobalAveragePool"
                   else "QLinearAdd")
            attrs = {"channels_last": 0} if op == "GlobalAveragePool" else {}
            nodes.append(Node(qop, ins + [ys, yzp], [yq], name, attrs,
                              "com.microsoft"))
            q[n.outputs[0]] = (yq, ys, yzp)
        else:
            raise ValueError(f"qoperator_graph: no QOperator rule for {op} "
                             f"({name})")
        if logits in q:
            break
    yq, ys, yzp = q[logits]
    nodes.append(Node("DequantizeLinear", [yq, ys, yzp], [logits],
                      name=f"dequant_{logits}"))
    out = Graph(name=f"{graph.name}_qoperator_{activation}", nodes=nodes,
                constants=consts, inputs=graph.inputs, outputs=[logits],
                opset=13, opsets={"": 13, "com.microsoft": 1},
                weight_names=[w for w in graph.weight_names if w in consts]
                + weights)
    prune_dead(out)
    return out


def int8_twin(graph: Graph) -> Graph:
    """A QUInt8 graph's int8 twin: every uint8 constant (its zero points)
    less 128 as int8. Each QOperator op dequantizes (x - zp) and requantizes
    (+ zp), so the twin's values are the uint8 graph's less 128."""
    consts = {k: ((v.astype(np.int16) - 128).astype(np.int8)
                  if np.asarray(v).dtype == np.uint8 else v)
              for k, v in graph.constants.items()}
    return Graph(name=f"{graph.name}_twin", nodes=graph.nodes,
                 constants=consts, inputs=graph.inputs,
                 outputs=graph.outputs, opset=graph.opset,
                 opsets=dict(graph.opsets),
                 weight_names=list(graph.weight_names))


def qoperator_bytes(graph: Graph) -> bytes:
    """The graph as an ONNX file's bytes."""
    return onnx_io.serialize_model(export_model(graph))


def reparsed(graph: Graph) -> Graph:
    """The graph through its ONNX bytes and the port's parser, as a user's
    file arrives."""
    return import_model(onnx_io.parse_model(qoperator_bytes(graph)))
