"""ONNX Runtime's dynamically quantized form of a float CNN, for the port's
tests and chip_smoke.py: the file `onnxruntime.quantization.
quantize_dynamic(weight_type=QInt8)` writes for a conv net, built here
(onnxruntime is not a dependency of either package).

What ORT writes for each Conv, and this builds:
- DynamicQuantizeLinear on the conv's input (one per input tensor, shared
  by the convs that read it): uint8 x, its f32 scale and its uint8 zero
  point, computed at run time from the tensor's range;
- the weight int8, symmetric, per tensor: scale max|w| / 127, zero point 0;
- ConvInteger(x_q, w_q, x_zero_point, w_zero_point) -> int32, Cast to
  float, Mul by x_scale * w_scale (a Mul of the two scales), Add of the
  float bias (shaped [C, 1, 1] to broadcast over the output).
Everything else (Relu, MaxPool, Concat, the head) stays float. A trailing
Softmax that produces the graph's output is dropped, as
torch_port_qoperator.py drops it: the file is written at opset 13, where
SqueezeNet's 4-D Softmax would run over its last axis, of size 1; the
logits end the graph.

It imports the port only, never JAX; the file is ONNX bytes
(`graph.export_model`, `onnx_io.serialize_model`) that both packages parse.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.graph import (Graph, Node,
                                                         export_model,
                                                         import_model)

__all__ = ["dynamic_graph", "dynamic_bytes"]

_FLOAT = 1  # onnx TensorProto.FLOAT


def dynamic_graph(g: Graph) -> Graph:
    """`g` with every Conv (a constant weight) in ORT's dynamic form."""
    consts = dict(g.constants)
    nodes: List[Node] = []
    outputs = list(g.outputs)
    body = list(g.nodes)
    if body and body[-1].op_type == "Softmax" and body[-1].outputs == outputs:
        outputs = [body[-1].inputs[0]]
        body = body[:-1]
    quantized: Dict[str, tuple] = {}  # conv input -> (x_q, x_s, x_zp)
    for n in body:
        w = consts.get(n.inputs[1]) if n.op_type == "Conv" else None
        if w is None:
            nodes.append(n)
            continue
        x = n.inputs[0]
        if x not in quantized:
            quantized[x] = (f"{x}_quantized", f"{x}_scale",
                            f"{x}_zero_point")
            nodes.append(Node("DynamicQuantizeLinear", [x],
                              list(quantized[x]), f"{x}_QuantizeLinear"))
        x_q, x_s, x_zp = quantized[x]
        wname = n.inputs[1]
        scale = np.float32(max(float(np.abs(w).max()), 1e-8) / 127.0)
        consts[f"{wname}_quantized"] = np.clip(
            np.round(w / scale), -127, 127).astype(np.int8)
        consts[f"{wname}_scale"] = scale
        consts[f"{wname}_zero_point"] = np.int8(0)
        name = n.name or n.outputs[0]
        acc = f"{n.outputs[0]}_output_quantized"
        attrs = {k: v for k, v in n.attrs.items() if not k.startswith("__")}
        nodes.append(Node("ConvInteger",
                          [x_q, f"{wname}_quantized", x_zp,
                           f"{wname}_zero_point"], [acc], f"{name}_quant",
                          attrs))
        nodes.append(Node("Cast", [acc], [f"{acc}_cast_output"],
                          f"{acc}_cast", {"to": _FLOAT}))
        nodes.append(Node("Mul", [x_s, f"{wname}_scale"],
                          [f"{name}_quant_scales_mul:0"],
                          f"{name}_quant_scales_mul"))
        has_bias = len(n.inputs) > 2 and n.inputs[2] in consts
        mul_out = f"{n.outputs[0]}_scaled" if has_bias else n.outputs[0]
        nodes.append(Node("Mul", [f"{acc}_cast_output",
                                  f"{name}_quant_scales_mul:0"], [mul_out],
                          f"{name}_quant_output_scale_mul"))
        if has_bias:
            b = np.asarray(consts[n.inputs[2]], np.float32)
            bname = f"{n.inputs[2]}_reshaped"
            consts[bname] = b.reshape((-1,) + (1,) * (w.ndim - 2))
            nodes.append(Node("Add", [mul_out, bname], [n.outputs[0]],
                              f"{name}_bias_add"))
    out = Graph(name=f"{g.name}_dynamic", nodes=nodes, constants=consts,
                inputs=list(g.inputs), outputs=outputs,
                opset=max(g.opset, 11), opsets=dict(g.opsets),
                weight_names=list(g.weight_names))
    used = {i for m in nodes for i in m.inputs}
    out.constants = {k: v for k, v in consts.items() if k in used}
    out.weight_names = [k for k in out.constants
                        if isinstance(out.constants[k], np.ndarray)
                        and out.constants[k].ndim > 0]
    return out


def dynamic_bytes(g: Graph) -> bytes:
    """`dynamic_graph(g)` as an ONNX file."""
    return onnx_io.serialize_model(export_model(dynamic_graph(g)))


def reparsed(data: bytes) -> Graph:
    """The port's import of a file's bytes (the Engine's input)."""
    return import_model(onnx_io.parse_model(data))
