"""Helpers for the tests/test_torch_port_*.py files, which hold the PyTorch
port (onnx_rusty_inference_engine_tpu_torch) against the JAX package.

The two packages meet only here, through ONNX bytes and numpy arrays: a
model is built and serialized with the JAX package's codec, and parsed by
each package's own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine as TEngine
from onnx_rusty_inference_engine_tpu_torch.graph import (
    import_model as t_import)
from util import make_model, node


def to_port(model) -> "object":
    """A JAX-package ModelProto, serialized, parsed and imported by the port."""
    return t_import(t_io.parse_model(j_io.serialize_model(model)))


def run_op_port(op_type: str, inputs: Dict[str, np.ndarray],
                initializers: Optional[Dict[str, np.ndarray]] = None,
                opset: int = 13, n_outputs: int = 1,
                **attrs) -> List[np.ndarray]:
    """util.run_op's model, run by the port's Engine on the CPU."""
    out_names = [f"out{i}" for i in range(n_outputs)]
    n = node(op_type, list(inputs) + list(initializers or {}), out_names,
             **attrs)
    m = make_model([n], inputs, out_names, initializers, opset)
    res = TEngine(to_port(m), device="cpu").run(inputs)
    return [res.outputs[o] for o in out_names]


def _value_infos(vis) -> list:
    return [(v.name, v.elem_type, None if v.shape is None else list(v.shape))
            for v in vis]


def _subgraphs_equal(a, b) -> bool:
    """Two GraphProtos (attribute subgraphs), one of each package, equal:
    name, declared inputs and outputs, initializers, and every node with
    its attributes (nested subgraphs too)."""
    if not (a.name == b.name
            and _value_infos(a.inputs) == _value_infos(b.inputs)
            and _value_infos(a.outputs) == _value_infos(b.outputs)
            and sorted(a.initializers) == sorted(b.initializers)
            and all(values_equal(v, b.initializers[k])
                    for k, v in a.initializers.items())
            and len(a.nodes) == len(b.nodes)):
        return False
    for x, y in zip(a.nodes, b.nodes):
        if ((x.op_type, x.input, x.output, x.name, x.domain)
                != (y.op_type, y.input, y.output, y.name, y.domain)
                or sorted(x.attributes) != sorted(y.attributes)):
            return False
        for k, at in x.attributes.items():
            va, vb = at.value, y.attributes[k].value
            if isinstance(va, j_io.TensorData):
                va, vb = va.array, vb.array
            if not values_equal(va, vb):
                return False
    return True


def values_equal(a, b) -> bool:
    """Equality of attribute / constant values across the two packages."""
    if isinstance(a, j_io.GraphProto) and isinstance(b, t_io.GraphProto):
        return _subgraphs_equal(a, b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(values_equal(x, y)
                                        for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def assert_graphs_equal(jg, tg) -> None:
    """Node for node, constant for constant: the two packages' Graphs."""
    assert tg.name == jg.name
    assert tg.opset == jg.opset and tg.opsets == jg.opsets
    assert [(s.name, tuple(s.shape), np.dtype(s.dtype)) for s in tg.inputs] \
        == [(s.name, tuple(s.shape), np.dtype(s.dtype)) for s in jg.inputs]
    assert tg.outputs == jg.outputs
    assert tg.weight_names == jg.weight_names
    assert len(tg.nodes) == len(jg.nodes)
    for a, b in zip(jg.nodes, tg.nodes):
        assert (b.op_type, b.inputs, b.outputs, b.name, b.domain) == \
            (a.op_type, a.inputs, a.outputs, a.name, a.domain)
        assert sorted(b.attrs) == sorted(a.attrs), a.name
        for k in a.attrs:
            assert values_equal(a.attrs[k], b.attrs[k]), (a.name, k)
    assert sorted(tg.constants) == sorted(jg.constants)
    for k, v in jg.constants.items():
        assert values_equal(v, tg.constants[k]), k
