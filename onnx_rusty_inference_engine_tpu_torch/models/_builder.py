"""Small helper DSL for constructing ONNX GraphProtos programmatically,
and `host_memo`, which lets many builds of one large model share their
host arrays."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np

from .. import onnx_io


_memo: Optional[Dict[Hashable, object]] = None


@contextlib.contextmanager
def host_memo():
    """Within the block, each seeded weight a builder draws through `memo`
    (models/llama.py) and each int4 packing of one weight array
    (quant.quantize_weights_int4) is made once and reused: the prefill and
    decode graphs of one config and seed, a server's prompt buckets and KV
    variants then share their host arrays instead of drawing and packing
    them again. For a process that builds many graphs of one large config;
    the arrays are held until the block ends. Nested blocks share the
    outer one's entries."""
    global _memo
    outer = _memo
    _memo = {} if outer is None else outer
    try:
        yield
    finally:
        _memo = outer


def memo(key: Hashable, make: Callable[[], object]):
    """make(), or inside `host_memo` the value made first under `key`."""
    if _memo is None:
        return make()
    value = _memo.get(key)
    if value is None:
        value = _memo[key] = make()
    return value


def stacked(key: Hashable, parts: Sequence[np.ndarray]) -> np.ndarray:
    """np.stack(parts): a scan-over-layers graph's stacked per-layer
    weights. Inside `host_memo` the stack made first under `key`, which
    also remembers its parts (`stack_parts`), so that the int4 quantizer
    packs each layer once for both decode forms."""
    arr = memo(key, lambda: np.stack(parts))
    if _memo is not None:
        _memo.setdefault(("stack_parts", id(arr)), (arr, list(parts)))
    return arr


def stack_parts(arr: np.ndarray) -> Optional[List[np.ndarray]]:
    """The per-layer arrays `stacked` made `arr` from, inside the
    `host_memo` block it was made in; else None."""
    hit = None if _memo is None else _memo.get(("stack_parts", id(arr)))
    return None if hit is None else hit[1]


class GraphBuilder:
    def __init__(self, name: str, opset: int = 13, seed: int = 0):
        self.g = onnx_io.GraphProto(name=name)
        self.opset = opset
        self.rng = np.random.default_rng(seed)
        self._counter = 0

    # -- naming ---------------------------------------------------------
    def fresh(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}_{self._counter}"

    # -- declarations -----------------------------------------------------
    def input(self, name: str, shape: Sequence[int], dtype=np.float32) -> str:
        self.g.inputs.append(onnx_io.ValueInfo(
            name=name, elem_type=onnx_io.NUMPY_TO_DTYPE[np.dtype(dtype)],
            shape=list(shape)))
        return name

    def output(self, name: str, shape: Optional[Sequence[int]] = None,
               dtype=np.float32) -> str:
        self.g.outputs.append(onnx_io.ValueInfo(
            name=name, elem_type=onnx_io.NUMPY_TO_DTYPE[np.dtype(dtype)],
            shape=list(shape) if shape is not None else None))
        return name

    def init(self, name: str, array: np.ndarray) -> str:
        self.g.initializers[name] = array
        return name

    def he(self, name: str, shape: Sequence[int], fan_in: Optional[int] = None
           ) -> str:
        fan = fan_in or int(np.prod(shape[1:]))
        arr = (self.rng.standard_normal(shape) * np.sqrt(2.0 / fan)).astype(np.float32)
        return self.init(name, arr)

    def zeros(self, name: str, shape: Sequence[int]) -> str:
        return self.init(name, np.zeros(shape, dtype=np.float32))

    # -- nodes ------------------------------------------------------------
    def node(self, op_type: str, inputs: Sequence[str],
             outputs: Optional[Sequence[str]] = None, name: str = "",
             domain: str = "", **attrs) -> List[str]:
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        n = onnx_io.NodeProto(op_type=op_type, input=list(inputs),
                              output=list(outputs), name=name,
                              domain=domain)
        for k, v in attrs.items():
            n.attributes[k] = _attr(k, v)
        self.g.nodes.append(n)
        return list(outputs)

    def op(self, op_type: str, *inputs: str, **attrs) -> str:
        return self.node(op_type, inputs, **attrs)[0]

    # -- finish -------------------------------------------------------------
    def model(self, producer: str = "oriet-synth") -> onnx_io.ModelProto:
        return onnx_io.ModelProto(graph=self.g, ir_version=7,
                                  opset_version=self.opset,
                                  producer_name=producer)


def _attr(name: str, value) -> onnx_io.Attribute:
    a = onnx_io.Attribute(name=name)
    if isinstance(value, bool):
        a.i = int(value)
    elif isinstance(value, int):
        a.i = value
    elif isinstance(value, float):
        a.f = value
    elif isinstance(value, str):
        a.s = value.encode()
    elif isinstance(value, np.ndarray):
        a.t = onnx_io.TensorData(name="", array=value)
    elif isinstance(value, onnx_io.GraphProto):
        a.g = value
    elif isinstance(value, (list, tuple)) and value and \
            isinstance(value[0], onnx_io.GraphProto):
        a.graphs = list(value)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            a.ints = list(value)
        elif all(isinstance(v, float) for v in value):
            a.floats = [float(v) for v in value]
        else:
            a.strings = [v.encode() for v in value]
    else:
        raise TypeError(f"attribute {name}: unsupported type {type(value)}")
    return a
