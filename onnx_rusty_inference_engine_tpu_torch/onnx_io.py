"""ONNX protobuf I/O: parse / serialize ModelProto and TensorProto.

The port's copy of onnx_rusty_inference_engine_tpu/onnx_io.py: a pure-Python
layer over the hand-rolled wire codec in utils/protowire.py that reads and
writes every tensor dtype the framework supports (fp32/fp16/bf16/int8/uint8/
int32/int64/bool/double/string), both `raw_data` and the typed repeated
fields.

One difference from the JAX package's copy: numpy has no bfloat16 and this
package does not use ml_dtypes, so a BFLOAT16 tensor decodes to a
`torch.bfloat16` tensor (its uint16 payload viewed as bf16), and such a
tensor encodes back to BFLOAT16. Every other dtype decodes to numpy.

Field numbers follow the public ONNX schema; this file is an independent
implementation of that spec.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .utils.protowire import WireReader, WireWriter

# --------------------------------------------------------------------------
# ONNX TensorProto.DataType enum (public spec constants)
# --------------------------------------------------------------------------
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16
INT4, UINT4 = 22, 21

DTYPE_TO_NUMPY = {
    FLOAT: np.dtype(np.float32),
    UINT8: np.dtype(np.uint8),
    INT8: np.dtype(np.int8),
    UINT16: np.dtype(np.uint16),
    INT16: np.dtype(np.int16),
    INT32: np.dtype(np.int32),
    INT64: np.dtype(np.int64),
    BOOL: np.dtype(np.bool_),
    FLOAT16: np.dtype(np.float16),
    DOUBLE: np.dtype(np.float64),
    UINT32: np.dtype(np.uint32),
    UINT64: np.dtype(np.uint64),
    # ONNX string tensors decode to numpy object arrays of Python str;
    # the codec treats them as first-class (no engine op takes them yet)
    STRING: np.dtype(object),
}
NUMPY_TO_DTYPE = {v: k for k, v in DTYPE_TO_NUMPY.items()}


class ModelParseError(ValueError):
    """A .onnx / .pb buffer could not be decoded (truncated, corrupt, or
    not ONNX at all). The ONLY exception the parse layer lets escape —
    the reference panics deep inside protobuf internals on bad input;
    callers here get one typed, catchable error with context instead
    (SURVEY.md §5 failure-detection row)."""


# every low-level failure mode observed from fuzzing the wire codec:
# numpy frombuffer/reshape (ValueError), varint-on-None (TypeError),
# slicing past the buffer (IndexError), bogus enum codes (KeyError /
# NotImplementedError), absurd varint dims (OverflowError, MemoryError)
_DECODE_ERRORS = (ValueError, TypeError, IndexError, KeyError,
                  OverflowError, MemoryError, NotImplementedError,
                  UnicodeDecodeError, struct.error)


def _parse_guard(what: str):
    """Decorator: translate any decode failure into ModelParseError."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except ModelParseError:
                raise
            except _DECODE_ERRORS as e:
                raise ModelParseError(
                    f"{what}: {type(e).__name__}: {e}") from e
        return wrapped
    return deco


# --------------------------------------------------------------------------
# Proto-level dataclasses (faithful subset of the ONNX message graph)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Attribute:
    name: str
    # exactly one of these is set
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional["TensorData"] = None
    g: Optional["GraphProto"] = None  # subgraph (If/Loop/Scan bodies)
    floats: Optional[List[float]] = None
    ints: Optional[List[int]] = None
    strings: Optional[List[bytes]] = None
    graphs: Optional[List["GraphProto"]] = None

    @property
    def value(self):
        for v in (self.f, self.i, self.s, self.t, self.g, self.floats,
                  self.ints, self.strings, self.graphs):
            if v is not None:
                return v
        return None


@dataclasses.dataclass
class NodeProto:
    op_type: str
    input: List[str]
    output: List[str]
    name: str = ""
    domain: str = ""
    attributes: Dict[str, Attribute] = dataclasses.field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return default if a is None else a.value


@dataclasses.dataclass
class TensorData:
    """Decoded TensorProto: name + numpy array."""

    name: str
    array: np.ndarray


@dataclasses.dataclass
class ValueInfo:
    name: str
    elem_type: Optional[int] = None
    shape: Optional[List[Union[int, str, None]]] = None  # str = symbolic dim_param


@dataclasses.dataclass
class GraphProto:
    name: str = ""
    nodes: List[NodeProto] = dataclasses.field(default_factory=list)
    initializers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    inputs: List[ValueInfo] = dataclasses.field(default_factory=list)
    outputs: List[ValueInfo] = dataclasses.field(default_factory=list)
    value_infos: List[ValueInfo] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelProto:
    graph: GraphProto
    ir_version: int = 8
    opset_version: int = 13  # the ai.onnx (default-domain) opset
    opset_domain: str = ""
    producer_name: str = ""
    producer_version: str = ""
    domain: str = ""
    model_version: int = 0
    # ALL opset_import entries, domain -> version (opset_import is
    # `repeated` in the schema — real ORT exports carry e.g.
    # {"": 17, "com.microsoft": 1}); opset_version above is always the
    # ai.onnx entry regardless of entry order.
    opset_imports: Dict[str, int] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# TensorProto decode / encode
# --------------------------------------------------------------------------
@_parse_guard("invalid TensorProto")
def parse_tensor_proto(buf: bytes, base_dir: Optional[str] = None
                       ) -> TensorData:
    dims: List[int] = []
    data_type = FLOAT
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int_data: List[int] = []
    double_data: List[float] = []
    str_data: List[bytes] = []
    external: Dict[str, str] = {}
    data_location = 0
    for field, wire, value in WireReader(buf):
        if field == 1:  # dims (repeated int64; may be packed or unpacked)
            if wire == 0:
                dims.append(WireReader.as_int64(value))
            else:
                dims.extend(WireReader.packed_varints(value))
        elif field == 2:
            data_type = int(value)  # type: ignore[arg-type]
        elif field == 4:  # float_data, packed
            b = bytes(value) if wire == 2 else bytes(value)
            float_data.extend(np.frombuffer(b, dtype="<f4").tolist())
        elif field in (5, 7):  # int32_data / int64_data
            if wire == 0:
                int_data.append(WireReader.as_int64(value))
            else:
                int_data.extend(WireReader.packed_varints(value))
        elif field == 6:  # string_data (repeated bytes)
            str_data.append(bytes(value))  # type: ignore[arg-type]
        elif field == 8:
            name = WireReader.as_string(value)
        elif field == 9:
            raw = bytes(value)  # type: ignore[arg-type]
        elif field == 10:  # double_data, packed
            double_data.extend(np.frombuffer(bytes(value), dtype="<f8").tolist())
        elif field == 13:  # external_data: StringStringEntryProto
            key = val = ""
            for f2, w2, v2 in WireReader(bytes(value)):
                if f2 == 1:
                    key = WireReader.as_string(v2)
                elif f2 == 2:
                    val = WireReader.as_string(v2)
            external[key] = val
        elif field == 14:
            data_location = int(value)

    np_dtype = (np.dtype(np.uint16) if data_type == BFLOAT16
                else DTYPE_TO_NUMPY.get(data_type))
    if np_dtype is None:
        raise NotImplementedError(f"TensorProto data_type {data_type} ({name!r})")
    shape = tuple(dims)
    if data_type == STRING:
        arr = np.empty(len(str_data), dtype=object)
        for i, b in enumerate(str_data):
            arr[i] = b.decode("utf-8", "surrogateescape")
        return TensorData(name=name, array=arr.reshape(shape))
    n_declared = 1
    for d in dims:
        n_declared *= max(d, 1)
    if any(d < 0 for d in dims) or n_declared > (1 << 40):
        # corrupt varint dims would otherwise drive a giant allocation in
        # the zero-fill path below before anything validates them
        raise ValueError(f"implausible tensor dims {shape} ({name!r})")
    if data_location == 1 or external:  # EXTERNAL: weights in sidecar files
        import os

        loc = external.get("location")
        if loc is None:
            raise ValueError(f"external tensor {name!r} has no location")
        # The .onnx file is untrusted input: reject absolute locations and
        # '../' escapes so a hostile model can't read arbitrary host files
        # into graph constants (path traversal).
        root = os.path.realpath(base_dir or ".")
        path = os.path.realpath(os.path.join(root, loc))
        if os.path.isabs(loc) or not (
                path == root or path.startswith(root + os.sep)):
            raise ValueError(
                f"external tensor {name!r}: location {loc!r} escapes the "
                f"model directory")
        offset = int(external.get("offset", 0))
        length = external.get("length")
        with open(path, "rb") as f:
            f.seek(offset)
            raw = f.read(int(length) if length is not None else -1)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype.newbyteorder("<")).astype(np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype)
    elif int_data and data_type in (FLOAT16, BFLOAT16):
        # int32_data carries half-precision values as uint16 bit patterns
        arr = np.asarray(int_data, dtype=np.int64).astype(np.uint16
                                                          ).view(np_dtype)
    elif int_data:
        arr = np.asarray(int_data, dtype=np_dtype)
    else:
        arr = np.zeros(shape, dtype=np_dtype)
    if data_type == BFLOAT16:  # arr holds the bf16 bit patterns
        return TensorData(name=name, array=_bf16_tensor(arr.reshape(shape)))
    return TensorData(name=name, array=arr.reshape(shape))


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> torch.bfloat16 tensor of the same shape."""
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()
                            ).view(torch.bfloat16)


def encode_tensor_proto(name: str, array: np.ndarray) -> bytes:
    if isinstance(array, torch.Tensor) and array.dtype == torch.bfloat16:
        w = WireWriter()
        w.packed_varints(1, list(array.shape))
        w.varint(2, BFLOAT16)
        w.string(8, name)
        w.bytes_field(9, array.cpu().contiguous().view(torch.int16).numpy()
                      .astype("<i2").tobytes())
        return w.getvalue()
    if array.dtype == object or array.dtype.kind == "U":
        w = WireWriter()
        w.packed_varints(1, list(array.shape))
        w.varint(2, STRING)
        for s in array.ravel():
            w.bytes_field(6, str(s).encode("utf-8", "surrogateescape"))
        w.string(8, name)
        return w.getvalue()
    dtype = NUMPY_TO_DTYPE.get(array.dtype)
    if dtype is None:
        raise NotImplementedError(f"cannot encode numpy dtype {array.dtype}")
    w = WireWriter()
    w.packed_varints(1, list(array.shape))
    w.varint(2, dtype)
    w.string(8, name)
    w.bytes_field(9, np.ascontiguousarray(array).astype(array.dtype, copy=False).tobytes())
    return w.getvalue()


def read_tensor_file(path: str) -> TensorData:
    """Read a serialized TensorProto .pb file (the bundled golden I/O pairs)."""
    with open(path, "rb") as f:
        try:
            return parse_tensor_proto(f.read())
        except ModelParseError as e:
            raise ModelParseError(f"{path}: {e}") from e


def write_tensor_file(path: str, name: str, array: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_tensor_proto(name, array))


# --------------------------------------------------------------------------
# Attribute / Node / ValueInfo / Graph / Model decode
# --------------------------------------------------------------------------
# AttributeProto.AttributeType constants
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR, _ATTR_GRAPH = 1, 2, 3, 4, 5
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS, _ATTR_GRAPHS = 6, 7, 8, 10


def _parse_attribute(buf: bytes, base_dir: Optional[str] = None) -> Attribute:
    a = Attribute(name="")
    for field, wire, value in WireReader(buf):
        if field == 1:
            a.name = WireReader.as_string(value)
        elif field == 2:
            a.f = WireReader.as_float32(value)
        elif field == 3:
            a.i = WireReader.as_int64(value)
        elif field == 4:
            a.s = bytes(value)  # type: ignore[arg-type]
        elif field == 5:
            a.t = parse_tensor_proto(bytes(value), base_dir)  # type: ignore[arg-type]
        elif field == 6:
            a.g = _parse_graph(bytes(value), base_dir)  # type: ignore[arg-type]
        elif field == 11:
            a.graphs = (a.graphs or [])
            a.graphs.append(
                _parse_graph(bytes(value), base_dir))  # type: ignore[arg-type]
        elif field == 7:
            a.floats = (a.floats or [])
            a.floats.extend(
                np.frombuffer(bytes(value), dtype="<f4").tolist()
                if wire == 2
                else [WireReader.as_float32(value)]
            )
        elif field == 8:
            a.ints = (a.ints or [])
            if wire == 0:
                a.ints.append(WireReader.as_int64(value))
            else:
                a.ints.extend(WireReader.packed_varints(value))
        elif field == 9:
            a.strings = (a.strings or [])
            a.strings.append(bytes(value))  # type: ignore[arg-type]
        # field 20 (type) is redundant with which member is set; ignored.
    return a


def _parse_node(buf: bytes, base_dir: Optional[str] = None) -> NodeProto:
    n = NodeProto(op_type="", input=[], output=[])
    for field, wire, value in WireReader(buf):
        if field == 1:
            n.input.append(WireReader.as_string(value))
        elif field == 2:
            n.output.append(WireReader.as_string(value))
        elif field == 3:
            n.name = WireReader.as_string(value)
        elif field == 4:
            n.op_type = WireReader.as_string(value)
        elif field == 5:
            a = _parse_attribute(bytes(value), base_dir)  # type: ignore[arg-type]
            n.attributes[a.name] = a
        elif field == 7:
            n.domain = WireReader.as_string(value)
    return n


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo(name="")
    for field, wire, value in WireReader(buf):
        if field == 1:
            vi.name = WireReader.as_string(value)
        elif field == 2:  # TypeProto
            for f2, w2, v2 in WireReader(bytes(value)):  # type: ignore[arg-type]
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in WireReader(bytes(v2)):  # type: ignore[arg-type]
                        if f3 == 1:
                            vi.elem_type = int(v3)  # type: ignore[arg-type]
                        elif f3 == 2:  # TensorShapeProto
                            dims: List[Union[int, str, None]] = []
                            for f4, w4, v4 in WireReader(bytes(v3)):  # type: ignore[arg-type]
                                if f4 == 1:  # Dimension
                                    dim: Union[int, str, None] = None
                                    for f5, w5, v5 in WireReader(bytes(v4)):  # type: ignore[arg-type]
                                        if f5 == 1:
                                            dim = WireReader.as_int64(v5)
                                        elif f5 == 2:
                                            dim = WireReader.as_string(v5)
                                    dims.append(dim)
                            vi.shape = dims
    return vi


def _parse_graph(buf: bytes, base_dir: Optional[str] = None) -> GraphProto:
    g = GraphProto()
    for field, wire, value in WireReader(buf):
        if field == 1:
            g.nodes.append(
                _parse_node(bytes(value), base_dir))  # type: ignore[arg-type]
        elif field == 2:
            g.name = WireReader.as_string(value)
        elif field == 5:
            t = parse_tensor_proto(bytes(value), base_dir)  # type: ignore[arg-type]
            g.initializers[t.name] = t.array
        elif field == 11:
            g.inputs.append(_parse_value_info(bytes(value)))  # type: ignore[arg-type]
        elif field == 12:
            g.outputs.append(_parse_value_info(bytes(value)))  # type: ignore[arg-type]
        elif field == 13:
            g.value_infos.append(_parse_value_info(bytes(value)))  # type: ignore[arg-type]
    return g


@_parse_guard("invalid ONNX ModelProto")
def parse_model(buf: bytes, base_dir: Optional[str] = None) -> ModelProto:
    graph: Optional[GraphProto] = None
    m_kwargs: Dict[str, object] = {}
    for field, wire, value in WireReader(buf):
        if field == 1:
            m_kwargs["ir_version"] = WireReader.as_int64(value)
        elif field == 2:
            m_kwargs["producer_name"] = WireReader.as_string(value)
        elif field == 3:
            m_kwargs["producer_version"] = WireReader.as_string(value)
        elif field == 4:
            m_kwargs["domain"] = WireReader.as_string(value)
        elif field == 5:
            m_kwargs["model_version"] = WireReader.as_int64(value)
        elif field == 7:
            graph = _parse_graph(bytes(value), base_dir)  # type: ignore[arg-type]
        elif field == 8:  # opset_import (repeated OperatorSetIdProto)
            dom, ver = "", None
            for f2, w2, v2 in WireReader(bytes(value)):  # type: ignore[arg-type]
                if f2 == 1:
                    dom = WireReader.as_string(v2)
                elif f2 == 2:
                    ver = WireReader.as_int64(v2)
            if ver is not None:
                m_kwargs.setdefault("opset_imports", {})[dom] = ver
    if graph is None:
        raise ValueError("ModelProto has no graph")
    imports = m_kwargs.get("opset_imports", {})
    # the ai.onnx entry (domain "" or the alias "ai.onnx") drives all
    # opset-conditional op semantics; contrib entries never overwrite it
    ai_ver = imports.get("", imports.get("ai.onnx"))
    if ai_ver is not None:
        m_kwargs["opset_version"] = ai_ver
    elif imports:  # no default-domain entry at all: keep the dataclass
        pass       # default (13) rather than a contrib domain's version
    return ModelProto(graph=graph, **m_kwargs)  # type: ignore[arg-type]


def load_model(path: str) -> ModelProto:
    import os

    with open(path, "rb") as f:
        try:
            return parse_model(f.read(), base_dir=os.path.dirname(
                os.path.abspath(path)))
        except ModelParseError as e:
            raise ModelParseError(f"{path}: {e}") from e


# --------------------------------------------------------------------------
# Encode (for synthesizing models)
# --------------------------------------------------------------------------
def _encode_attribute(a: Attribute) -> bytes:
    w = WireWriter()
    w.string(1, a.name)
    if a.f is not None:
        w.float32(2, a.f).varint(20, _ATTR_FLOAT)
    elif a.i is not None:
        w.varint(3, a.i).varint(20, _ATTR_INT)
    elif a.s is not None:
        w.bytes_field(4, a.s).varint(20, _ATTR_STRING)
    elif a.t is not None:
        w.bytes_field(5, encode_tensor_proto(a.t.name, a.t.array)).varint(20, _ATTR_TENSOR)
    elif a.g is not None:
        w.bytes_field(6, _encode_graph(a.g)).varint(20, _ATTR_GRAPH)
    elif a.graphs is not None:
        for sub in a.graphs:
            w.bytes_field(11, _encode_graph(sub))
        w.varint(20, _ATTR_GRAPHS)
    elif a.floats is not None:
        payload = np.asarray(a.floats, dtype="<f4").tobytes()
        w.bytes_field(7, payload).varint(20, _ATTR_FLOATS)
    elif a.ints is not None:
        w.packed_varints(8, a.ints).varint(20, _ATTR_INTS)
    elif a.strings is not None:
        for s in a.strings:
            w.bytes_field(9, s)
        w.varint(20, _ATTR_STRINGS)
    return w.getvalue()


def _encode_node(n: NodeProto) -> bytes:
    w = WireWriter()
    for s in n.input:
        w.string(1, s)
    for s in n.output:
        w.string(2, s)
    if n.name:
        w.string(3, n.name)
    w.string(4, n.op_type)
    for a in n.attributes.values():
        w.bytes_field(5, _encode_attribute(a))
    if n.domain:
        w.string(7, n.domain)
    return w.getvalue()


def _encode_value_info(vi: ValueInfo) -> bytes:
    shape_w = WireWriter()
    for d in vi.shape or []:
        dim_w = WireWriter()
        if isinstance(d, int):
            dim_w.varint(1, d)
        elif isinstance(d, str):
            dim_w.string(2, d)
        shape_w.bytes_field(1, dim_w.getvalue())
    tt = WireWriter()
    tt.varint(1, vi.elem_type or FLOAT)
    tt.bytes_field(2, shape_w.getvalue())
    tp = WireWriter()
    tp.bytes_field(1, tt.getvalue())
    w = WireWriter()
    w.string(1, vi.name)
    w.bytes_field(2, tp.getvalue())
    return w.getvalue()


def _encode_graph(g: GraphProto) -> bytes:
    w = WireWriter()
    for n in g.nodes:
        w.bytes_field(1, _encode_node(n))
    if g.name:
        w.string(2, g.name)
    for name, arr in g.initializers.items():
        w.bytes_field(5, encode_tensor_proto(name, arr))
    for vi in g.inputs:
        w.bytes_field(11, _encode_value_info(vi))
    for vi in g.outputs:
        w.bytes_field(12, _encode_value_info(vi))
    for vi in g.value_infos:
        w.bytes_field(13, _encode_value_info(vi))
    return w.getvalue()


def serialize_model(m: ModelProto) -> bytes:
    w = WireWriter()
    w.varint(1, m.ir_version)
    if m.producer_name:
        w.string(2, m.producer_name)
    if m.producer_version:
        w.string(3, m.producer_version)
    if m.domain:
        w.string(4, m.domain)
    if m.model_version:
        w.varint(5, m.model_version)
    w.bytes_field(7, _encode_graph(m.graph))
    imports = dict(m.opset_imports) if m.opset_imports else {}
    imports.setdefault(m.opset_domain, m.opset_version)
    for dom, ver in imports.items():
        op = WireWriter()
        if dom:
            op.string(1, dom)
        op.varint(2, ver)
        w.bytes_field(8, op.getvalue())
    return w.getvalue()


def save_model(path: str, m: ModelProto) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model(m))
