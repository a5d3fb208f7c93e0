"""ctypes bridge to the native C++ ONNX parser (native/onnx_loader.cc).

The port's counterpart of onnx_rusty_inference_engine_tpu/native_loader.py,
with the same names and results: `get_lib`, `load_model_native` (an
`onnx_io.ModelProto`, or None where the parser cannot decode a tensor and
the caller falls back to the pure-Python codec) and `read_tensor_native`.
`graph.import_onnx` prefers it.

The library is built at first use with `g++ -O2 -std=c++17 -fPIC -shared`
(the flags of the JAX package's native/Makefile) into `build/native/` beside
the package, or into `$ORIET_COMPILE_CACHE/native` where that variable names
a directory, in a directory keyed by a hash of the source and the flags (as
ops/kernels/_build.py keys the CUDA kernels): an edited source rebuilds, an
unchanged one is reused, and nothing is written into the package.
`ORIET_NATIVE=0` turns the parser off. Where the library cannot be built or
loaded, the pure-Python codec parses instead, after one warning that
carries the compiler's or the loader's error.

One difference from the JAX package's bridge: numpy has no bfloat16 here,
so a BFLOAT16 initializer or tensor decodes to a `torch.bfloat16` tensor, as
the port's `onnx_io` decodes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from typing import List, Optional, Union

import numpy as np

from . import onnx_io

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
SOURCE = os.path.join(_DIR, "onnx_loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "native")
CACHE_ENV = "ORIET_COMPILE_CACHE"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def build_dir() -> str:
    """Where the library goes: `$ORIET_COMPILE_CACHE/native`, else
    BUILD_DIR."""
    cache = os.environ.get(CACHE_ENV)
    return os.path.join(cache, "native") if cache else BUILD_DIR


def library_path() -> str:
    """The library built from this source with these flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(), f"onnx_loader-{h.hexdigest()[:16]}",
                        "libonnx_loader.so")


def _build(so: str) -> Optional[str]:
    """Compile the library into `so`; None, or why it failed."""
    cxx = os.environ.get("CXX", "g++")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{cxx}: {e}"
    if proc.returncode != 0:
        return f"{cxx} exited {proc.returncode}: {proc.stderr.strip()}"
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded parser, built first if needed; None where ORIET_NATIVE=0
    or where it cannot be built or loaded (warned once)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("ORIET_NATIVE", "1") == "0":
        return None
    so = library_path()
    err = None if os.path.exists(so) else _build(so)
    if err is None:
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # a library another host built into a shared cache: build it
            # here again, once
            err = _build(so)
            if err is None:
                try:
                    lib = ctypes.CDLL(so)
                except OSError as e:
                    err = f"loading {so}: {e}"
    if err is not None:
        warnings.warn(f"the native ONNX parser is unavailable, the "
                      f"pure-Python codec parses instead: {err}",
                      RuntimeWarning, stacklevel=2)
        return None

    c_void_p, c_size_t = ctypes.c_void_p, ctypes.c_size_t
    c_char_p = ctypes.c_char_p
    sig = {
        "oriet_parse_model": (c_void_p, [ctypes.c_char_p, c_size_t]),
        "oriet_free_model": (None, [c_void_p]),
        "oriet_error": (c_char_p, [c_void_p]),
        "oriet_ir_version": (ctypes.c_int64, [c_void_p]),
        "oriet_opset": (ctypes.c_int64, [c_void_p]),
        "oriet_num_opset_imports": (c_size_t, [c_void_p]),
        "oriet_opset_import_domain": (c_char_p, [c_void_p, c_size_t]),
        "oriet_opset_import_version": (ctypes.c_int64, [c_void_p, c_size_t]),
        "oriet_model_version": (ctypes.c_int64, [c_void_p]),
        "oriet_producer": (c_char_p, [c_void_p]),
        "oriet_producer_version": (c_char_p, [c_void_p]),
        "oriet_domain": (c_char_p, [c_void_p]),
        "oriet_graph_name": (c_char_p, [c_void_p]),
        "oriet_num_nodes": (c_size_t, [c_void_p]),
        "oriet_node_op": (c_char_p, [c_void_p, c_size_t]),
        "oriet_node_name": (c_char_p, [c_void_p, c_size_t]),
        "oriet_node_domain": (c_char_p, [c_void_p, c_size_t]),
        "oriet_node_num_inputs": (c_size_t, [c_void_p, c_size_t]),
        "oriet_node_input": (c_char_p, [c_void_p, c_size_t, c_size_t]),
        "oriet_node_num_outputs": (c_size_t, [c_void_p, c_size_t]),
        "oriet_node_output": (c_char_p, [c_void_p, c_size_t, c_size_t]),
        "oriet_node_num_attrs": (c_size_t, [c_void_p, c_size_t]),
        "oriet_node_attr_name": (c_char_p, [c_void_p, c_size_t, c_size_t]),
        "oriet_node_attr_raw": (ctypes.POINTER(ctypes.c_uint8),
                                [c_void_p, c_size_t, c_size_t,
                                 ctypes.POINTER(c_size_t)]),
        "oriet_num_initializers": (c_size_t, [c_void_p]),
        "oriet_init_name": (c_char_p, [c_void_p, c_size_t]),
        "oriet_init_dtype": (ctypes.c_int32, [c_void_p, c_size_t]),
        "oriet_init_ndim": (c_size_t, [c_void_p, c_size_t]),
        "oriet_init_dims": (ctypes.POINTER(ctypes.c_int64),
                            [c_void_p, c_size_t]),
        "oriet_init_data": (ctypes.POINTER(ctypes.c_uint8),
                            [c_void_p, c_size_t, ctypes.POINTER(c_size_t)]),
        "oriet_num_vi": (c_size_t, [c_void_p, ctypes.c_int]),
        "oriet_vi_name": (c_char_p, [c_void_p, ctypes.c_int, c_size_t]),
        "oriet_vi_elem_type": (ctypes.c_int32,
                               [c_void_p, ctypes.c_int, c_size_t]),
        "oriet_vi_ndim": (c_size_t, [c_void_p, ctypes.c_int, c_size_t]),
        "oriet_vi_dims": (ctypes.POINTER(ctypes.c_int64),
                          [c_void_p, ctypes.c_int, c_size_t]),
        "oriet_vi_dim_param": (c_char_p, [c_void_p, ctypes.c_int, c_size_t,
                                          c_size_t]),
        "oriet_parse_tensor": (c_void_p, [ctypes.c_char_p, c_size_t]),
        "oriet_free_tensor": (None, [c_void_p]),
        "oriet_tensor_name": (c_char_p, [c_void_p]),
        "oriet_tensor_dtype": (ctypes.c_int32, [c_void_p]),
        "oriet_tensor_ndim": (c_size_t, [c_void_p]),
        "oriet_tensor_dims": (ctypes.POINTER(ctypes.c_int64), [c_void_p]),
        "oriet_tensor_data": (ctypes.POINTER(ctypes.c_uint8),
                              [c_void_p, ctypes.POINTER(c_size_t)]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return _lib


def _vi_list(lib, h, kind: int) -> List[onnx_io.ValueInfo]:
    out = []
    for i in range(lib.oriet_num_vi(h, kind)):
        ndim = lib.oriet_vi_ndim(h, kind, i)
        dims_ptr = lib.oriet_vi_dims(h, kind, i)
        shape: List[Union[int, str, None]] = []
        for j in range(ndim):
            d = dims_ptr[j]
            if d >= 0:
                shape.append(int(d))
            else:
                p = lib.oriet_vi_dim_param(h, kind, i, j)
                shape.append(p.decode() if p else None)
        out.append(onnx_io.ValueInfo(
            name=lib.oriet_vi_name(h, kind, i).decode(),
            elem_type=int(lib.oriet_vi_elem_type(h, kind, i)) or None,
            shape=shape if ndim else None,
        ))
    return out


def _decode(dtype_code: int, shape, raw: bytes):
    """A tensor's bytes as the C++ side gives them (its little-endian
    elements, or typed integer fields widened to int64) -> its array (a
    torch.bfloat16 tensor for BFLOAT16), or None for a layout the bridge
    does not decode."""
    n_elems = int(np.prod(shape, dtype=np.int64))
    if dtype_code == onnx_io.BFLOAT16:
        if len(raw) == n_elems * 2:
            bits = np.frombuffer(raw, dtype="<u2")
        elif len(raw) == n_elems * 8:  # int32_data widened to int64
            bits = np.frombuffer(raw, dtype="<i8").astype(np.uint16)
        else:
            return None
        return onnx_io._bf16_tensor(bits.reshape(shape))
    np_dtype = onnx_io.DTYPE_TO_NUMPY.get(dtype_code)
    if np_dtype is None or np_dtype == np.dtype(object):
        return None
    if len(raw) == n_elems * np_dtype.itemsize:
        arr = np.frombuffer(raw, dtype=np_dtype.newbyteorder("<")
                            ).astype(np_dtype)
    elif np.issubdtype(np_dtype, np.integer) and len(raw) == n_elems * 8:
        # typed int fields were widened to int64 by the C++ side
        arr = np.frombuffer(raw, dtype="<i8").astype(np_dtype)
    else:
        return None
    return arr.reshape(shape)


def read_tensor_native(path: str) -> Optional[onnx_io.TensorData]:
    """A TensorProto .pb file through the C++ library (the golden I/O data
    path); None where the library is off or the tensor's layout is one the
    bridge does not decode."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    h = lib.oriet_parse_tensor(buf, len(buf))
    if not h:
        return None
    try:
        ndim = lib.oriet_tensor_ndim(h)
        dims = lib.oriet_tensor_dims(h)
        shape = tuple(int(dims[j]) for j in range(ndim))
        ln = ctypes.c_size_t()
        ptr = lib.oriet_tensor_data(h, ctypes.byref(ln))
        arr = _decode(int(lib.oriet_tensor_dtype(h)), shape,
                      ctypes.string_at(ptr, ln.value))
        if arr is None:
            return None
        name = (lib.oriet_tensor_name(h) or b"").decode()
        return onnx_io.TensorData(name=name, array=arr)
    finally:
        lib.oriet_free_tensor(h)


def load_model_native(path: str) -> Optional[onnx_io.ModelProto]:
    """Parse a model file with the C++ library.

    Returns None only for a capability gap (the library off or unbuildable,
    a tensor the bridge cannot decode: external data, strings): the caller
    then parses with the pure-Python codec. A malformed buffer raises
    ModelParseError with the C++ parser's own error, as the Python codec
    raises for it."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    h = lib.oriet_parse_model(buf, len(buf))
    if not h:
        raise onnx_io.ModelParseError(
            f"{path}: native parser rejected the buffer (no handle)")
    try:
        err = lib.oriet_error(h)
        if err:
            raise onnx_io.ModelParseError(
                f"{path}: invalid ONNX ModelProto: "
                f"{err.decode(errors='replace')}")

        g = onnx_io.GraphProto(name=(lib.oriet_graph_name(h) or b"").decode())
        for i in range(lib.oriet_num_nodes(h)):
            n = onnx_io.NodeProto(
                op_type=lib.oriet_node_op(h, i).decode(),
                input=[lib.oriet_node_input(h, i, j).decode()
                       for j in range(lib.oriet_node_num_inputs(h, i))],
                output=[lib.oriet_node_output(h, i, j).decode()
                        for j in range(lib.oriet_node_num_outputs(h, i))],
                name=(lib.oriet_node_name(h, i) or b"").decode(),
                domain=(lib.oriet_node_domain(h, i) or b"").decode(),
            )
            for j in range(lib.oriet_node_num_attrs(h, i)):
                ln = ctypes.c_size_t()
                ptr = lib.oriet_node_attr_raw(h, i, j, ctypes.byref(ln))
                a = onnx_io._parse_attribute(ctypes.string_at(ptr, ln.value))
                n.attributes[a.name] = a
            g.nodes.append(n)

        for i in range(lib.oriet_num_initializers(h)):
            name = lib.oriet_init_name(h, i).decode()
            ndim = lib.oriet_init_ndim(h, i)
            dims_ptr = lib.oriet_init_dims(h, i)
            shape = tuple(int(dims_ptr[j]) for j in range(ndim))
            ln = ctypes.c_size_t()
            ptr = lib.oriet_init_data(h, i, ctypes.byref(ln))
            arr = _decode(int(lib.oriet_init_dtype(h, i)), shape,
                          ctypes.string_at(ptr, ln.value))
            if arr is None:
                return None
            g.initializers[name] = arr

        g.inputs = _vi_list(lib, h, 0)
        g.outputs = _vi_list(lib, h, 1)
        g.value_infos = _vi_list(lib, h, 2)

        imports = {
            (lib.oriet_opset_import_domain(h, i) or b"").decode():
                int(lib.oriet_opset_import_version(h, i))
            for i in range(int(lib.oriet_num_opset_imports(h)))
        }
        return onnx_io.ModelProto(
            graph=g,
            ir_version=int(lib.oriet_ir_version(h)),
            opset_version=int(lib.oriet_opset(h)) or 13,
            opset_imports=imports,
            producer_name=(lib.oriet_producer(h) or b"").decode(),
            producer_version=(lib.oriet_producer_version(h) or b"").decode(),
            domain=(lib.oriet_domain(h) or b"").decode(),
            model_version=int(lib.oriet_model_version(h)),
        )
    finally:
        lib.oriet_free_model(h)
