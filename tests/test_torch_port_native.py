"""The port's front end made whole, held against its own Python codec and
against the JAX package on the CPU:

- the native C++ parser (native_loader.py over native/onnx_loader.cc, the
  port's own copy of the JAX package's source): on in-repo bytes
  (SqueezeNet, GPT-2 TINY, R3D-18 narrow, a model with If and Loop
  subgraphs, a model with bf16 initializers and a BFLOAT16 input), its
  ModelProto equals the port's pure-Python parse field by field and the
  JAX package's `load_model_native` value by value; the goldens'
  TensorProtos likewise through `read_tensor_native`; `import_onnx` takes
  it; ORIET_NATIVE=0 and a compiler that fails fall back to the Python
  codec, the second with one warning that carries the compiler's error;
  a malformed buffer raises ModelParseError as the Python codec does.
- a BFLOAT16 graph input: the port's InputSpec carries torch.bfloat16,
  the Engine takes a bf16 tensor for it, and the outputs equal the JAX
  package's fed the same values as an ml_dtypes.bfloat16 array; the CLI's
  inspect names the dtype as the JAX CLI does.
"""

import dataclasses
import glob
import json
import os
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import native_loader as j_native
from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu_torch import cli as t_cli
from onnx_rusty_inference_engine_tpu_torch import native_loader
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine as TEngine
from onnx_rusty_inference_engine_tpu_torch.graph import (export_model,
                                                         import_model,
                                                         import_onnx)
from onnx_rusty_inference_engine_tpu_torch.models import build_squeezenet
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import (TINY,
                                                               build_gpt2)
from torch_port_util import values_equal
from torch_port_video import build_r3d18
from util import make_model, node

GOLDENS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "goldens", "*.pb")))
BF16 = 16  # onnx TensorProto.BFLOAT16


@pytest.fixture(scope="module")
def lib():
    lib = native_loader.get_lib()
    assert lib is not None, "the native parser builds here (g++ is present)"
    return lib


def _bits(v):
    """A bf16 value of either package as its uint16 bit patterns."""
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(v).view(np.uint16)


def _same(a, b) -> bool:
    """Two values of the port's protos equal: arrays by dtype, shape and
    bytes, bf16 tensors by their bits, dataclasses field by field."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(_bits(a), _bits(b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, t_io.ValueInfo) and isinstance(b, t_io.ValueInfo):
        # a ValueInfo with no dims: the C++ parser gives shape None, the
        # Python codec [] (the JAX package's two parsers differ so too);
        # the importer reads both as ()
        a = dataclasses.replace(a, shape=a.shape or None)
        b = dataclasses.replace(b, shape=b.shape or None)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def _bf16_model():
    """bf16 initializers and a BFLOAT16 input, each widened by a Cast:
    y = f32(x) * f32(W), z = Relu(f32(x) + f32(b)) (one f32 op each, so
    neither package's fusion can round differently)."""
    rng = np.random.default_rng(40)
    w = torch.from_numpy(rng.standard_normal((2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32)).to(
        torch.bfloat16)
    g = t_io.GraphProto(name="bf16_io")
    g.inputs.append(t_io.ValueInfo(name="x", elem_type=BF16, shape=[2, 8]))
    g.initializers = {"W": w, "b": b}

    def cast(src, dst):
        return t_io.NodeProto("Cast", [src], [dst], attributes={
            "to": t_io.Attribute(name="to", i=1)})

    mk = t_io.NodeProto
    g.nodes = [cast("x", "xf"), cast("W", "wf"), cast("b", "bf"),
               mk("Mul", ["xf", "wf"], ["y"]),
               mk("Add", ["xf", "bf"], ["xb"]),
               mk("Relu", ["xb"], ["z"])]
    g.outputs = [t_io.ValueInfo(name="y"), t_io.ValueInfo(name="z")]
    return t_io.ModelProto(graph=g, opset_version=13, opset_imports={"": 13})


def _control_flow_model():
    """If (then / else subgraphs) and Loop (a body with a loop-carried
    value and a scan output), in the JAX package's codec."""
    then_g = j_io.GraphProto(name="then")
    then_g.nodes = [node("Add", ["x", "x"], ["o"])]
    then_g.outputs.append(j_io.ValueInfo(name="o"))
    else_g = j_io.GraphProto(name="else")
    else_g.nodes = [node("Neg", ["x"], ["o"])]
    else_g.outputs.append(j_io.ValueInfo(name="o"))
    body = j_io.GraphProto(name="body")
    body.inputs = [j_io.ValueInfo(name="i", elem_type=7, shape=[]),
                   j_io.ValueInfo(name="c", elem_type=9, shape=[]),
                   j_io.ValueInfo(name="acc", elem_type=1, shape=[2, 2])]
    body.initializers = {"step": np.full((2, 2), 0.5, np.float32)}
    body.nodes = [node("Add", ["acc", "step"], ["acc2"]),
                  node("Identity", ["c"], ["c2"]),
                  node("Identity", ["acc2"], ["scan"])]
    body.outputs = [j_io.ValueInfo(name="c2"), j_io.ValueInfo(name="acc2"),
                    j_io.ValueInfo(name="scan")]
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    return make_model(
        [node("If", ["p"], ["branch"], then_branch=then_g,
              else_branch=else_g),
         node("Loop", ["n", "", "branch"], ["final", "scans"], body=body)],
        {"x": x}, ["final", "scans"],
        {"p": np.array(True), "n": np.array(3, np.int64)}), {"x": x}


def _cases():
    """name -> the model's bytes."""
    cf, _ = _control_flow_model()
    return {
        "squeezenet": t_io.serialize_model(build_squeezenet(seed=0)),
        "gpt2_tiny": t_io.serialize_model(
            build_gpt2(TINY, batch=1, seq_len=4, with_presents=False)),
        "r3d18_narrow": t_io.serialize_model(build_r3d18(
            width=8, blocks=(1, 1, 1, 1), num_classes=10,
            clip=(3, 4, 16, 16))),
        "control_flow": j_io.serialize_model(cf),
        "bf16": t_io.serialize_model(_bf16_model()),
    }


CASES = list(_cases())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    out = {}
    for name, data in _cases().items():
        out[name] = str(d / f"{name}.onnx")
        with open(out[name], "wb") as f:
            f.write(data)
    return out


@pytest.mark.parametrize("case", CASES)
def test_native_parse_equals_python_codec(lib, files, case):
    native = native_loader.load_model_native(files[case])
    assert native is not None
    assert _same(native, t_io.load_model(files[case]))


@pytest.mark.parametrize("case", CASES)
def test_native_parse_equals_jax_native_parse(lib, files, case):
    """Value by value against the JAX package's load_model_native on the
    same file (bf16 values by their bits: ml_dtypes' there, torch's
    here)."""
    want = j_native.load_model_native(files[case])
    if want is None:
        pytest.skip("the JAX package's native library is unavailable")
    got = native_loader.load_model_native(files[case])
    for f in ("ir_version", "opset_version", "opset_imports",
              "producer_name", "producer_version", "domain",
              "model_version"):
        assert getattr(got, f) == getattr(want, f), f
    gw, gg = want.graph, got.graph
    assert list(gg.initializers) == list(gw.initializers)
    for k, v in gw.initializers.items():
        if v.dtype == ml_dtypes.bfloat16:
            assert gg.initializers[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(gg.initializers[k]),
                                          _bits(v))
        else:
            assert values_equal(v, gg.initializers[k]), k
    bare_w = dataclasses.replace(gw, initializers={})
    bare_g = dataclasses.replace(gg, initializers={})
    assert values_equal(bare_w, bare_g)


@pytest.mark.parametrize("path", GOLDENS,
                         ids=[os.path.basename(p) for p in GOLDENS])
def test_native_tensor_reader_equals_python_codec(lib, path):
    got = native_loader.read_tensor_native(path)
    want = t_io.read_tensor_file(path)
    assert got is not None and _same(got, want)


def test_import_onnx_takes_the_native_parser(lib, files, monkeypatch):
    calls = []
    real = native_loader.load_model_native
    monkeypatch.setattr(native_loader, "load_model_native",
                        lambda p: calls.append(p) or real(p))
    g = import_onnx(files["squeezenet"])
    assert calls == [files["squeezenet"]]
    assert [n.op_type for n in g.nodes].count("Conv") == 26
    want = import_model(t_io.load_model(files["squeezenet"]))
    assert [n.op_type for n in g.nodes] == [n.op_type for n in want.nodes]


def test_oriet_native_0_and_a_failing_compiler_fall_back(files, monkeypatch,
                                                          tmp_path):
    """ORIET_NATIVE=0: no library, the Python codec parses, no warning. A
    compiler that fails (here one that does not exist, building into an
    empty cache): one RuntimeWarning with its error, then the Python codec
    parses."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_lib_tried", False)
    monkeypatch.setenv("ORIET_NATIVE", "0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native_loader.get_lib() is None
        assert native_loader.load_model_native(files["squeezenet"]) is None
        g = import_onnx(files["squeezenet"])
    assert len(g.nodes) > 0

    monkeypatch.setattr(native_loader, "_lib_tried", False)
    monkeypatch.delenv("ORIET_NATIVE")
    monkeypatch.setenv("ORIET_COMPILE_CACHE", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="no-such-compiler"):
        assert native_loader.get_lib() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once only
        g2 = import_onnx(files["squeezenet"])
    assert [n.op_type for n in g2.nodes] == [n.op_type for n in g.nodes]
    assert os.listdir(os.path.dirname(native_loader.SOURCE)) == [
        "onnx_loader.cc"]
    assert native_loader.library_path().startswith(str(tmp_path))


def test_malformed_bytes_raise_as_the_python_codec_does(lib, tmp_path):
    path = str(tmp_path / "bad.onnx")
    data = t_io.serialize_model(build_squeezenet(seed=0))
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(t_io.ModelParseError):
        native_loader.load_model_native(path)
    with pytest.raises(t_io.ModelParseError):
        t_io.load_model(path)


def test_library_builds_outside_the_package(lib):
    so = native_loader.library_path()
    pkg = os.path.dirname(os.path.abspath(native_loader.__file__))
    assert os.path.exists(so) and not so.startswith(pkg + os.sep)
    assert os.path.basename(os.path.dirname(os.path.dirname(so))) == "native"


# --------------------------------------------------------------------------
# a BFLOAT16 graph input
# --------------------------------------------------------------------------
def test_bf16_graph_input_matches_jax(files):
    g = import_onnx(files["bf16"])
    assert [(s.name, s.dtype) for s in g.inputs] == [("x", torch.bfloat16)]
    x = np.random.default_rng(41).standard_normal((2, 8)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TEngine(g, device="cpu").run({"x": xb}).outputs
    jg = j_import(j_io.load_model(files["bf16"]))
    assert jg.inputs[0].dtype == ml_dtypes.bfloat16
    want = JEngine(jg).run({"x": x.astype(ml_dtypes.bfloat16)}).outputs
    for k in ("y", "z"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_bf16_graph_input_round_trips_and_inspects(files, tmp_path, capsys):
    g = import_onnx(files["bf16"])
    again = import_model(t_io.parse_model(t_io.serialize_model(
        export_model(g))))
    assert again.inputs[0].dtype == torch.bfloat16
    assert t_cli.main(["inspect", "--model", files["bf16"]]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["inputs"] == [{"name": "x", "shape": [2, 8],
                               "dtype": "bfloat16"}]
    assert info["unsupported_ops"] == []


def test_control_flow_model_runs_from_the_native_parse(lib, files):
    _, feed = _control_flow_model()
    g = import_onnx(files["control_flow"])
    got = TEngine(g, device="cpu").run(feed).outputs
    want = JEngine(j_import(j_io.load_model(files["control_flow"]))).run(
        feed).outputs
    for k in ("final", "scans"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
