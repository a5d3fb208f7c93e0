"""The port's op library against the JAX package's emitters, one node at a
time on the CPU: every op the port took over from ops/standard.py,
ops/extra.py, ops/bounded.py, ops/losses.py, ops/vision_roi.py and
ops/ml.py (tests/torch_port_oplib.py's CASES), on the same inputs from a
seeded numpy generator.

Tolerances, per case in the table: integer, boolean and index outputs
exact (TopK ties and ArgMax's select_last_index included); elementwise
float ops rtol 1e-5, atol 1e-6; sums and products over tens of terms
(reductions, norms, ConvTranspose, Einsum, losses, the ml products)
rtol = atol = 1e-5; transforms (DFT, STFT) rtol = atol = 1e-4; RoiAlign
rtol 1e-4, atol 1e-5 and DeformConv 1e-3, 1e-4 (test_roi_ops.py's).
Where the JAX emitter breaks the ONNX spec (SPEC_CASES) the port is held
to a numpy reference of the spec at the case's tolerance, and the JAX
emitter is shown to differ. The random ops
are held to their contract: the same node gives the same tensor on every
run (a seeded node on any graph; a seedless one by its output's name), and
the draws have the moments of their distribution (mean and standard
deviation within 5 standard errors; Bernoulli and Multinomial frequencies
within 5 standard errors of p).

The structural tests pin the registry: every op the port registers has a
case in some test_torch_port_* table, and the port's registry is the JAX
registry's 223 op types.
"""

import glob
import os

import numpy as np
import pytest

import torch_port_oplib as lib
from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError, get_emitter, supported_ops)
from torch_port_util import run_op_port, to_port


def run_jax(c):
    """The case through the JAX Engine (serialized and reparsed, as
    util.run_op does)."""
    m = j_io.parse_model(j_io.serialize_model(lib.model(c, j_io)))
    res = JEngine(j_import(m)).run(c.feeds)
    return [np.asarray(res.outputs[f"out{i}"]) for i in range(c.n_out)]


def run_port(c):
    res = Engine(to_port(lib.model(c, j_io)), device="cpu").run(c.feeds)
    return [np.asarray(res.outputs[f"out{i}"]) for i in range(c.n_out)]


def assert_close(got, want, tol, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol is None or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want.astype(got.dtype)
                                      if want.dtype.kind in "biu" else want,
                                      err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                   err_msg=what)


@pytest.mark.parametrize("c", lib.CASES, ids=[c.id for c in lib.CASES])
def test_op_matches_jax(c):
    want, got = run_jax(c), run_port(c)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, c.tol, f"{c.id} out{i}")


@pytest.mark.parametrize("c", lib.SPEC_CASES,
                         ids=[c.id for c in lib.SPEC_CASES])
def test_spec_where_jax_differs(c):
    """The port follows the spec where the JAX emitter does not (each
    case is in ROADMAP §3); the JAX emitter's output is shown to differ
    from the spec's, or to fail."""
    (got,) = run_port(c)
    (ref,) = lib.SPEC_REFS[c.id]
    assert_close(got, ref, c.tol, c.id)
    try:
        (want,) = run_jax(c)
    except Exception:
        return
    assert want.shape != ref.shape or not np.allclose(
        want, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("op", ["ReduceSum", "ReduceMax", "ReduceProd"])
def test_reduce_empty_axes_reduces_all(op):
    """An empty axes input with noop_with_empty_axes 0 reduces every axis,
    as the spec says; the JAX emitter reduces none (it passes an empty
    axis tuple to jnp) and returns the input."""
    x = np.arange(1, 13, dtype=np.float32).reshape(3, 4) / 4
    c = lib.case(f"{op}_empty", op, {"x": x},
                 {"axes": np.zeros(0, np.int64)}, keepdims=0)
    (got,) = run_port(c)
    ref = {"ReduceSum": x.sum(), "ReduceMax": x.max(),
           "ReduceProd": x.prod()}[op]
    assert got.shape == ()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    (want,) = run_jax(c)
    assert want.shape == x.shape


@pytest.mark.parametrize("op,dtype", [("BitShift", np.uint32),
                                      ("BitwiseNot", np.uint16),
                                      ("Mod", np.uint64)])
def test_wide_unsigned_ints_raise(op, dtype):
    """PyTorch has no shift, bitwise-not or remainder kernel for uint16/32/
    64: the port refuses them by name rather than failing inside torch."""
    x = np.arange(1, 7, dtype=dtype).reshape(2, 3)
    feeds = {"x": x} if op == "BitwiseNot" else {"x": x, "y": x}
    attrs = {"direction": "LEFT"} if op == "BitShift" else {}
    with pytest.raises(UnsupportedOpError, match=str(np.dtype(dtype))):
        run_op_port(op, feeds, opset=18, **attrs)


def test_convtranspose_refuses_output_shape_and_auto_pad():
    """The JAX emitter reads neither attribute (and computes another
    output than the spec's); the port refuses both by name."""
    x = np.ones((1, 1, 3, 3), np.float32)
    w = np.ones((1, 1, 3, 3), np.float32)
    for attrs, name in (({"output_shape": [7, 7]}, "output_shape"),
                        ({"auto_pad": "SAME_UPPER"}, "auto_pad")):
        with pytest.raises(UnsupportedOpError, match=name):
            run_op_port("ConvTranspose", {"x": x}, {"w": w},
                        strides=[2, 2], **attrs)


def test_topk_ties_lower_index_first():
    """Equal values come out in ascending index order, largest and
    smallest, as lax.top_k gives them."""
    x = np.array([[2, 7, 7, 1, 7, 2]], np.float32)
    v, i = run_op_port("TopK", {"x": x}, {"k": np.array([4], np.int64)},
                       n_outputs=2)
    np.testing.assert_array_equal(i, [[1, 2, 4, 0]])
    np.testing.assert_array_equal(v, [[7, 7, 7, 2]])
    v, i = run_op_port("TopK", {"x": x}, {"k": np.array([3], np.int64)},
                       n_outputs=2, largest=0)
    np.testing.assert_array_equal(i, [[3, 0, 5]])


STATIC_ONLY = ("Shape", "Size", "Constant", "ConstantOfShape", "Range")


@pytest.mark.parametrize("shape", [(2, 3), (4, 1, 5)])
def test_static_ops_fold_at_run_time(shape):
    """Shape, Size, Constant, ConstantOfShape and Range have no emitter:
    the import folds them, and in a run `run_nodes` makes them static
    values from the input's shape. A graph whose ConstantOfShape and Range
    read Shape and Size of a graph input (nothing the import can fold)
    gives the JAX Engine's outputs, exactly, on two input shapes."""
    for op in STATIC_ONLY:
        assert op in supported_ops()
        with pytest.raises(UnsupportedOpError):
            get_emitter(op)
    io = j_io
    n = io.NodeProto
    nodes = [
        n(op_type="Shape", input=["x"], output=["s"]),
        n(op_type="ConstantOfShape", input=["s"], output=["c"],
          attributes={"value": lib._attr(io, "value",
                                         np.array([2.5], np.float32))}),
        n(op_type="Add", input=["x", "c"], output=["y"]),
        n(op_type="Size", input=["x"], output=["k"]),
        n(op_type="Constant", input=[], output=["one"],
          attributes={"value": lib._attr(io, "value",
                                         np.array(1, np.int64))}),
        n(op_type="Constant", input=[], output=["two"],
          attributes={"value": lib._attr(io, "value",
                                         np.array(2, np.int64))}),
        n(op_type="Range", input=["one", "k", "two"], output=["r"]),
    ]
    g = io.GraphProto(name="t")
    g.nodes = nodes
    g.inputs.append(io.ValueInfo(name="x", elem_type=io.NUMPY_TO_DTYPE[
        np.dtype(np.float32)], shape=[-1] * len(shape)))
    for name in ("y", "s", "k", "r"):
        g.outputs.append(io.ValueInfo(name=name))
    m = io.ModelProto(graph=g, opset_version=13)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm = j_io.parse_model(j_io.serialize_model(m))
    want = JEngine(j_import(jm)).run({"x": x}).outputs
    got = Engine(to_port(m), device="cpu").run({"x": x}).outputs
    for name in ("y", "s", "k", "r"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(got["r"], np.arange(1, x.size, 2))


# ---------------------------------------------------------------------------
# random ops: the seed contract and the moments
# ---------------------------------------------------------------------------
RANDOM = {c.id: c for c in lib.RANDOM_CASES}


@pytest.mark.parametrize("cid", sorted(RANDOM))
def test_random_op_same_seed_same_tensor(cid):
    """Two Engines of one graph, and two runs of one Engine, give the same
    tensor; a node of another seed (or, seedless, of another output name)
    gives another."""
    c = RANDOM[cid]
    (a,) = run_port(c)
    eng = Engine(to_port(lib.model(c, j_io)), device="cpu")
    b = eng.run(c.feeds).outputs["out0"]
    b2 = eng.run(c.feeds).outputs["out0"]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, b2)
    attrs = dict(c.attrs)
    if "seed" in attrs:
        attrs["seed"] = attrs["seed"] + 1.0
        other = c._replace(attrs=attrs)
    else:
        other = c._replace(attrs=attrs)
        m = lib.model(other, j_io)
        m.graph.nodes[0].output = ["renamed"]
        m.graph.outputs[0].name = "renamed"
        (o,) = [Engine(to_port(m), device="cpu").run(c.feeds)
                .outputs["renamed"]]
        assert not np.array_equal(o, a)
        return
    (o,) = run_port(other)
    assert not np.array_equal(o, a)


def _within(sample_mean, mean, sd, n, k=5.0):
    assert abs(sample_mean - mean) < k * sd / np.sqrt(n), (sample_mean, mean)


def test_random_moments():
    (y,) = run_port(RANDOM["RandomNormal"])
    assert y.shape == (64, 64) and y.dtype == np.float32
    _within(y.mean(), 1.0, 2.0, y.size)
    assert abs(y.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * y.size)
    (y,) = run_port(RANDOM["RandomNormalLike"])
    _within(y.mean(), 0.0, 1.0, y.size)
    (y,) = run_port(RANDOM["RandomUniform"])
    assert y.min() >= -1.0 and y.max() < 3.0
    _within(y.mean(), 1.0, 4.0 / np.sqrt(12), y.size)
    (y,) = run_port(RANDOM["RandomUniformLike"])
    assert y.min() >= 0.0 and y.max() < 1.0
    _within(y.mean(), 0.5, 1.0 / np.sqrt(12), y.size)
    c = RANDOM["Bernoulli"]
    (y,) = run_port(c)
    p = c.feeds["p"]
    assert set(np.unique(y)) <= {0.0, 1.0}
    _within(y.mean(), p.mean(), np.sqrt((p * (1 - p)).mean()), y.size)
    c = RANDOM["Multinomial"]
    (y,) = run_port(c)
    assert y.shape == (2, 4096) and y.dtype == np.int32
    probs = np.exp(c.feeds["x"])
    for row in range(2):
        for k in range(3):
            f = (y[row] == k).mean()
            pk = probs[row, k]
            _within(f, pk, np.sqrt(pk * (1 - pk)), y.shape[1])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_port_registry_is_the_jax_registry():
    """The port registers every op type of the JAX registry (223, with
    the ops it runs only as static values) and no other."""
    import onnx_rusty_inference_engine_tpu.ops  # noqa: F401
    from onnx_rusty_inference_engine_tpu.ops.registry import (
        supported_ops as j_supported)

    assert supported_ops() == j_supported()
    assert len(supported_ops()) == 223


def test_every_port_op_has_a_case():
    """Every op the port registers appears in a case table of the port's
    tests: tests/torch_port_oplib.py's, or a quoted op name in one of the
    test_torch_port_* files (the slices before this one)."""
    here = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(p).read() for p in glob.glob(
        os.path.join(here, "test_torch_port_*.py")))
    table = {c.op for c in lib.ALL_CASES}
    lacking = [op for op in supported_ops()
               if op not in table and f'"{op}"' not in text]
    assert not lacking, lacking
