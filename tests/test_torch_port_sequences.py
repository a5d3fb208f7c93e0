"""The port's Sequence and Optional emitters (ops/sequences.py) against the
JAX package's, on the CPU: tests/test_sequences.py's cases, each model run
by both Engines on the same inputs from a seeded numpy generator, plus the
Loop with sequence state and every op's refusals with JAX's messages.
Sequence data movement is exact; SequenceLength's index dtype is the
port's int64 (JAX's int32 under x64-off), its value equal.
"""

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.ops.registry import (
    UnsupportedOpError as JUnsupported)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import to_port
from util import make_model, node

rng = np.random.default_rng(41)


def _subgraph(name, nodes, inputs=(), outputs=(), initializers=None):
    g = onnx_io.GraphProto(name=name)
    g.nodes = list(nodes)
    g.initializers = dict(initializers or {})
    for n_ in inputs:
        g.inputs.append(onnx_io.ValueInfo(name=n_))
    for n_ in outputs:
        g.outputs.append(onnx_io.ValueInfo(name=n_))
    return g


def _wire(model):
    return onnx_io.parse_model(onnx_io.serialize_model(model))


def _both(model, feeds):
    """(JAX's outputs, the port's outputs), checked equal: exact, a
    sequence element by element."""
    m2 = _wire(model)
    want = JEngine(j_import(m2)).run(feeds).outputs
    got = Engine(to_port(m2), device="cpu").run(feeds).outputs
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert isinstance(g, list) and len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)
        else:
            w = np.asarray(w)
            assert g.shape == w.shape, k
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64), err_msg=k)
            else:
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
    return got


def _raises_both(model, feeds, match):
    m2 = _wire(model)
    with pytest.raises(JUnsupported, match=match):
        JEngine(j_import(m2)).run(feeds)
    with pytest.raises(UnsupportedOpError, match=match):
        Engine(to_port(m2), device="cpu").run(feeds)


def test_construct_at_length():
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)  # heterogeneous shapes
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["seq"]),
         node("SequenceAt", ["seq", "neg1"], ["last"]),
         node("SequenceLength", ["seq"], ["n"])],
        {"a": a, "b": b}, ["last", "n"],
        {"neg1": np.array(-1, np.int64)})
    out = _both(m, {"a": a, "b": b})
    assert out["n"].dtype == np.int64 and int(out["n"]) == 2


@pytest.mark.parametrize("p", [0, 1, 2, -1, -3])
def test_sequence_at_dynamic_position(p):
    """A run-time position over a homogeneous sequence, picked on the
    device."""
    a, b, c = (rng.standard_normal((3,)).astype(np.float32)
               for _ in range(3))
    m = make_model(
        [node("SequenceConstruct", ["a", "b", "c"], ["seq"]),
         node("SequenceAt", ["seq", "pos"], ["out"])],
        {"a": a, "b": b, "c": c, "pos": np.array(0, np.int64)}, ["out"])
    got = _both(m, {"a": a, "b": b, "c": c, "pos": np.array(p, np.int64)})
    np.testing.assert_array_equal(got["out"], [a, b, c][p])


def test_sequence_at_dynamic_heterogeneous_rejected():
    a = rng.standard_normal((3,)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["seq"]),
         node("SequenceAt", ["seq", "pos"], ["out"])],
        {"a": a, "b": b, "pos": np.array(0, np.int64)}, ["out"])
    _raises_both(m, {"a": a, "b": b, "pos": np.array(0, np.int64)},
                 "heterogeneous")


def test_insert_erase():
    a, b, c = np.float32([1.0]), np.float32([2.0]), np.float32([3.0])
    m = make_model(
        [node("SequenceConstruct", ["a"], ["s0"]),
         node("SequenceInsert", ["s0", "b"], ["s1"]),
         node("SequenceInsert", ["s1", "c", "zero"], ["s2"]),
         node("SequenceErase", ["s2", "one"], ["s3"]),
         node("ConcatFromSequence", ["s3"], ["out"], axis=0)],
        {"a": a, "b": b, "c": c}, ["out"],
        {"zero": np.array(0, np.int64), "one": np.array(1, np.int64)})
    got = _both(m, {"a": a, "b": b, "c": c})
    np.testing.assert_array_equal(got["out"], [3.0, 2.0])


def test_erase_default_is_last():
    a = np.float32([1.0, 2.0])
    b = np.float32([3.0, 4.0])
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["s"]),
         node("SequenceErase", ["s"], ["s2"]),
         node("ConcatFromSequence", ["s2"], ["out"], axis=0)],
        {"a": a, "b": b}, ["out"])
    np.testing.assert_array_equal(_both(m, {"a": a, "b": b})["out"], a)


@pytest.mark.parametrize("op,inputs,pos,match", [
    ("SequenceAt", ["seq", "p"], 5, "out of range"),
    ("SequenceErase", ["seq", "p"], -4, "out of range"),
    ("SequenceInsert", ["seq", "a", "p"], 4, "out of range"),
])
def test_positions_out_of_range_rejected(op, inputs, pos, match):
    a = np.float32([1.0])
    m = make_model(
        [node("SequenceConstruct", ["a", "a"], ["seq"]),
         node(op, inputs, ["out"])],
        {"a": a}, ["out"], {"p": np.array(pos, np.int64)})
    _raises_both(m, {"a": a}, match)


def test_insert_runtime_position_rejected():
    a = np.float32([1.0])
    m = make_model(
        [node("SequenceConstruct", ["a"], ["seq"]),
         node("SequenceInsert", ["seq", "a", "p"], ["s2"]),
         node("ConcatFromSequence", ["s2"], ["out"], axis=0)],
        {"a": a, "p": np.array(0, np.int64)}, ["out"])
    _raises_both(m, {"a": a, "p": np.array(0, np.int64)},
                 "position must be a trace-time constant")


def test_split_to_sequence_scalar_with_remainder():
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    m = make_model(
        [node("SplitToSequence", ["x", "k"], ["seq"], axis=0),
         node("SequenceAt", ["seq", "neg1"], ["tail"]),
         node("SequenceLength", ["seq"], ["n"])],
        {"x": x}, ["tail", "n"],
        {"k": np.array(3, np.int64), "neg1": np.array(-1, np.int64)})
    out = _both(m, {"x": x})
    assert int(out["n"]) == 3
    np.testing.assert_array_equal(out["tail"], x[6:7])


def test_split_to_sequence_sizes_and_keepdims():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = make_model(
        [node("SplitToSequence", ["x", "sizes"], ["seq"], axis=1),
         node("SequenceAt", ["seq", "one"], ["p1"])],
        {"x": x}, ["p1"],
        {"sizes": np.array([1, 3], np.int64), "one": np.array(1, np.int64)})
    np.testing.assert_array_equal(_both(m, {"x": x})["p1"], x[:, 1:])
    m2 = make_model(
        [node("SplitToSequence", ["x"], ["seq"], axis=0, keepdims=0),
         node("SequenceAt", ["seq", "one"], ["row"])],
        {"x": x}, ["row"], {"one": np.array(1, np.int64)})
    got = _both(m2, {"x": x})["row"]
    assert got.shape == (4,)
    np.testing.assert_array_equal(got, x[1])


def test_split_to_sequence_sizes_must_sum():
    x = np.zeros((3, 4), np.float32)
    m = make_model(
        [node("SplitToSequence", ["x", "sizes"], ["seq"], axis=1),
         node("ConcatFromSequence", ["seq"], ["out"], axis=1)],
        {"x": x}, ["out"], {"sizes": np.array([1, 2], np.int64)})
    _raises_both(m, {"x": x}, "do not sum")


@pytest.mark.parametrize("new_axis,axis", [(1, 1), (1, -1), (0, 0),
                                           (0, -1)])
def test_concat_from_sequence(new_axis, axis):
    a = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal((2, 3)).astype(np.float32)
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["s"]),
         node("ConcatFromSequence", ["s"], ["out"], axis=axis,
              new_axis=new_axis)],
        {"a": a, "b": b}, ["out"])
    got = _both(m, {"a": a, "b": b})["out"]
    want = (np.stack if new_axis else np.concatenate)([a, b], axis=axis)
    np.testing.assert_array_equal(got, want)


def test_sequence_map_with_broadcast_and_zipped_inputs():
    body = _subgraph(
        "body",
        [node("Mul", ["e", "scale"], ["m0"]),
         node("Add", ["m0", "z"], ["o"])],
        inputs=["e", "z"], outputs=["o"],
        initializers={"scale": np.float32(2.0)})
    a, b, za, zb = (rng.standard_normal((3,)).astype(np.float32)
                    for _ in range(4))
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["xs"]),
         node("SequenceConstruct", ["za", "zb"], ["zs"]),
         node("SequenceMap", ["xs", "zs"], ["ys"], body=body),
         node("ConcatFromSequence", ["ys"], ["out"], axis=0, new_axis=1)],
        {"a": a, "b": b, "za": za, "zb": zb}, ["out"])
    got = _both(m, {"a": a, "b": b, "za": za, "zb": zb})["out"]
    np.testing.assert_allclose(got, np.stack([2 * a + za, 2 * b + zb]),
                               rtol=1e-6)


def test_sequence_map_length_mismatch_rejected():
    body = _subgraph("body", [node("Add", ["e", "z"], ["o"])],
                     inputs=["e", "z"], outputs=["o"])
    a = np.float32([1.0])
    m = make_model(
        [node("SequenceConstruct", ["a", "a"], ["xs"]),
         node("SequenceConstruct", ["a"], ["zs"]),
         node("SequenceMap", ["xs", "zs"], ["ys"], body=body),
         node("ConcatFromSequence", ["ys"], ["out"], axis=0)],
        {"a": a}, ["out"])
    _raises_both(m, {"a": a}, "additional sequence input")


def test_loop_appends_to_sequence():
    """SequenceEmpty + SequenceInsert in a Loop body, ConcatFromSequence
    after: the Loop with sequence state unrolls."""
    body = _subgraph(
        "body",
        [node("Identity", ["cond_in"], ["cond_out"]),
         node("Cast", ["iter"], ["fi"], to=onnx_io.FLOAT),
         node("Mul", ["x", "fi"], ["xi"]),
         node("SequenceInsert", ["seq_in", "xi"], ["seq_out"])],
        inputs=["iter", "cond_in", "seq_in"],
        outputs=["cond_out", "seq_out"])
    x = rng.standard_normal((2,)).astype(np.float32)
    m = make_model(
        [node("SequenceEmpty", [], ["s0"]),
         node("Loop", ["M", "cond", "s0"], ["s_final"], body=body),
         node("ConcatFromSequence", ["s_final"], ["out"], axis=0,
              new_axis=1)],
        {"x": x}, ["out"],
        {"M": np.array(3, np.int64), "cond": np.array(True)})
    got = _both(m, {"x": x})["out"]
    np.testing.assert_allclose(got, np.stack([0 * x, 1 * x, 2 * x]),
                               rtol=1e-6)


def test_loop_sequence_state_with_scan_output():
    """Sequence state and a per-trip scan output in one unrolled Loop."""
    body = _subgraph(
        "body",
        [node("Identity", ["cond_in"], ["cond_out"]),
         node("Add", ["x", "x"], ["x2"]),
         node("SequenceInsert", ["seq_in", "x2"], ["seq_out"]),
         node("SequenceLength", ["seq_out"], ["n"])],
        inputs=["iter", "cond_in", "seq_in"],
        outputs=["cond_out", "seq_out", "n"])
    x = rng.standard_normal((2,)).astype(np.float32)
    m = make_model(
        [node("SequenceEmpty", [], ["s0"]),
         node("Loop", ["M", "", "s0"], ["s_final", "ns"], body=body)],
        {"x": x}, ["s_final", "ns"], {"M": np.array(4, np.int64)})
    got = _both(m, {"x": x})
    assert len(got["s_final"]) == 4
    np.testing.assert_array_equal(got["ns"].astype(np.int64), [1, 2, 3, 4])


def test_loop_sequence_state_dynamic_exit_rejected():
    body = _subgraph(
        "body",
        [node("Greater", ["x", "zero"], ["cond_out"]),
         node("SequenceInsert", ["seq_in", "x"], ["seq_out"])],
        inputs=["iter", "cond_in", "seq_in"],
        outputs=["cond_out", "seq_out"],
        initializers={"zero": np.float32(0.0)})
    x = np.float32(1.0)
    m = make_model(
        [node("SequenceEmpty", [], ["s0"]),
         node("Loop", ["M", "cond", "s0"], ["s_final"], body=body),
         node("ConcatFromSequence", ["s_final"], ["out"], axis=0,
              new_axis=1)],
        {"x": np.asarray(x)}, ["out"],
        {"M": np.array(3, np.int64), "cond": np.array(True)})
    _raises_both(m, {"x": np.asarray(x)}, "data-dependent sequence length")


def test_sequence_graph_output():
    """A sequence can be a graph output: run() returns a list of arrays."""
    a = rng.standard_normal((2,)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    m = make_model([node("SequenceConstruct", ["a", "b"], ["seq"])],
                   {"a": a, "b": b}, ["seq"])
    out = _both(m, {"a": a, "b": b})["seq"]
    assert isinstance(out, list) and len(out) == 2


def test_optional_roundtrip_and_empty():
    x = rng.standard_normal((2, 2)).astype(np.float32)
    m = make_model(
        [node("Optional", ["x"], ["opt"]),
         node("OptionalHasElement", ["opt"], ["has"]),
         node("OptionalGetElement", ["opt"], ["got"])],
        {"x": x}, ["has", "got"])
    out = _both(m, {"x": x})
    assert bool(out["has"])
    np.testing.assert_array_equal(out["got"], x)

    m2 = make_model(
        [node("Optional", [], ["opt"]),
         node("OptionalHasElement", ["opt"], ["has"])],
        {"x": x}, ["has"])
    assert not bool(_both(m2, {"x": x})["has"])

    m3 = make_model(
        [node("Optional", [], ["opt"]),
         node("OptionalGetElement", ["opt"], ["y"])],
        {"x": x}, ["y"])
    _raises_both(m3, {"x": x}, "empty optional")


def test_optional_of_sequence_and_plain_passthrough():
    """An optional holding a sequence; OptionalHasElement /
    OptionalGetElement on a plain tensor (opset 18 passthrough)."""
    a = rng.standard_normal((3,)).astype(np.float32)
    m = make_model(
        [node("SequenceConstruct", ["a", "a"], ["seq"]),
         node("Optional", ["seq"], ["opt"]),
         node("OptionalGetElement", ["opt"], ["seq2"]),
         node("ConcatFromSequence", ["seq2"], ["out"], axis=0),
         node("OptionalHasElement", ["a"], ["has"]),
         node("OptionalGetElement", ["a"], ["same"])],
        {"a": a}, ["out", "has", "same"])
    out = _both(m, {"a": a})
    assert bool(out["has"])
    np.testing.assert_array_equal(out["out"], np.concatenate([a, a]))
