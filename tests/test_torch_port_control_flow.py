"""The port's If / Scan / Loop emitters (ops/control_flow.py) and its
LoweringContext.eval_subgraph against the JAX package's, on the CPU.

Each model is built once with the JAX package's codec, sent through a wire
round trip, and run by both Engines on the same inputs from a seeded numpy
generator: tests/test_control_flow.py's cases (its If's predicate takes
ReduceMax where that test takes ReduceSum, which the port lacks), an If on
a run-time predicate with both values and with branches that disagree, a
Scan over two scan inputs on other axes with a reversed input and output,
a Loop that exits early over a MatMul body, the iteration counter, nested
control flow, a Shape folded inside a body, SequenceMap over a MatMul
body, and the subgraph initializers made once per Engine. Tolerances:
rtol 1e-5, atol 1e-6 where a body is elementwise; 1e-5 x max|ref| where it
holds a MatMul (XLA and PyTorch sum in another order); exact for integers.

Also the port's repair of passes._consumer_count: a tensor that only a
subgraph reads counts as consumed, so a fusion keeps it.
"""

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.ops.registry import (
    UnsupportedOpError as JUnsupported)
from onnx_rusty_inference_engine_tpu_torch import passes as t_passes
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops import registry as t_registry
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import to_port
from util import make_model, node

rng = np.random.default_rng(97)


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
    """(JAX's outputs, the port's outputs) of one model and feed."""
    m2 = _wire(model)
    want = JEngine(j_import(m2)).run(feeds).outputs
    got = Engine(to_port(m2), device="cpu").run(feeds).outputs
    assert sorted(got) == sorted(want)
    return want, got


def _close(got, want, matmul=False):
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if matmul:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _raises_both(model, feeds, match):
    m2 = _wire(model)
    with pytest.raises(JUnsupported, match=match):
        JEngine(j_import(m2)).run(feeds)
    with pytest.raises(UnsupportedOpError, match=match):
        Engine(to_port(m2), device="cpu").run(feeds)


# --------------------------------------------------------------------------
# If
# --------------------------------------------------------------------------
def _if_model(x):
    then_g = _subgraph("then", [node("Add", ["y", "y"], ["t_out"])],
                       outputs=["t_out"])
    else_g = _subgraph("else", [node("Neg", ["y"], ["e_out"])],
                       outputs=["e_out"])
    nodes = [
        node("Relu", ["x"], ["y"]),
        node("ReduceMax", ["y"], ["s"], keepdims=0),
        node("Greater", ["s", "zero"], ["pred"]),
        node("If", ["pred"], ["out0"], then_branch=then_g,
             else_branch=else_g),
    ]
    return make_model(nodes, {"x": x}, ["out0"], {"zero": np.float32(0.0)})


@pytest.mark.parametrize("flip", [False, True], ids=["then", "else"])
def test_if_with_captures_runtime_predicate(flip):
    """Both branches close over an outer tensor (y); the predicate is
    computed at run time, both of its values."""
    x = rng.standard_normal((3, 4)).astype(np.float32)
    if flip:
        x = -np.abs(x) - 1
    want, got = _both(_if_model(x), {"x": x})
    _close(got, want)
    y = np.maximum(x, 0)
    np.testing.assert_allclose(got["out0"], -y if flip else y + y,
                               rtol=1e-6)


def test_if_constant_predicate_prunes():
    then_g = _subgraph("then", [node("Add", ["x", "x"], ["o"])],
                       outputs=["o"])
    else_g = _subgraph("else", [node("Neg", ["x"], ["o"])], outputs=["o"])
    x = rng.standard_normal((2, 2)).astype(np.float32)
    m = make_model(
        [node("If", ["p"], ["out0"], then_branch=then_g, else_branch=else_g)],
        {"x": x}, ["out0"], {"p": np.array(True)})
    want, got = _both(m, {"x": x})
    _close(got, want)
    np.testing.assert_allclose(got["out0"], x + x)


def test_if_runtime_predicate_branch_shapes_must_agree():
    """A run-time predicate runs both branches: they must agree in shape,
    as lax.cond requires (JAX refuses too, with its own error)."""
    then_g = _subgraph("then", [node("Add", ["x", "x"], ["o"])],
                       outputs=["o"])
    else_g = _subgraph("else", [node("ReduceMax", ["x"], ["o"],
                                     keepdims=0)], outputs=["o"])
    x = rng.standard_normal((2, 3)).astype(np.float32)
    m = make_model(
        [node("If", ["p"], ["out0"], then_branch=then_g, else_branch=else_g)],
        {"x": x, "p": np.array(True)}, ["out0"])
    with pytest.raises(UnsupportedOpError, match="agree in shape"):
        Engine(to_port(_wire(m)), device="cpu").run(
            {"x": x, "p": np.array(True)})
    with pytest.raises(Exception):
        JEngine(j_import(_wire(m))).run({"x": x, "p": np.array(True)})


@pytest.mark.parametrize("p", [True, False])
def test_if_runtime_predicate_matmul_branches(p):
    """Branches with MatMuls and their own initializers, two outputs, the
    predicate a graph input."""
    x = rng.standard_normal((6, 8)).astype(np.float32)
    wa = rng.standard_normal((8, 5)).astype(np.float32)
    wb = rng.standard_normal((8, 5)).astype(np.float32)
    then_g = _subgraph("then", [node("MatMul", ["x", "wa"], ["o"]),
                                node("Relu", ["o"], ["o2"])],
                       outputs=["o", "o2"], initializers={"wa": wa})
    else_g = _subgraph("else", [node("MatMul", ["x", "wb"], ["o"]),
                                node("Neg", ["o"], ["o2"])],
                       outputs=["o", "o2"], initializers={"wb": wb})
    m = make_model(
        [node("If", ["p"], ["a", "b"], then_branch=then_g,
              else_branch=else_g)],
        {"x": x, "p": np.array(p)}, ["a", "b"])
    want, got = _both(m, {"x": x, "p": np.array(p)})
    _close(got, want, matmul=True)


# --------------------------------------------------------------------------
# Scan
# --------------------------------------------------------------------------
def test_scan_running_sum():
    body = _subgraph(
        "body",
        [node("Add", ["acc_in", "x_t"], ["acc_out"]),
         node("Mul", ["acc_out", "two"], ["y_t"])],
        inputs=["acc_in", "x_t"], outputs=["acc_out", "y_t"],
        initializers={"two": np.float32(2.0)})
    T, D = 5, 3
    xs = rng.standard_normal((T, D)).astype(np.float32)
    init = np.zeros((D,), np.float32)
    m = make_model(
        [node("Scan", ["init", "xs"], ["final", "ys"], body=body,
              num_scan_inputs=1)],
        {"init": init, "xs": xs}, ["final", "ys"])
    want, got = _both(m, {"init": init, "xs": xs})
    _close(got, want)
    np.testing.assert_allclose(got["ys"], 2 * np.cumsum(xs, 0), rtol=1e-5)


def test_scan_reverse_direction():
    body = _subgraph(
        "body", [node("Add", ["a", "x_t"], ["a2"])],
        inputs=["a", "x_t"], outputs=["a2"])
    xs = rng.standard_normal((4, 2)).astype(np.float32)
    init = np.zeros((2,), np.float32)
    m = make_model(
        [node("Scan", ["init", "xs"], ["final"], body=body,
              num_scan_inputs=1, scan_input_directions=[1])],
        {"init": init, "xs": xs}, ["final"])
    want, got = _both(m, {"init": init, "xs": xs})
    _close(got, want)


@pytest.mark.parametrize("in_dirs,out_dir", [([1, 0], 1), ([0, 1], 0),
                                             ([1, 1], 1)])
def test_scan_two_inputs_axes_and_directions(in_dirs, out_dir):
    """Two scan inputs, the second scanned over its axis 1, a state through
    a MatMul with a captured weight, a scan output stacked on axis 1 in
    either direction."""
    T, B, D = 6, 3, 4
    xs = rng.standard_normal((T, B, D)).astype(np.float32)
    zs = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((D, D)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    body = _subgraph(
        "body",
        [node("MatMul", ["h", "w"], ["hw"]),
         node("Add", ["hw", "x_t"], ["s"]),
         node("Mul", ["s", "z_t"], ["s2"]),
         node("Tanh", ["s2"], ["h2"]),
         node("Sub", ["h2", "x_t"], ["y"])],
        inputs=["h", "x_t", "z_t"], outputs=["h2", "y"])
    m = make_model(
        [node("Scan", ["h0", "xs", "zs"], ["hT", "ys"], body=body,
              num_scan_inputs=2, scan_input_axes=[0, 1],
              scan_input_directions=in_dirs, scan_output_axes=[1],
              scan_output_directions=[out_dir])],
        {"h0": h0, "xs": xs, "zs": zs}, ["hT", "ys"], {"w": w})
    want, got = _both(m, {"h0": h0, "xs": xs, "zs": zs})
    assert got["ys"].shape == (B, T, D)
    _close(got, want, matmul=True)


def test_scan_body_shape_folds():
    """A Shape -> Gather -> Concat -> Reshape chain inside the body folds
    to static values, as the port folds it in the main graph. The JAX
    lowering folds no Shape inside a subgraph (its Reshape refuses the
    shape), so numpy is the reference here."""
    xs = rng.standard_normal((3, 2, 6)).astype(np.float32)
    body = _subgraph(
        "body",
        [node("Shape", ["x_t"], ["shp"]),
         node("Gather", ["shp", "i0"], ["d0"], axis=0),
         node("Concat", ["d0", "m1"], ["tgt"], axis=0),
         node("Reshape", ["x_t", "tgt"], ["r"]),
         node("Add", ["acc", "r"], ["acc2"])],
        inputs=["acc", "x_t"], outputs=["acc2", "r"],
        initializers={"i0": np.array([0], np.int64),
                      "m1": np.array([-1], np.int64)})
    acc = np.zeros((2, 6), np.float32)
    m = make_model(
        [node("Scan", ["acc0", "xs"], ["accT", "rs"], body=body,
              num_scan_inputs=1)],
        {"acc0": acc, "xs": xs}, ["accT", "rs"])
    got = Engine(to_port(_wire(m)), device="cpu").run(
        {"acc0": acc, "xs": xs}).outputs
    np.testing.assert_array_equal(got["rs"], xs)
    np.testing.assert_allclose(got["accT"], xs.sum(0), rtol=1e-6)


# --------------------------------------------------------------------------
# Loop
# --------------------------------------------------------------------------
def test_loop_fixed_trip_count():
    body = _subgraph(
        "body",
        [node("Identity", ["cond_in"], ["cond_out"]),
         node("Add", ["s_in", "x"], ["s_out"]),
         node("Identity", ["s_out"], ["y_t"])],
        inputs=["iter", "cond_in", "s_in"],
        outputs=["cond_out", "s_out", "y_t"])
    x = rng.standard_normal((3,)).astype(np.float32)
    s0 = np.zeros((3,), np.float32)
    m = make_model(
        [node("Loop", ["M", "cond", "s0"], ["s_final", "ys"], body=body)],
        {"s0": s0, "x": x}, ["s_final", "ys"],
        {"M": np.array(4, np.int64), "cond": np.array(True)})
    want, got = _both(m, {"s0": s0, "x": x})
    _close(got, want)
    np.testing.assert_allclose(got["ys"], np.stack([x, 2 * x, 3 * x, 4 * x]),
                               rtol=1e-5)


def test_loop_early_exit_state_freezes():
    body = _subgraph(
        "body",
        [node("Add", ["s_in", "one"], ["s_out"]),
         node("Less", ["s_out", "three"], ["cond_out"])],
        inputs=["iter", "cond_in", "s_in"],
        outputs=["cond_out", "s_out"],
        initializers={"one": np.float32(1.0), "three": np.float32(3.0)})
    s0 = np.zeros((), np.float32)
    m = make_model(
        [node("Loop", ["M", "cond", "s0"], ["s_final"], body=body)],
        {"s0": s0}, ["s_final"],
        {"M": np.array(10, np.int64), "cond": np.array(True)})
    want, got = _both(m, {"s0": s0})
    _close(got, want)
    np.testing.assert_allclose(got["s_final"], 3.0)


@pytest.mark.parametrize("cond0", [True, False])
def test_loop_matmul_body_exits_early(cond0):
    """32 trips over a matrix state through a MatMul; the body's condition
    (the state's max under a bound) goes false part way, and a run-time
    initial condition of False runs no trip at all."""
    n = 16
    s0 = (rng.standard_normal((n, n)) * 0.1).astype(np.float32)
    w = (np.eye(n) * 1.2 + rng.standard_normal((n, n)) * 0.05).astype(
        np.float32)
    body = _subgraph(
        "body",
        [node("MatMul", ["s_in", "w"], ["s_mm"]),
         node("Add", ["s_mm", "s_in"], ["s_out"]),
         node("ReduceMax", ["s_out"], ["mx"], keepdims=0),
         node("Less", ["mx", "bound"], ["cond_out"])],
        inputs=["iter", "cond_in", "s_in"], outputs=["cond_out", "s_out"],
        initializers={"bound": np.float32(50.0)})
    feeds = {"s0": s0, "c0": np.array(cond0)}
    m = make_model(
        [node("Loop", ["M", "c0", "s0"], ["s_final"], body=body)],
        feeds, ["s_final"], {"M": np.array(32, np.int64), "w": w})
    want, got = _both(m, feeds)
    _close(got, want, matmul=True)
    if not cond0:
        np.testing.assert_array_equal(got["s_final"], s0)
    else:
        assert np.abs(got["s_final"]).max() < 200  # froze, not 32 trips


def test_loop_iteration_counter():
    """The body reads its iteration counter (cast to float) and emits it
    as a scan output: exact."""
    body = _subgraph(
        "body",
        [node("Identity", ["cond_in"], ["cond_out"]),
         node("Cast", ["iter"], ["fi"], to=onnx_io.FLOAT),
         node("Add", ["s_in", "fi"], ["s_out"]),
         node("Identity", ["iter"], ["it"])],
        inputs=["iter", "cond_in", "s_in"],
        outputs=["cond_out", "s_out", "it"])
    s0 = np.zeros((2,), np.float32)
    m = make_model(
        [node("Loop", ["M", "", "s0"], ["s_final", "its"], body=body)],
        {"s0": s0}, ["s_final", "its"], {"M": np.array(5, np.int64)})
    want, got = _both(m, {"s0": s0})
    np.testing.assert_array_equal(got["s_final"], want["s_final"])
    np.testing.assert_array_equal(got["its"].astype(np.int64),
                                  np.asarray(want["its"]).astype(np.int64))
    np.testing.assert_array_equal(got["s_final"], [10.0, 10.0])


def test_loop_dynamic_trip_count_rejected():
    body = _subgraph(
        "body",
        [node("Identity", ["cond_in"], ["cond_out"]),
         node("Identity", ["s_in"], ["s_out"])],
        inputs=["iter", "cond_in", "s_in"],
        outputs=["cond_out", "s_out"])
    s0 = np.zeros((2,), np.float32)
    m = make_model(
        [node("Loop", ["M", "cond", "s0"], ["s_final"], body=body)],
        {"s0": s0, "M": np.array(4, np.int64)}, ["s_final"],
        {"cond": np.array(True)})
    _raises_both(m, {"s0": s0, "M": np.array(4, np.int64)},
                 "trip count must be statically known")


def test_loop_body_dynamic_cond_with_scan_outputs_rejected():
    body = _subgraph(
        "body",
        [node("Add", ["s_in", "one"], ["s_out"]),
         node("Less", ["s_out", "three"], ["cond_out"]),
         node("Identity", ["s_out"], ["y_t"])],
        inputs=["iter", "cond_in", "s_in"],
        outputs=["cond_out", "s_out", "y_t"],
        initializers={"one": np.float32(1.0), "three": np.float32(3.0)})
    s0 = np.zeros((), np.float32)
    m = make_model(
        [node("Loop", ["M", "cond", "s0"], ["s_final", "ys"], body=body)],
        {"s0": s0}, ["s_final", "ys"],
        {"M": np.array(10, np.int64), "cond": np.array(True)})
    _raises_both(m, {"s0": s0}, "per-iteration scan outputs")


# --------------------------------------------------------------------------
# nesting, SequenceMap, subgraph initializers
# --------------------------------------------------------------------------
def test_if_inside_loop_inside_scan():
    """Scan over rows; its body runs a 3-trip Loop whose body holds an If
    on a run-time predicate; every level closes over the outer scope."""
    T, D = 4, 5
    xs = rng.standard_normal((T, D)).astype(np.float32)
    scale = np.float32(0.5)
    then_g = _subgraph("then", [node("Mul", ["v_in", "k"], ["o"])],
                       outputs=["o"])
    else_g = _subgraph("else", [node("Sub", ["v_in", "k"], ["o"])],
                       outputs=["o"])
    loop_body = _subgraph(
        "loop_body",
        [node("Identity", ["c_in"], ["c_out"]),
         node("ReduceMax", ["v_in"], ["mx"], keepdims=0),
         node("Greater", ["mx", "zero"], ["p"]),
         node("If", ["p"], ["v_out"], then_branch=then_g,
              else_branch=else_g)],
        inputs=["i", "c_in", "v_in"], outputs=["c_out", "v_out"])
    scan_body = _subgraph(
        "scan_body",
        [node("Add", ["acc", "x_t"], ["a1"]),
         node("Loop", ["three", "", "a1"], ["a2"], body=loop_body)],
        inputs=["acc", "x_t"], outputs=["a2", "a1"],
        initializers={"three": np.array(3, np.int64)})
    acc0 = np.zeros((D,), np.float32)
    m = make_model(
        [node("Scan", ["acc0", "xs"], ["accT", "pre"], body=scan_body,
              num_scan_inputs=1)],
        {"acc0": acc0, "xs": xs}, ["accT", "pre"],
        {"k": scale, "zero": np.float32(0.0)})
    want, got = _both(m, {"acc0": acc0, "xs": xs})
    _close(got, want)


def test_sequence_map_matmul_body():
    """SequenceMap over a sequence of matrices through a MatMul body with
    its own initializer and a broadcast extra input."""
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4)).astype(np.float32)
    bias = rng.standard_normal((6,)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    body = _subgraph(
        "body", [node("MatMul", ["e", "w"], ["m0"]),
                 node("Add", ["m0", "bias"], ["o"])],
        inputs=["e", "bias"], outputs=["o"], initializers={"w": w})
    m = make_model(
        [node("SequenceConstruct", ["a", "b"], ["xs"]),
         node("SequenceMap", ["xs", "bias"], ["ys"], body=body),
         node("ConcatFromSequence", ["ys"], ["out"], axis=0, new_axis=1)],
        {"a": a, "b": b, "bias": bias}, ["out"])
    want, got = _both(m, {"a": a, "b": b, "bias": bias})
    _close(got, want, matmul=True)


def test_subgraph_initializers_made_once(monkeypatch):
    """A body's initializers become device tensors when the Engine is made,
    once: no run (and no Scan trip) makes them again."""
    body = _subgraph(
        "body", [node("Add", ["a", "x_t"], ["a1"]),
                 node("Mul", ["a1", "two"], ["a2"])],
        inputs=["a", "x_t"], outputs=["a2"],
        initializers={"two": np.float32(2.0)})
    xs = rng.standard_normal((5, 2)).astype(np.float32)
    init = np.zeros((2,), np.float32)
    m = make_model(
        [node("Scan", ["init", "xs"], ["final"], body=body,
              num_scan_inputs=1)],
        {"init": init, "xs": xs}, ["final"])
    eng = Engine(to_port(_wire(m)), device="cpu")
    made = []
    real = t_registry._prepare
    monkeypatch.setattr(t_registry, "_prepare",
                        lambda g, d: made.append(g) or real(g, d))
    first = eng.run({"init": init, "xs": xs})["final"]
    second = eng.run({"init": init, "xs": xs})["final"]
    assert made == []
    np.testing.assert_array_equal(first, second)
    want, _ = _both(m, {"init": init, "xs": xs})
    np.testing.assert_allclose(first, want["final"], rtol=1e-5, atol=1e-6)


def test_unsupported_op_in_body_fails_at_build():
    body = _subgraph("body", [node("NoSuchOp", ["a", "x_t"], ["a1"])],
                     inputs=["a", "x_t"], outputs=["a1"])
    xs = np.zeros((2, 2), np.float32)
    m = make_model(
        [node("Scan", ["init", "xs"], ["final"], body=body,
              num_scan_inputs=1)],
        {"init": xs[0], "xs": xs}, ["final"])
    with pytest.raises(UnsupportedOpError, match="NoSuchOp"):
        Engine(to_port(_wire(m)), device="cpu")


# --------------------------------------------------------------------------
# passes: a tensor only a subgraph reads is consumed
# --------------------------------------------------------------------------
def _capture_fusion_model():
    """Conv -> Add(per-channel bias): a fusable pair, whose Conv output
    `c` an If branch also reads (a capture, and its only other reader)."""
    x = rng.standard_normal((1, 2, 5, 5)).astype(np.float32)
    w = rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    bias = rng.standard_normal((3, 1, 1)).astype(np.float32)
    then_g = _subgraph("then", [node("Relu", ["c"], ["t"])], outputs=["t"])
    else_g = _subgraph("else", [node("Neg", ["c"], ["t"])], outputs=["t"])
    m = make_model(
        [node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1]),
         node("Add", ["c", "bias"], ["y"]),
         node("If", ["p"], ["z"], then_branch=then_g, else_branch=else_g)],
        {"x": x, "p": np.array(True)}, ["y", "z"],
        {"w": w, "bias": bias})
    return m, {"x": x, "p": np.array(True)}


def test_consumer_count_counts_subgraph_captures():
    m, feeds = _capture_fusion_model()
    g = to_port(_wire(m))
    counts = t_passes._consumer_count(g)
    assert counts["c"] == 2  # the Add, and the If's branches


def test_fusion_keeps_a_tensor_a_subgraph_reads():
    """fuse_conv_bias_add must not fold the Conv into the Add (renaming
    its output) while an If branch still reads the Conv's output; the
    optimized graph runs and equals the plain one."""
    m, feeds = _capture_fusion_model()
    plain = Engine(to_port(_wire(m)), device="cpu").run(feeds).outputs
    g = t_passes.optimize(to_port(_wire(m)))
    assert "c" in {o for n in g.nodes for o in n.outputs}
    got = Engine(g, device="cpu").run(feeds).outputs
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k])


def test_subgraph_names_shadow_outer_constants():
    """A Scan body whose input and node output reuse the names of outer
    graph constants: inside the body those names are the body's values,
    not the outer constants (which fold statically outside)."""
    xs = rng.standard_normal((3, 4)).astype(np.float32)
    body = _subgraph(
        "body", [node("Add", ["a", "k"], ["w"]),
                 node("Mul", ["w", "k"], ["y"])],
        inputs=["a", "k"], outputs=["w", "y"])
    m = make_model(
        [node("Scan", ["a0", "xs"], ["aT", "ys"], body=body,
              num_scan_inputs=1),
         node("Add", ["aT", "w"], ["out"])],
        {"a0": xs[0], "xs": xs}, ["out", "ys"],
        {"k": np.float32(100.0), "w": np.float32(1000.0)})
    got = Engine(to_port(_wire(m)), device="cpu").run(
        {"a0": xs[0], "xs": xs}).outputs
    acc, ys = xs[0].copy(), []
    for t in range(3):
        acc = acc + xs[t]
        ys.append(acc * xs[t])
    np.testing.assert_allclose(got["ys"], np.stack(ys), rtol=1e-6)
    np.testing.assert_allclose(got["out"], acc + 1000.0, rtol=1e-6)
