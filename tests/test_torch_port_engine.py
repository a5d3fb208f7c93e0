"""The PyTorch port's engine, emitters and quantizer on small graphs, held
against the JAX package on the CPU: a narrow SqueezeNet-shaped model in
fp32 and INT8 (the whole slice in a fraction of a second), each ported
emitter against its JAX counterpart, the run-time Shape propagation, and
the device guard (no card: no silent CPU)."""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models._builder import GraphBuilder
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import (
    Engine, build_squeezenet, calibrate, import_model, quantize_graph)
from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import assert_graphs_equal, run_op_port, to_port
from util import run_op


def _narrow_model(opset: int):
    """SqueezeNet's op mix at C <= 32 on a 32x32 input: a 7x7/2 stem, a
    ceil_mode max-pool, one fire module (1x1 squeeze, 1x1 and padded 3x3
    expands, Concat), a padded max-pool, Dropout, a 1x1 head,
    GlobalAveragePool and Softmax."""
    b = GraphBuilder("narrow", opset=opset, seed=4)
    x = b.input("x", [2, 3, 32, 32])

    def conv(x, name, cin, cout, k, stride=1, pad=0):
        w = b.he(f"{name}_w", (cout, cin, k, k))
        bias = b.init(f"{name}_b",
                      (b.rng.standard_normal(cout) * 0.1).astype(np.float32))
        y = b.op("Conv", x, w, bias, kernel_shape=[k, k],
                 strides=[stride, stride], pads=[pad] * 4)
        return b.op("Relu", y)

    y = conv(x, "stem", 3, 16, 7, stride=2, pad=3)
    y = b.op("MaxPool", y, kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1)
    s = conv(y, "squeeze", 16, 8, 1)
    y = b.op("Concat", conv(s, "e1", 8, 16, 1), conv(s, "e3", 8, 16, 3,
                                                    pad=1), axis=1)
    y = b.op("MaxPool", y, kernel_shape=[2, 2], strides=[2, 2],
             pads=[0, 0, 1, 1])
    y = b.op("Dropout", y, ratio=0.5)
    y = conv(y, "head", 32, 10, 1)
    y = b.op("GlobalAveragePool", y)
    b.output(b.node("Softmax", [y], ["prob"])[0])
    return b.model()


def _feed():
    x = np.random.default_rng(9).standard_normal((2, 3, 32, 32))
    return {"x": x.astype(np.float32)}


def _port_probe(graph, feed):
    out = Engine(probe_graph(graph), device="cpu")(feed)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("opset", [8, 13])
def test_narrow_model_fp32_matches_jax(opset):
    m = _narrow_model(opset)
    want = JEngine(j_import(m)).run(_feed())["prob"]
    got = Engine(to_port(m), device="cpu").run(_feed())["prob"]
    assert got.shape == want.shape == (2, 10, 1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("opset", [8, 13])
def test_narrow_model_int8_matches_jax(opset):
    m = _narrow_model(opset)
    jg, tg = j_import(m), to_port(m)
    ranges = j_calibrate(jg, [_feed()])
    jq, tq = j_quantize(jg, ranges=ranges), quantize_graph(tg, ranges=ranges)
    assert_graphs_equal(jq, tq)
    assert sum(n.op_type == "QLinearConv" for n in tq.nodes) == 5
    want, got = dump_intermediates(jq, _feed()), _port_probe(tq, _feed())
    assert sorted(got) == sorted(want)
    n_eq = n_all = 0
    for name, w in want.items():
        if w.dtype == np.int8:
            diff = np.abs(got[name].astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, f"{name}: max |diff| {diff.max()}"
            n_eq += int((got[name] == w).sum())
            n_all += w.size
    assert n_eq / n_all > 0.99, n_eq / n_all
    err = float(np.abs(got["prob"] - want["prob"]).max())
    assert err <= 1e-3, f"softmax max abs err {err}"


# percentile: the port interpolates in float32 as jnp.quantile(|x|, q / 100)
# does, bit for bit; jnp.percentile itself lands up to ~5e-4 of a step
# between neighbours away from that (its q / 100 path), hence 1e-3 there
# mse: the same grid (each tensor's amax x linspace(0.3, 1, 15)) and the
# same argmin, so the same range within 1e-6
@pytest.mark.parametrize("method,rtol", [("minmax", 1e-4),
                                         ("percentile", 1e-3),
                                         ("mse", 1e-6)])
def test_calibration_methods_match_jax(method, rtol):
    m = _narrow_model(13)
    want = j_calibrate(j_import(m), [_feed(), _feed()], method=method)
    got = calibrate(to_port(m), [_feed(), _feed()], method=method,
                    device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=1e-6, err_msg=name)


def test_percentile_matches_jnp_quantile():
    import jax.numpy as jnp

    from onnx_rusty_inference_engine_tpu_torch.quant import _percentile

    a = np.abs(np.random.default_rng(0).standard_normal(8192)).astype(
        np.float32)
    for q in (50.0, 99.0, 99.99):
        want = float(jnp.quantile(jnp.asarray(a), np.float32(q) / 100))
        assert _percentile(torch.from_numpy(a), q) == want


def test_unknown_calibration_method_raises():
    """mse, once pinned here as a refusal, is ported (held against JAX in
    test_calibration_methods_match_jax); a method neither package has is
    refused."""
    with pytest.raises(ValueError, match="entropy"):
        calibrate(to_port(_narrow_model(13)), [_feed()], method="entropy",
                  device="cpu")


def _close(got, want, exact):
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


_RNG = np.random.default_rng(17)
_F = _RNG.standard_normal((2, 4, 9, 10)).astype(np.float32)
_I8 = _RNG.integers(-128, 128, (2, 4, 9, 10), dtype=np.int8)

# (op, inputs, initializers, opset, attrs, exact)
EMITTER_CASES = {
    "conv_asym_pad_dilation": (
        "Conv", {"x": _F}, {"w": _RNG.standard_normal((6, 4, 3, 3)).astype(
            np.float32)}, 13,
        dict(kernel_shape=[3, 3], pads=[2, 0, 1, 1], dilations=[2, 1],
             strides=[1, 2]), False),
    "conv_grouped_same_upper": (
        "Conv", {"x": _F}, {"w": _RNG.standard_normal((4, 2, 3, 3)).astype(
            np.float32)}, 13,
        dict(kernel_shape=[3, 3], group=2, auto_pad="SAME_UPPER"), False),
    "conv1d": (
        "Conv", {"x": _F[:, :, 0]}, {"w": _RNG.standard_normal(
            (5, 4, 3)).astype(np.float32)}, 13,
        dict(kernel_shape=[3], pads=[1, 2], strides=[2]), False),
    "maxpool1d": ("MaxPool", {"x": _F[:, :, 0]}, None, 13,
                  dict(kernel_shape=[3], strides=[2], pads=[1, 0]), True),
    "maxpool_ceil": ("MaxPool", {"x": _F}, None, 13,
                     dict(kernel_shape=[3, 3], strides=[2, 2], ceil_mode=1),
                     True),
    "maxpool_pads_dilation": ("MaxPool", {"x": _F}, None, 13,
                              dict(kernel_shape=[2, 3], pads=[1, 0, 1, 2],
                                   dilations=[2, 1]), True),
    "maxpool_int8_padded": ("MaxPool", {"x": _I8}, None, 13,
                            dict(kernel_shape=[3, 3], strides=[2, 2],
                                 pads=[1, 1, 1, 1]), True),
    "relu_f32": ("Relu", {"x": _F}, None, 13, {}, True),
    "relu_int8": ("Relu", {"x": _I8}, None, 13, {}, True),
    "concat_int8": ("Concat", {"a": _I8, "b": _I8[:, :2]}, None, 13,
                    dict(axis=1), True),
    "global_average_pool": ("GlobalAveragePool", {"x": _F}, None, 13, {},
                            False),
    "softmax_opset8_flatten": ("Softmax", {"x": _F}, None, 8, {}, False),
    "softmax_opset8_axis2": ("Softmax", {"x": _F}, None, 8, dict(axis=2),
                             False),
    "softmax_opset13_axis1": ("Softmax", {"x": _F}, None, 13, dict(axis=1),
                              False),
}


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    op, inputs, inits, opset, attrs, exact = EMITTER_CASES[case]
    (want,) = run_op(op, inputs, inits, opset=opset, **attrs)
    (got,) = run_op_port(op, inputs, inits, opset=opset, **attrs)
    _close(got, want, exact)


def _graph_output_dropout():
    """Dropout whose outputs are graph outputs survives import, so its
    emitter runs (inference: identity and an all-true mask)."""
    b = GraphBuilder("drop", opset=13)
    x = b.input("x", [2, 3])
    b.node("Dropout", [x], ["y", "mask"])
    b.output("y")
    b.output("mask", dtype=np.bool_)
    return b.model()


def test_dropout_is_identity_with_true_mask():
    x = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    m = _graph_output_dropout()
    want = JEngine(j_import(m)).run({"x": x})
    got = Engine(to_port(m), device="cpu").run({"x": x})
    np.testing.assert_array_equal(got["y"], want["y"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["mask"].dtype == np.bool_ and got["mask"].all()


def test_shape_chain_is_propagated_at_run_time():
    """Shape and Size of a batch-symbolic input cannot fold at import; the
    engine resolves them, and foldable arithmetic on them, from the input's
    shape, as the JAX lowering does at trace time."""
    b = GraphBuilder("shape", opset=13)
    x = b.input("x", ["N", 4, 2, 2])
    n = b.op("Gather", b.op("Shape", x),
             b.init("zero", np.array(0, np.int64)), axis=0)
    b.output(b.node("Mul", [n, b.init("two", np.array(2, np.int64))],
                    ["n2"])[0])
    b.output(b.node("Size", [x], ["size"])[0])
    b.output(b.node("Relu", [x], ["y"])[0])
    m = b.model()
    x = np.random.default_rng(3).standard_normal((3, 4, 2, 2)).astype(
        np.float32)
    tg = to_port(m)
    assert {"Shape", "Size"} <= {nd.op_type for nd in tg.nodes}
    got = Engine(tg, device="cpu").run({"x": x})
    want = JEngine(j_import(m)).run({"x": x})
    assert int(got["n2"]) == int(want["n2"]) == 6
    assert int(got["size"]) == int(want["size"]) == 48
    np.testing.assert_array_equal(got["y"], want["y"])


def test_inference_result_top1():
    g = import_model(build_squeezenet())
    x = np.random.default_rng(2).standard_normal((2, 3, 224, 224)).astype(
        np.float32)
    res = Engine(g, device="cpu").run({"data_0": x})
    probs = res["softmaxout_1"].reshape(2, -1)
    np.testing.assert_array_equal(res.top1(), probs.argmax(1))
    assert res.latency_s > 0


def test_no_card_no_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from onnx_rusty_inference_engine_tpu_torch.utils.timing import (
        device_loop_timer, engine_throughput)

    g = to_port(_narrow_model(13))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(g, [_feed()])
    with pytest.raises(RuntimeError, match="CUDA device"):
        engine_throughput(Engine(g, device="cpu"), _feed())
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_loop_timer(lambda c: c, None)


def test_unported_ops_and_dtypes_raise_at_build():
    # CastMap: the one spec op neither package has (docs/spec_ops_*.txt)
    b = GraphBuilder("castmap", opset=13)
    x = b.input("x", [2, 4])
    b.output(b.node("CastMap", [x], ["y"], domain="ai.onnx.ml")[0])
    with pytest.raises(UnsupportedOpError, match="CastMap"):
        Engine(to_port(b.model()), device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Engine(to_port(_narrow_model(13)), device="cpu", dtype="float16")
    # the bf16 policy is ported: it builds, and runs as JAX's does
    m = _narrow_model(13)
    x = np.random.default_rng(8).standard_normal(
        _feed()["x"].shape).astype(np.float32)
    got = Engine(to_port(m), device="cpu", dtype="bfloat16").run({"x": x})
    want = JEngine(j_import(m), dtype="bfloat16").run({"x": x})
    for k, v in want.outputs.items():
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0,
                                   atol=1e-5 * float(np.abs(v).max()))


def test_collector_held_nests_across_threads_and_restores():
    """collector_held keeps the cycle collector off from the first hold to
    the end of the last, nested or on other threads, and restores the
    state the first hold found: on stays on, off stays off."""
    import gc
    import threading

    from onnx_rusty_inference_engine_tpu_torch.engine import collector_held

    was = gc.isenabled()
    try:
        for start in (True, False):
            gc.enable() if start else gc.disable()
            inner_ready, outer_done = threading.Event(), threading.Event()
            seen = []

            def other():
                with collector_held():
                    inner_ready.set()
                    outer_done.wait(5)
                    seen.append(gc.isenabled())

            with collector_held():
                assert not gc.isenabled()
                with collector_held():
                    assert not gc.isenabled()
                assert not gc.isenabled()
                t = threading.Thread(target=other)
                t.start()
                assert inner_ready.wait(5)
            outer_done.set()
            t.join(5)
            assert seen == [False]     # the other thread's hold outlived ours
            assert gc.isenabled() == start
    finally:
        gc.enable() if was else gc.disable()
