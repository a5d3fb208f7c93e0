"""The slice end to end: SqueezeNet 1.0 at 224x224 through the PyTorch port
(on the CPU) against the JAX package, fp32 and INT8.

- fp32: the port's Engine matches tests/goldens/squeezenet.pb at the golden
  test's tolerance (rtol = atol = 1e-3). Every node's output, computed by
  the port from the JAX Engine's values of its inputs, matches JAX's at
  rtol = 1e-4, atol = 1e-5. Chained through the whole graph, the two
  frameworks' CPU convs sum in different orders and the differences grow
  over 26 convs (2.2e-5 at most, at conv10, whose values reach ~4), so
  there atol is 1e-5 times the tensor's largest magnitude (at least 1).
- INT8: given the same calibration ranges, both packages' quantize_graph
  build the same graph node for node; the int8 intermediates agree in more
  than 99% of elements and within 1 LSB (requant ties may fall either
  way), the softmax within 1e-3 with the same top-1. The port's own
  calibration matches JAX's ranges at rtol = 1e-4.
"""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu.graph import (
    export_model as j_export, import_model as j_import)
from onnx_rusty_inference_engine_tpu.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
from onnx_rusty_inference_engine_tpu_torch.engine import Engine, lower
from onnx_rusty_inference_engine_tpu_torch.graph import Graph, InputSpec
from onnx_rusty_inference_engine_tpu_torch.quant import (
    calibrate as t_calibrate, quantize_graph as t_quantize)
from onnx_rusty_inference_engine_tpu_torch.weights import params_from_numpy
from torch_port_util import assert_graphs_equal, to_port

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "squeezenet.pb")


def _golden_input() -> np.ndarray:
    """The input test_regression_goldens.py::_cases draws for squeezenet:
    default_rng(123) after the three draws before it."""
    rng = np.random.default_rng(123)
    rng.standard_normal((1, 3, 64, 64))
    rng.standard_normal((1, 3, 96, 96))
    rng.integers(0, 128, (1, 8))
    return rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


def _port_intermediates(graph, feed):
    probe = probe_graph(graph)
    params = params_from_numpy(
        {k: graph.constants[k] for k in graph.weight_names}, "cpu")
    out = lower(probe, "cpu")(params, {k: params_from_numpy({k: v}, "cpu")[k]
                                       for k, v in feed.items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def model():
    m = build_squeezenet()
    return j_import(m), to_port(m)


@pytest.fixture(scope="module")
def feed():
    x = np.random.default_rng(1).standard_normal((2, 3, 224, 224))
    return {"data_0": x.astype(np.float32)}


@pytest.fixture(scope="module")
def ranges(model, feed):
    return j_calibrate(model[0], [feed])


@pytest.fixture(scope="module")
def int8(model, ranges, feed):
    jq = j_quantize(model[0], ranges=ranges)
    tq = t_quantize(model[1], ranges=ranges)
    return jq, tq, dump_intermediates(jq, feed), _port_intermediates(tq, feed)


def test_fp32_matches_golden(model):
    golden = j_io.read_tensor_file(GOLDEN).array
    got = Engine(model[1], device="cpu").run(
        {"data_0": _golden_input()})["softmaxout_1"]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)


def _teacher_forced(graph, values):
    """Each node of `graph` run alone by the port, on `values` of its
    inputs: node output name -> numpy value."""
    out = {}
    for node in graph.nodes:
        feeds = [i for i in node.inputs if i and i not in graph.constants]
        one = Graph(name="one", nodes=[node], constants=graph.constants,
                    inputs=[InputSpec(i, values[i].shape, values[i].dtype)
                            for i in feeds],
                    outputs=[o for o in node.outputs if o],
                    opset=graph.opset, weight_names=graph.weight_names)
        params = params_from_numpy(
            {k: graph.constants[k] for k in graph.weight_names
             if k in node.inputs}, "cpu")
        res = lower(one, "cpu")(params, params_from_numpy(
            {i: values[i] for i in feeds}, "cpu"))
        out.update({k: v.numpy() for k, v in res.items()})
    return out


def test_fp32_each_node_matches_jax(model, feed):
    want = dump_intermediates(model[0], feed)
    got = _teacher_forced(model[1], want)
    assert len(got) == 65
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5,
            err_msg=f"{name}: max abs err {float(np.abs(g - w).max())}")


def test_fp32_intermediates_match_jax(model, feed):
    want = dump_intermediates(model[0], feed)
    got = _port_intermediates(model[1], feed)
    assert sorted(got) == sorted(want)
    assert len(got) == 66
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=1e-5 * scale,
            err_msg=f"{name}: max abs err {float(np.abs(g - w).max())}")


def test_port_calibration_matches_jax(model, feed, ranges):
    got = t_calibrate(model[1], [feed], device="cpu")
    assert sorted(got) == sorted(ranges)
    for name, (lo, hi) in ranges.items():
        np.testing.assert_allclose(got[name], (lo, hi), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_same_ranges_give_the_same_int8_graph(int8):
    jq, tq, _, _ = int8
    assert_graphs_equal(jq, tq)
    ops = [n.op_type for n in tq.nodes]
    assert ops.count("QLinearConv") == 26


def test_int8_intermediates_match_jax(int8):
    jq, tq, want, got = int8
    assert sorted(got) == sorted(want)
    n_eq = n_all = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, f"{name}: max |diff| {diff.max()}"
            n_eq += int((g == w).sum())
            n_all += w.size
    assert n_all > 0 and n_eq / n_all > 0.99, n_eq / n_all
    y_t, y_j = got["softmaxout_1"], want["softmaxout_1"]
    err = float(np.abs(y_t - y_j).max())
    assert err <= 1e-3, f"softmax max abs err {err}"
    assert (y_t.reshape(2, -1).argmax(1) == y_j.reshape(2, -1).argmax(1)).all()


def test_int8_graph_carried_as_onnx_bytes(feed, int8):
    """The JAX package's quantized graph, exported to ONNX bytes and read by
    the port: the int8 weights, scales and int32 biases arrive unchanged,
    and the port runs the file as the JAX package runs it.

    (The export writes opset 13 for this opset-10 graph, so the re-imported
    Softmax normalizes over its last axis, of size 1, in both packages;
    the logits before it still match the in-memory run.)"""
    jq, _, want, _ = int8
    buf = j_io.serialize_model(j_export(jq))
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model

    tg = import_model(t_io.parse_model(buf))
    jg = j_import(j_io.parse_model(buf))
    assert_graphs_equal(jg, tg)
    for n in tg.nodes:
        if n.op_type == "QLinearConv":
            for name in n.inputs[1:]:
                np.testing.assert_array_equal(tg.constants[name],
                                              jq.constants[name])
    got = _port_intermediates(tg, feed)
    from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine

    np.testing.assert_allclose(
        got["softmaxout_1"], JEngine(jg).run(feed)["softmaxout_1"],
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["pool10_1"], want["pool10_1"],
                               rtol=1e-4, atol=1e-4)
