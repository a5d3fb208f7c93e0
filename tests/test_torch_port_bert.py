"""BERT through the PyTorch port (on the CPU) against the JAX package: the
encoder's two new emitters (Slice, Tanh), the TINY model in fp32, and its
INT8 form, whose every QLinearMatMul runs on ops/kernels/qmatmul_int8.py.

Tolerances:
- Slice: exact. Tanh: rtol 1e-6, as each package calls its own
  framework's tanh;
- fp32 model: rtol 2e-4 / atol 2e-5, the JAX package's own BERT parity
  bound (tests/test_bert.py);
- calibration ranges: rtol 1e-4, as for SqueezeNet;
- INT8: with the same ranges the two quantized graphs are equal node for
  node; more than 99% of the int8 intermediates agree (an fp32 island's
  summation order can move a requant tie by one step) and the outputs lie
  within 1e-3 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.debug import dump_intermediates
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models.bert import (
    TINY as J_TINY, build_bert as j_build_bert)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu_torch import (
    Engine, calibrate, import_model, quantize_graph)
from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
from onnx_rusty_inference_engine_tpu_torch.models import build_bert
from onnx_rusty_inference_engine_tpu_torch.models.bert import TINY, BertConfig
from onnx_rusty_inference_engine_tpu_torch.ops import quantized
from torch_port_util import assert_graphs_equal, run_op_port
from util import run_op

B, T = 2, 12
OUTPUTS = ("last_hidden_state", "pooler_output")


# --------------------------------------------------------------------------
# (e) the emitters BERT adds: Slice and Tanh
# --------------------------------------------------------------------------
X = np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5) - 50.0

# (starts, ends, axes, steps); None leaves the optional input out
SLICE_CASES = {
    "cls_token": ([0], [1], [1], None),
    "negative_bounds": ([-3], [-1], [1], None),
    "clamped_end": ([2], [10 ** 9], [2], None),
    "negative_axis_step2": ([1], [6], [-2], [2]),
    "negative_step": ([-1], [-10 ** 9], [1], [-1]),
    "two_axes_default_axes": ([1, 2], [3, 6], None, None),
    "empty_range": ([4], [2], [1], None),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_slice_matches_jax(case):
    starts, ends, axes, steps = SLICE_CASES[case]
    inits = {"starts": np.array(starts, np.int64),
             "ends": np.array(ends, np.int64)}
    if axes is not None or steps is not None:
        inits["axes"] = np.array(axes if axes is not None
                                 else range(len(starts)), np.int64)
    if steps is not None:
        inits["steps"] = np.array(steps, np.int64)
    (want,) = run_op("Slice", {"x": X}, inits)
    (got,) = run_op_port("Slice", {"x": X}, inits)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axes", [[1, 2], None])
def test_slice_attribute_form_before_opset_10(axes):
    """Opset 1-9: starts / ends / axes are attributes; an end past the
    dimension clamps."""
    attrs = {"starts": [1, -2], "ends": [100, 5]}
    if axes is not None:
        attrs["axes"] = axes
    (want,) = run_op("Slice", {"x": X}, opset=9, **attrs)
    (got,) = run_op_port("Slice", {"x": X}, opset=9, **attrs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_tanh_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 7)).astype(np.float32) * 3
    (want,) = run_op("Tanh", {"x": x})
    (got,) = run_op_port("Tanh", {"x": x})
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# (f) BERT TINY end to end
# --------------------------------------------------------------------------
def _feed(seed: int = 0, *, min_len: int = 4):
    """Token ids, segment ids and a mask in which each row keeps a random
    length in [min_len, T] and pads the rest."""
    rng = np.random.default_rng(seed)
    keep = rng.integers(min_len, T + 1, (B, 1))
    return {"input_ids": rng.integers(0, TINY.vocab_size, (B, T)),
            "token_type_ids": rng.integers(0, 2, (B, T)),
            "attention_mask": (np.arange(T)[None] < keep).astype(np.int64)}


@pytest.fixture(scope="module")
def model():
    jm = j_build_bert(J_TINY, batch=B, seq_len=T)
    return j_import(jm), import_model(build_bert(TINY, batch=B, seq_len=T))


@pytest.fixture(scope="module")
def ranges(model):
    return j_calibrate(model[0], [_feed(1)])


@pytest.fixture(scope="module")
def int8(model, ranges):
    return (j_quantize(model[0], ranges=ranges),
            quantize_graph(model[1], ranges=ranges))


def test_config_and_builder_match_jax(model):
    """The port's copy builds the JAX package's graph, node for node and
    weight for weight; the import folds the constant position Gather in
    both (its [T, D] table stands under the Gather's output name)."""
    assert TINY == BertConfig(**vars(J_TINY))
    jg, tg = model
    assert_graphs_equal(jg, tg)
    assert "pos_e" in tg.constants and tg.constants["pos_e"].shape == (
        T, TINY.hidden)
    assert not any(n.outputs == ["pos_e"] for n in tg.nodes)


def test_fp32_matches_jax(model):
    feed = _feed(0)
    want = JEngine(model[0]).run(feed)
    got = Engine(model[1], device="cpu").run(feed)
    for name in OUTPUTS:
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    assert np.abs(got["pooler_output"]).max() <= 1.0


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_masked_positions_do_not_move_the_rest(model, int8, precision):
    """Changing the token ids only where the mask is 0 leaves every
    unmasked position's output as it was (the -1e9 bias makes their
    softmax weight exactly 0)."""
    graph = model[1] if precision == "fp32" else int8[1]
    eng = Engine(graph, device="cpu")
    feed = _feed(3)
    feed["attention_mask"][:, -4:] = 0
    ids = feed["input_ids"].copy()
    ids[:, -4:] = (ids[:, -4:] + 7) % TINY.vocab_size
    out1 = eng.run(feed)["last_hidden_state"]
    out2 = eng.run(dict(feed, input_ids=ids))["last_hidden_state"]
    np.testing.assert_allclose(out1[:, :T - 4], out2[:, :T - 4], rtol=1e-5,
                               atol=1e-5)


def test_port_calibration_matches_jax(model, ranges):
    got = calibrate(model[1], [_feed(1)], device="cpu")
    assert sorted(got) == sorted(ranges)
    for name, (lo, hi) in ranges.items():
        np.testing.assert_allclose(got[name], (lo, hi), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_same_ranges_give_the_same_int8_graph(int8):
    jq, tq = int8
    assert_graphs_equal(jq, tq)
    ops = [n.op_type for n in tq.nodes]
    # 6 weight MatMuls per layer + the pooler; the two activation x
    # activation attention MatMuls per layer stay fp32
    assert ops.count("QLinearMatMul") == 6 * TINY.n_layer + 1 == 13
    assert ops.count("MatMul") == 2 * TINY.n_layer


def test_int8_matches_jax(int8):
    jq, tq = int8
    feed = _feed(0)
    want = dump_intermediates(jq, feed)
    got = {k: v.numpy() for k, v in
           Engine(probe_graph(tq), device="cpu")(feed).items()}
    assert sorted(got) == sorted(want)
    n_eq = n_all = 0
    for name, w in want.items():
        if name in feed:  # the graph inputs (JAX holds int64 as int32)
            continue
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == np.int8:
            n_eq += int((g == w).sum())
            n_all += w.size
    assert n_all > 0 and n_eq / n_all > 0.99, n_eq / n_all
    for name in OUTPUTS:
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= 1e-3 * float(np.abs(want[name]).max()), (name, err)


def test_int8_forward_calls_the_int8_gemm_once_per_qlinear_matmul(
        int8, monkeypatch):
    """Every QLinearMatMul of the INT8 forward goes through the int8 GEMM's
    wrapper with the fused requant epilogue (the quantizer's y_zero_point is
    a constant 0; on the CPU its plain version), with the weight as it is,
    and none through the int32 one."""
    calls = []
    real = quantized.qmatmul_int8_requant

    def counting(a, b, mult, bias=None, *, packed=None, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), packed))
        assert kw in ({}, {"y_zp": 0, "out_dtype": torch.int8})
        return real(a, b, mult, bias, packed=packed, **kw)

    def int32_route(*args, **kw):
        raise AssertionError("QLinearMatMul took the int32 route")

    monkeypatch.setattr(quantized, "qmatmul_int8_requant", counting)
    monkeypatch.setattr(quantized, "qmatmul_int8", int32_route)
    out = Engine(int8[1], device="cpu")(_feed(0))
    assert len(calls) == 13
    assert all(p is None for _, _, p in calls)  # nothing packed on the CPU
    D = TINY.hidden
    shapes = [c[:2] for c in calls]
    assert shapes.count(((B * T, D), (D, D))) == 4 * TINY.n_layer
    assert shapes.count(((B * T, D), (D, 4 * D))) == TINY.n_layer
    assert shapes.count(((B * T, 4 * D), (4 * D, D))) == TINY.n_layer
    assert shapes.count(((B, D), (D, D))) == 1  # the pooler
    assert torch.isfinite(out["pooler_output"]).all()
