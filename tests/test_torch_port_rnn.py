"""The port's LSTM / GRU / RNN emitters (ops/rnn.py) against the JAX
package's, on the CPU: every direction (forward, reverse, bidirectional)
and layout (0 and 1) that JAX supports, with and without bias, initial
states, sequence_lens (per-batch freeze, reverse over the valid prefix),
LSTM peepholes, GRU linear_before_reset 0 and 1, clip, and the default
activations spelled out; non-default activations refused by both. Inputs
and weights from a seeded numpy generator; rtol 1e-4, atol 1e-5 (the JAX
tests' own, tests/test_rnn.py): the port projects all T inputs in one
matmul before the time loop, JAX per step.
"""

import itertools

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model
from onnx_rusty_inference_engine_tpu.ops.registry import (
    UnsupportedOpError as JUnsupported)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import run_op_port, to_port
from util import make_model, node, run_op

T, B, I, H = 5, 3, 4, 6
GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}
N_OUT = {"LSTM": 3, "GRU": 2, "RNN": 2}
ACTS = {"LSTM": ["Sigmoid", "Tanh", "Tanh"], "GRU": ["Sigmoid", "Tanh"],
        "RNN": ["Tanh"]}


def _case(op, direction, layout, *, bias=True, init=False, lens=False,
          peep=False, seed=0):
    rng = np.random.default_rng(seed)
    D = 2 if direction == "bidirectional" else 1
    G = GATES[op]

    def f32(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    x = f32(B, T, I) if layout else f32(T, B, I)
    inits = {"W": f32(D, G * H, I), "R": f32(D, G * H, H)}
    optional = [("B", bias, lambda: f32(D, 2 * G * H)),
                ("sl", lens, lambda: np.array([T, 3, 1], np.int32)),
                ("h0", init, lambda: f32(B, D, H) if layout else f32(D, B, H))]
    if op == "LSTM":
        optional += [
            ("c0", init, lambda: f32(B, D, H) if layout else f32(D, B, H)),
            ("P", peep, lambda: f32(D, 3 * H))]
    for name, on, make in optional:
        if on:
            inits[name] = make()
    return x, inits


def _run_both(op, x, inits, **attrs):
    """Both packages on one node; inputs in ONNX order, absent optional
    inputs as empty names."""
    order = ["W", "R", "B", "sl", "h0", "c0", "P"][:3 + (4 if op == "LSTM"
                                                        else 2)]
    last = max(i for i, n in enumerate(order) if n in inits)
    args = {n: inits.get(n) for n in order[:last + 1]}
    outs = [f"out{i}" for i in range(N_OUT[op])]
    n = node(op, ["x"] + [k if v is not None else "" for k, v in
                          args.items()], outs, hidden_size=H, **attrs)
    m = make_model([n], {"x": x}, outs,
                   {k: v for k, v in args.items() if v is not None})
    want = JEngine(import_model(m)).run({"x": x}).outputs
    got = Engine(to_port(m), device="cpu").run({"x": x}).outputs
    return [np.asarray(want[o]) for o in outs], [got[o] for o in outs]


def _check(want, got):
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


DIRS = ("forward", "reverse", "bidirectional")


@pytest.mark.parametrize("op,direction,layout", list(itertools.product(
    ("LSTM", "GRU", "RNN"), DIRS, (0, 1))))
def test_directions_and_layouts(op, direction, layout):
    x, inits = _case(op, direction, layout, init=True)
    _check(*_run_both(op, x, inits, direction=direction, layout=layout))


@pytest.mark.parametrize("op,direction,layout", list(itertools.product(
    ("LSTM", "GRU", "RNN"), DIRS, (0, 1))))
def test_sequence_lens(op, direction, layout):
    """Per-batch lengths 5, 3, 1: the state freezes and Y is zero past each
    length; a reverse direction reads each valid prefix back to front."""
    x, inits = _case(op, direction, layout, lens=True, init=True, seed=1)
    want, got = _run_both(op, x, inits, direction=direction, layout=layout)
    _check(want, got)
    y = got[0] if layout == 0 else got[0].transpose(1, 2, 0, 3)
    assert np.all(y[1:, :, 2] == 0) and np.all(y[3:, :, 1] == 0)


@pytest.mark.parametrize("op", ["LSTM", "GRU", "RNN"])
def test_no_bias_no_initial_state(op):
    x, inits = _case(op, "forward", 0, bias=False, seed=2)
    _check(*_run_both(op, x, inits))


@pytest.mark.parametrize("direction", DIRS)
def test_lstm_peepholes(direction):
    x, inits = _case("LSTM", direction, 0, peep=True, init=True, seed=3)
    _check(*_run_both("LSTM", x, inits, direction=direction))


@pytest.mark.parametrize("lbr,direction", list(itertools.product(
    (0, 1), DIRS)))
def test_gru_linear_before_reset(lbr, direction):
    x, inits = _case("GRU", direction, 0, init=True, seed=4)
    _check(*_run_both("GRU", x, inits, direction=direction,
                      linear_before_reset=lbr))


@pytest.mark.parametrize("op", ["LSTM", "GRU", "RNN"])
def test_clip(op):
    x, inits = _case(op, "bidirectional", 0, seed=5)
    x = x * 8  # drive the pre-activations past the clip
    _check(*_run_both(op, x, inits, direction="bidirectional", clip=0.7))


@pytest.mark.parametrize("op,direction", list(itertools.product(
    ("LSTM", "GRU", "RNN"), ("forward", "bidirectional"))))
def test_default_activations_spelled_out(op, direction):
    x, inits = _case(op, direction, 0, seed=6)
    D = 2 if direction == "bidirectional" else 1
    acts = [a.lower() for a in ACTS[op]] * D  # case does not matter
    _check(*_run_both(op, x, inits, direction=direction, activations=acts))


@pytest.mark.parametrize("op", ["LSTM", "GRU", "RNN"])
def test_non_default_activations_rejected(op):
    x, inits = _case(op, "forward", 0, seed=7)
    acts = ["Relu"] * len(ACTS[op])
    kw = dict(hidden_size=H, activations=acts, n_outputs=N_OUT[op])
    with pytest.raises(JUnsupported, match="only default activations"):
        run_op(op, {"x": x}, inits, **kw)
    with pytest.raises(UnsupportedOpError, match="only default activations"):
        run_op_port(op, {"x": x}, inits, **kw)
