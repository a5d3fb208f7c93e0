"""The port's Gemm, Flatten and BatchNormalization emitters against the JAX
package's, one node at a time on the CPU, on inputs from a seeded numpy
generator.

Gemm: every combination of transA / transB, alpha and beta (beta = 0 drops
C, as the JAX emitter does), with C absent, 1-D over the columns, a column
[M, 1] and a full [M, N]. Both run a float32 product in full precision, in
another summation order, so the tolerance is rtol = 1e-5, atol = 1e-5
(K = 37, values of order 10). Flatten: every axis from -rank to rank,
exact (a reshape). BatchNormalization: a BN whose input is not a Conv's
output (passes.fold_batchnorm folds those at import, so only a hand-built
graph reaches the emitter), in rank 2, 3 and 4 and with a non-default
epsilon, at rtol = atol = 1e-5 (rsqrt may differ in its last bit).
"""

import itertools

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from torch_port_util import run_op_port, to_port
from util import make_model, node, run_op

M, K, N = 5, 37, 7

C_SHAPES = {"none": None, "row": (N,), "column": (M, 1), "full": (M, N)}


@pytest.mark.parametrize(
    "trans_a,trans_b,alpha,beta,c",
    [(ta, tb, al, be, c)
     for ta, tb in itertools.product((0, 1), (0, 1))
     for al, be in ((1.0, 1.0), (0.5, 2.0), (1.0, 0.0))
     for c in ("none", "row", "column", "full")])
def test_gemm_matches_jax(trans_a, trans_b, alpha, beta, c):
    rng = np.random.default_rng(17)
    a = rng.standard_normal((K, M) if trans_a else (M, K)).astype(np.float32)
    b = rng.standard_normal((N, K) if trans_b else (K, N)).astype(np.float32)
    inits = {"b": b}
    if C_SHAPES[c] is not None:
        inits["c"] = rng.standard_normal(C_SHAPES[c]).astype(np.float32)
    attrs = dict(transA=trans_a, transB=trans_b, alpha=alpha, beta=beta)
    (want,) = run_op("Gemm", {"a": a}, inits, **attrs)
    (got,) = run_op_port("Gemm", {"a": a}, inits, **attrs)
    assert got.shape == want.shape == (M, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", range(-4, 5))
def test_flatten_matches_jax(axis):
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    (want,) = run_op("Flatten", {"x": x}, axis=axis)
    (got,) = run_op_port("Flatten", {"x": x}, axis=axis)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,eps", [((4, 6), 1e-5), ((3, 6, 10), 1e-5),
                                       ((2, 6, 5, 7), 1e-3)])
def test_unfolded_batchnorm_matches_jax(shape, eps):
    """Relu -> BatchNormalization: no Conv before the BN, so the import
    keeps it and the emitter runs."""
    rng = np.random.default_rng(11)
    C = shape[1]
    x = rng.standard_normal(shape).astype(np.float32)
    inits = {"scale": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
             "bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "mean": (0.05 * rng.standard_normal(C)).astype(np.float32),
             "var": (1 + 0.1 * np.abs(rng.standard_normal(C))).astype(
                 np.float32)}
    nodes = [node("Relu", ["x"], ["r"]),
             node("BatchNormalization", ["r", "scale", "bias", "mean",
                                         "var"], ["y"], epsilon=eps)]
    m = make_model(nodes, {"x": x}, ["y"], inits, 13)
    tg = to_port(m)
    assert [n.op_type for n in tg.nodes] == ["Relu", "BatchNormalization"]
    want = JEngine(j_import(m)).run({"x": x}).outputs["y"]
    got = Engine(tg, device="cpu").run({"x": x}).outputs["y"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
