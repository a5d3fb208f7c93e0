"""The port's ai.onnx.ml ops (ops/ml.py) against the JAX package on the
CPU: every case of tests/test_ml_ops.py, on the same inputs from a seeded
numpy generator, and its oracles (tree walkers, libsvm kernel math).

Labels (and every integer output) exact; float outputs within rtol 1e-5,
atol 1e-6 of JAX for elementwise ops and 1e-5 / 1e-5 for products and
the trees' sums; the SVMs' pairwise coupling (100 rounds) 1e-5 / 1e-5.
String-labelled classifiers, string encoders and ZipMap go through the
port's host prolog and epilog (host.py) as in JAX. The blocked tree
layout equals the dense one bit for bit, and the 120-tree forest of
test_ml_ops.py takes it for real. The batch is cut into row chunks where
the [B, NI] intermediates would pass _ROW_CHUNK_CELLS; chunked equals
unchunked bit for bit.
"""

import numpy as np
import pytest
import torch

import onnx_rusty_inference_engine_tpu_torch.ops.ml as ml
from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from test_ml_ops import _per_tree_values, _random_forest, _rbf
from torch_port_util import run_op_port, to_port
from util import make_model, node, run_op

ML = "ai.onnx.ml"
EW = (1e-5, 1e-6)
SUM = (1e-5, 1e-5)


def check(got, want, tol):
    """The port's outputs against JAX's: strings and integers equal
    (an int64 output is int32 in JAX, x64 off), floats within tol."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype == object or w.dtype.kind in "biuU":
            np.testing.assert_array_equal(g, w, err_msg=f"out{i}")
        else:
            assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=f"out{i}")


def both(op, feeds, inits=None, tol=EW, **kw):
    want = run_op(op, feeds, inits, domain=ML, **kw)
    got = run_op_port(op, feeds, inits, domain=ML, **kw)
    check(got, want, tol)
    return got


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# feature preprocessing
# --------------------------------------------------------------------------
def test_scaler():
    x = _rng(1).normal(size=(3, 4)).astype(np.float32)
    off, sc = [0.5, -1.0, 0.0, 2.0], [2.0, 1.0, 0.5, -1.0]
    (y,) = both("Scaler", {"x": x}, offset=off, scale=sc)
    np.testing.assert_allclose(y, (x - off) * sc, rtol=1e-6)


@pytest.mark.parametrize("norm", ["MAX", "L1", "L2"])
@pytest.mark.parametrize("shape", [(4, 5), (5,)])
def test_normalizer(norm, shape):
    x = _rng(2).normal(size=shape).astype(np.float32)
    if len(shape) == 2:
        x[1] = 0.0  # a zero row divides by 1
    both("Normalizer", {"x": x}, norm=norm)


def test_binarizer_and_imputer():
    x = np.array([[0.1, 0.9], [0.5, -0.2]], np.float32)
    both("Binarizer", {"x": x}, threshold=0.5)
    xn = np.array([[np.nan, 2.0], [1.0, np.nan]], np.float32)
    (y,) = both("Imputer", {"x": xn}, imputed_value_floats=[5.0, 6.0])
    np.testing.assert_array_equal(y, [[5.0, 2.0], [1.0, 6.0]])
    both("Imputer", {"x": np.array([[1.5, 2.0, 1.5]], np.float32)},
         imputed_value_floats=[0.0], replaced_value_float=1.5)
    (y,) = both("Imputer", {"x": np.array([[-1, 3]], np.int64)},
                imputed_value_int64s=[9], replaced_value_int64=-1)
    np.testing.assert_array_equal(y, [[9, 3]])


def test_imputer_wrong_count_raises():
    with pytest.raises(UnsupportedOpError, match="imputed values"):
        run_op_port("Imputer", {"x": np.zeros((2, 3), np.float32)},
                    domain=ML, imputed_value_floats=[1.0, 2.0])


@pytest.mark.parametrize("const_idx", [True, False])
def test_array_feature_extractor(const_idx):
    x = _rng(3).normal(size=(3, 6)).astype(np.float32)
    idx = np.array([5, 0, 2, 7], np.int64)   # 7: out of range -> 0
    if const_idx:
        (y,) = both("ArrayFeatureExtractor", {"x": x}, {"idx": idx})
    else:
        (y,) = both("ArrayFeatureExtractor", {"x": x, "idx": idx})
    np.testing.assert_array_equal(y[:, :3], x[:, [5, 0, 2]])
    both("ArrayFeatureExtractor",
         {"x": np.arange(6, dtype=np.int64), "idx": idx[:3]})


def test_feature_vectorizer():
    r = _rng(4)
    a = r.normal(size=(2, 3)).astype(np.float32)
    b = r.normal(size=(2, 1)).astype(np.float32)
    (y,) = both("FeatureVectorizer", {"a": a, "b": b},
                inputdimensions=[2, 2])
    np.testing.assert_allclose(
        y, np.concatenate([a[:, :2], b, np.zeros((2, 1), np.float32)], 1))
    both("FeatureVectorizer",
         {"a": a, "c": r.integers(0, 5, (2, 2)).astype(np.int64)})


def test_one_hot_encoder_int_device():
    (y,) = both("OneHotEncoder",
                {"x": np.array([[1, 3], [2, 7]], np.int64)},
                cats_int64s=[1, 2, 3], zeros=1)
    np.testing.assert_array_equal(
        y, [[[1, 0, 0], [0, 0, 1]], [[0, 1, 0], [0, 0, 0]]])


def test_one_hot_encoder_string_host_prolog():
    x = np.array(["b", "a", "zz"], dtype=object)
    (y,) = both("OneHotEncoder", {"x": x}, cats_strings=["a", "b"],
                zeros=1)
    np.testing.assert_array_equal(y, [[0, 1], [1, 0], [0, 0]])


def test_label_encoder_numeric_device():
    (y,) = both("LabelEncoder", {"x": np.array([1, 5, 9], np.int64)},
                keys_int64s=[1, 5], values_int64s=[10, 50],
                default_int64=-1)
    np.testing.assert_array_equal(y, [10, 50, -1])
    (y,) = both("LabelEncoder", {"x": np.array([2.0, 7.0], np.float32)},
                keys_floats=[2.0], values_floats=[0.25], default_float=-9.0)
    np.testing.assert_allclose(y, [0.25, -9.0])
    both("LabelEncoder", {"x": np.array([[3, 4], [4, 0]], np.int64)},
         keys_int64s=[3, 4], values_floats=[0.5, 1.5], default_float=2.0)


def test_label_encoder_string_to_int_host_prolog():
    x = np.array(["cat", "dog", "??"], dtype=object)
    (y,) = both("LabelEncoder", {"x": x}, keys_strings=["cat", "dog"],
                values_int64s=[0, 1], default_int64=-1)
    np.testing.assert_array_equal(y.astype(np.int64), [0, 1, -1])


def test_label_encoder_int_to_string_host_epilog():
    (y,) = both("LabelEncoder", {"x": np.array([0, 1, 7], np.int64)},
                keys_int64s=[0, 1], values_strings=["lo", "hi"],
                default_string="?")
    assert [str(v) for v in y.ravel()] == ["lo", "hi", "?"]


def test_category_mapper_both_directions():
    (y,) = both("CategoryMapper", {"x": np.array([[7, 8, 9]], np.int64)},
                cats_int64s=[7, 8], cats_strings=["a", "b"],
                default_string="?")
    assert [str(v) for v in y.ravel()] == ["a", "b", "?"]
    (y,) = both("CategoryMapper",
                {"x": np.array(["b", "q"], dtype=object)},
                cats_int64s=[7, 8], cats_strings=["a", "b"],
                default_int64=-5)
    np.testing.assert_array_equal(y.astype(np.int64), [8, -5])


# --------------------------------------------------------------------------
# linear and SVM models
# --------------------------------------------------------------------------
def test_linear_regressor_multi_target():
    r = _rng(5)
    x = r.normal(size=(4, 3)).astype(np.float32)
    w = r.normal(size=(2, 3)).astype(np.float32)
    b = np.array([0.5, -0.5], np.float32)
    (y,) = both("LinearRegressor", {"x": x}, tol=SUM,
                coefficients=[float(v) for v in w.ravel()],
                intercepts=[float(v) for v in b], targets=2)
    np.testing.assert_allclose(y, x @ w.T + b, rtol=1e-5)


@pytest.mark.parametrize("pt", ["NONE", "LOGISTIC", "SOFTMAX",
                                "SOFTMAX_ZERO"])
def test_linear_classifier_binary(pt):
    """A zero decision value (the third row) is left out under
    SOFTMAX_ZERO: its row is all zero, which the port keeps zero, where
    JAX's CPU run flushes the subnormal floor 1e-38 of its denominator and
    returns 0 / 0 (test_post_transform_softmax_zero)."""
    x = np.array([[1.0, 2.0], [-1.0, -2.0], [0.0, 0.0]], np.float32)
    if pt == "SOFTMAX_ZERO":
        x = x[:2]
    lab, _ = both("LinearClassifier", {"x": x}, tol=SUM,
                  coefficients=[1.0, 1.0], intercepts=[0.0],
                  classlabels_int64s=[0, 1], post_transform=pt, n_outputs=2)
    np.testing.assert_array_equal(lab[:2], [1, 0])


def test_linear_classifier_multiclass_softmax_string_labels():
    r = _rng(6)
    x = r.normal(size=(5, 4)).astype(np.float32)
    w = r.normal(size=(3, 4)).astype(np.float32)
    b = r.normal(size=(3,)).astype(np.float32)
    lab, sc = both("LinearClassifier", {"x": x}, tol=SUM,
                   coefficients=[float(v) for v in w.ravel()],
                   intercepts=[float(v) for v in b],
                   classlabels_strings=["a", "b", "c"],
                   post_transform="SOFTMAX", n_outputs=2)
    z = x @ w.T + b
    assert [str(v) for v in lab] == ["abc"[i] for i in z.argmax(-1)]


def test_post_transform_probit():
    (y,) = both("LinearRegressor",
                {"x": np.array([[1.0], [1.6827], [0.2]], np.float32)},
                tol=SUM, coefficients=[0.5], intercepts=[0.0],
                post_transform="PROBIT")
    np.testing.assert_allclose(y.ravel()[:2], [0.0, 1.0], atol=2e-3)


def test_post_transform_softmax_zero():
    z = torch.tensor([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0]])
    out = ml.post_transform(z, "SOFTMAX_ZERO").numpy()
    assert out[0, 1] == 0.0 and (out[1] == 0.0).all()
    e = np.exp(np.array([1.0, 2.0]) - 2.0)
    np.testing.assert_allclose(out[0, [0, 2]], e / e.sum(), rtol=1e-5)
    with pytest.raises(UnsupportedOpError, match="post_transform"):
        ml.post_transform(z, "CUBE")


@pytest.mark.parametrize("kind,params", [
    ("RBF", [0.6, 0.3, 2.0]), ("LINEAR", None),
    ("POLY", [0.6, 0.3, 2.0]), ("SIGMOID", [0.6, 0.3, 2.0])])
def test_svm_regressor_kernels(kind, params):
    r = _rng(7)
    sv = r.normal(size=(3, 2)).astype(np.float32)
    coef = r.normal(size=(3,)).astype(np.float32)
    x = r.normal(size=(4, 2)).astype(np.float32)
    kw = {} if params is None else {"kernel_params": params}
    (y,) = both("SVMRegressor", {"x": x}, tol=SUM,
                coefficients=[float(v) for v in coef],
                support_vectors=[float(v) for v in sv.ravel()],
                n_supports=3, rho=[0.05], kernel_type=kind, **kw)
    if kind == "RBF":
        exp = [sum(c * _rbf(a, s, 0.6) for c, s in zip(coef, sv)) + 0.05
               for a in x]
        np.testing.assert_allclose(y.ravel(), exp, rtol=2e-4)


def test_svm_regressor_linear_mode_and_one_class():
    x = _rng(8).normal(size=(4, 3)).astype(np.float32)
    both("SVMRegressor", {"x": x}, tol=SUM, coefficients=[0.5, -1.0, 2.0],
         rho=[0.1], n_supports=0)
    (y,) = both("SVMRegressor", {"x": x}, tol=SUM,
                coefficients=[0.5, -1.0, 2.0], rho=[0.1], one_class=1)
    assert set(np.unique(y)) <= {-1.0, 0.0, 1.0}


SV2 = dict(coefficients=[0.6, -0.4], support_vectors=[0.0, 0.0, 1.0, 1.0],
           vectors_per_class=[1, 1], rho=[0.05], kernel_type="RBF",
           kernel_params=[0.7, 0.0, 3.0])


def test_svm_classifier_binary_votes_first_class_on_positive():
    x = np.array([[0.1, 0.0], [2.0, 1.5]], np.float32)
    lab, sc = both("SVMClassifier", {"x": x}, tol=SUM,
                   classlabels_int64s=[3, 8], n_outputs=2, **SV2)
    sv = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    dec = np.array([0.6 * _rbf(r, sv[0], 0.7) - 0.4 * _rbf(r, sv[1], 0.7)
                    + 0.05 for r in x])
    np.testing.assert_array_equal(lab, np.where(dec > 0, 3, 8))


def test_svm_classifier_binary_string_labels():
    x = np.array([[0.1, 0.0], [2.0, 1.5], [0.6, 0.4]], np.float32)
    lab, _ = both("SVMClassifier", {"x": x}, tol=SUM,
                  classlabels_strings=["yes", "no"], n_outputs=2, **SV2)
    assert lab.dtype == object


def test_svm_classifier_multiclass_voting_tiebreak():
    lab, sc = both(
        "SVMClassifier",
        {"x": np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]], np.float32)},
        tol=SUM, coefficients=[1.0, 1.0, 1.0, -1.0, -1.0, -1.0],
        support_vectors=[1.0, 0.0, 0.0, 1.0, -1.0, -1.0],
        vectors_per_class=[1, 1, 1], rho=[0.0, 0.0, 0.0],
        kernel_type="LINEAR", classlabels_int64s=[10, 20, 30], n_outputs=2)
    np.testing.assert_array_equal(lab, [10, 30, 10])
    assert sc.shape == (3, 3)


def test_svm_classifier_binary_platt_probabilities():
    x = np.array([[0.3, 0.3], [1.2, 0.9]], np.float32)
    lab, sc = both("SVMClassifier", {"x": x}, tol=SUM, prob_a=[-1.3],
                   prob_b=[0.2], classlabels_int64s=[0, 1], n_outputs=2,
                   **SV2)
    np.testing.assert_allclose(sc.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("n_classes,seed", [(3, 9), (5, 10)])
def test_svm_classifier_pairwise_coupling(n_classes, seed):
    """Wu-Lin coupling of the Platt pair probabilities (100 rounds): a
    distribution, argmax-consistent, and JAX's within 1e-5."""
    r = _rng(seed)
    n_pairs = n_classes * (n_classes - 1) // 2
    sv = r.normal(size=(2 * n_classes, 2)).astype(np.float32)
    lab, sc = both(
        "SVMClassifier", {"x": r.normal(size=(6, 2)).astype(np.float32)},
        tol=SUM,
        coefficients=[float(v) for v in r.normal(
            size=((n_classes - 1) * 2 * n_classes,))],
        support_vectors=[float(v) for v in sv.ravel()],
        vectors_per_class=[2] * n_classes,
        rho=[float(v) for v in r.normal(size=n_pairs) * 0.1],
        kernel_type="RBF", kernel_params=[0.5, 0.0, 3.0],
        prob_a=[float(v) for v in -r.uniform(0.8, 1.6, n_pairs)],
        prob_b=[float(v) for v in r.normal(size=n_pairs) * 0.1],
        classlabels_int64s=list(range(n_classes)), n_outputs=2)
    np.testing.assert_allclose(sc.sum(-1), 1.0, atol=1e-4)
    assert (sc >= 0).all()
    np.testing.assert_array_equal(lab, sc.argmax(-1))


@pytest.mark.parametrize("n_classes", [2, 3])
def test_svm_classifier_linear_mode_no_support_vectors(n_classes):
    r = _rng(11)
    x = r.normal(size=(3, 4)).astype(np.float32)
    n_w = n_classes if n_classes > 2 else 1
    w = r.normal(size=(n_w, 4)).astype(np.float32)
    rho = r.normal(size=n_w).astype(np.float32)
    both("SVMClassifier", {"x": x}, tol=SUM,
         coefficients=[float(v) for v in w.ravel()],
         rho=[float(v) for v in rho], kernel_type="LINEAR",
         classlabels_int64s=list(range(n_classes)), n_outputs=2)


# --------------------------------------------------------------------------
# tree ensembles
# --------------------------------------------------------------------------
def test_tree_ensemble_regressor_random_forest_oracle():
    attrs, walk = _random_forest(4, 3, 5, 2, seed=3, classifier=False)
    x = _rng(12).normal(size=(16, 5)).astype(np.float32)
    x[3, 2] = np.nan  # missing_value_tracks_true
    (y,) = both("TreeEnsembleRegressor", {"x": x}, tol=SUM, n_targets=2,
                base_values=[0.25, -0.5], **attrs)
    exp = np.stack([walk(r) for r in x]) + [0.25, -0.5]
    np.testing.assert_allclose(y, exp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("agg", ["SUM", "AVERAGE", "MIN", "MAX"])
def test_tree_ensemble_regressor_aggregates(agg):
    attrs, _ = _random_forest(3, 2, 4, 1, seed=9, classifier=False)
    x = _rng(13).normal(size=(8, 4)).astype(np.float32)
    (y,) = both("TreeEnsembleRegressor", {"x": x}, tol=SUM, n_targets=1,
                aggregate_function=agg, **attrs)
    red = {"SUM": sum, "AVERAGE": np.mean, "MIN": min, "MAX": max}[agg]
    exp = [red(_per_tree_values(attrs, r)) for r in x]
    np.testing.assert_allclose(y.ravel(), exp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["BRANCH_LT", "BRANCH_GTE", "BRANCH_GT",
                                  "BRANCH_EQ", "BRANCH_NEQ", "mixed"])
def test_tree_ensemble_node_modes(mode):
    attrs, _ = _random_forest(3, 3, 4, 2, seed=14, classifier=False)
    modes = ["BRANCH_LT", "BRANCH_GTE", "BRANCH_GT", "BRANCH_EQ",
             "BRANCH_NEQ", "BRANCH_LEQ"]
    attrs["nodes_modes"] = [
        m if m == "LEAF" else (modes[i % 6] if mode == "mixed" else mode)
        for i, m in enumerate(attrs["nodes_modes"])]
    x = _rng(15).normal(size=(10, 4)).astype(np.float32)
    x[::3, 1] = np.round(x[::3, 1])  # some equal to thresholds below
    thr = [v for v, m in zip(attrs["nodes_values"], attrs["nodes_modes"])
           if m != "LEAF"]
    x[1, :] = thr[0]
    both("TreeEnsembleRegressor", {"x": x}, tol=SUM, n_targets=2, **attrs)


def test_tree_ensemble_classifier_multiclass_softmax():
    attrs, walk = _random_forest(3, 3, 4, 3, seed=5, classifier=True)
    x = _rng(16).normal(size=(12, 4)).astype(np.float32)
    lab, sc = both("TreeEnsembleClassifier", {"x": x}, tol=SUM,
                   classlabels_int64s=[7, 8, 9], post_transform="SOFTMAX",
                   base_values=[0.1, 0.0, -0.1], n_outputs=2, **attrs)
    z = np.stack([walk(r) for r in x]) + [0.1, 0.0, -0.1]
    np.testing.assert_array_equal(lab, np.array([7, 8, 9])[z.argmax(-1)])


@pytest.mark.parametrize("cls,base", [(1, None), (0, None), (1, [0.3]),
                                      (1, [0.0, 0.4])])
def test_tree_ensemble_classifier_binary_single_sided(cls, base):
    """GBM style: weights for one class only, LOGISTIC, base values."""
    attrs, walk = _random_forest(2, 2, 3, 1, seed=11, classifier=True)
    attrs["class_ids"] = [cls] * len(attrs["class_ids"])
    if base is not None:
        attrs["base_values"] = base
    x = _rng(17).normal(size=(6, 3)).astype(np.float32)
    both("TreeEnsembleClassifier", {"x": x}, tol=SUM,
         classlabels_int64s=[0, 1], post_transform="LOGISTIC", n_outputs=2,
         **attrs)


def test_tree_ensemble_v5_tensor_format():
    (y,) = both("TreeEnsemble",
                {"x": np.array([[0.3], [0.7], [2.0]], np.float32)},
                tol=SUM, nodes_featureids=[0, 0], nodes_splits=[0.5, 1.0],
                nodes_modes=[0, 0], nodes_truenodeids=[0, 1],
                nodes_falsenodeids=[1, 2], nodes_trueleafs=[1, 1],
                nodes_falseleafs=[0, 1], tree_roots=[0],
                leaf_targetids=[0, 0, 0], leaf_weights=[1.5, 2.5, 4.0],
                n_targets=1, aggregate_function=1)
    np.testing.assert_allclose(y.ravel(), [1.5, 2.5, 4.0])


@pytest.mark.parametrize("agg,pt", [(0, 0), (2, 0), (3, 2), (1, 1)])
def test_tree_ensemble_v5_two_trees(agg, pt):
    """Two trees (one a stump on feature 1), every aggregate, with the
    post transforms by number."""
    x = _rng(18).normal(size=(7, 2)).astype(np.float32)
    both("TreeEnsemble", {"x": x}, tol=SUM,
         nodes_featureids=[0, 0, 1], nodes_splits=[0.0, 0.5, -0.2],
         nodes_modes=[0, 1, 2], nodes_truenodeids=[0, 1, 3],
         nodes_falsenodeids=[1, 2, 4], nodes_trueleafs=[1, 1, 1],
         nodes_falseleafs=[0, 1, 1], tree_roots=[0, 2],
         leaf_targetids=[0, 1, 0, 1, 0],
         leaf_weights=[1.5, 2.5, 4.0, -1.0, 0.5],
         n_targets=2, aggregate_function=agg, post_transform=pt)


def test_tree_ensemble_v5_member_mode_raises():
    with pytest.raises(UnsupportedOpError, match="BRANCH_MEMBER"):
        run_op_port("TreeEnsemble", {"x": np.zeros((1, 1), np.float32)},
                    domain=ML, nodes_featureids=[0], nodes_splits=[0.5],
                    nodes_modes=[6], nodes_truenodeids=[0],
                    nodes_falsenodeids=[1], nodes_trueleafs=[1],
                    nodes_falseleafs=[1], tree_roots=[0],
                    leaf_targetids=[0, 0], leaf_weights=[1.0, 2.0],
                    n_targets=1)


def test_tree_ensemble_blocked_layout_matches_dense(monkeypatch):
    """The block-diagonal layout (_BLOCKED_THRESHOLD) equals the dense
    one bit for bit, and the JAX package's blocked layout within SUM."""
    import onnx_rusty_inference_engine_tpu.ops.ml as j_ml

    attrs, walk = _random_forest(5, 4, 6, 2, seed=31, classifier=False)
    x = _rng(19).normal(size=(9, 6)).astype(np.float32)
    x[2, 4] = np.nan
    (dense,) = both("TreeEnsembleRegressor", {"x": x}, tol=SUM,
                    n_targets=2, **attrs)
    monkeypatch.setattr(ml, "_BLOCKED_THRESHOLD", 1)
    monkeypatch.setattr(j_ml, "_BLOCKED_THRESHOLD", 1)
    (blocked,) = both("TreeEnsembleRegressor", {"x": x}, tol=SUM,
                      n_targets=2, **attrs)
    np.testing.assert_array_equal(dense, blocked)
    np.testing.assert_allclose(blocked, np.stack([walk(r) for r in x]),
                               rtol=1e-4, atol=1e-5)


def test_tree_ensemble_row_chunks_match_one_chunk(monkeypatch):
    """Rows in chunks of one (the [B, NI] intermediates' bound) give the
    unchunked outputs bit for bit, dense and blocked."""
    attrs, _ = _random_forest(4, 3, 5, 2, seed=32, classifier=True)
    x = _rng(20).normal(size=(11, 5)).astype(np.float32)
    kw = dict(classlabels_int64s=[0, 1], post_transform="SOFTMAX",
              n_outputs=2, domain=ML, **attrs)
    whole = run_op_port("TreeEnsembleClassifier", {"x": x}, **kw)
    monkeypatch.setattr(ml, "_ROW_CHUNK_CELLS", 1)
    rows = run_op_port("TreeEnsembleClassifier", {"x": x}, **kw)
    monkeypatch.setattr(ml, "_BLOCKED_THRESHOLD", 1)
    blocked = run_op_port("TreeEnsembleClassifier", {"x": x}, **kw)
    for a, b, c in zip(whole, rows, blocked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_tree_ensemble_blocked_large_forest():
    """120 trees of depth 6 (dense C would be ~7.6k x 7.7k) take the
    blocked layout for real and agree with the walker and with JAX."""
    attrs, walk = _random_forest(120, 6, 8, 1, seed=41, classifier=False)
    ni = sum(m != "LEAF" for m in attrs["nodes_modes"])
    nl = sum(m == "LEAF" for m in attrs["nodes_modes"])
    assert ni * nl > ml._BLOCKED_THRESHOLD
    x = _rng(21).normal(size=(4, 8)).astype(np.float32)
    (y,) = both("TreeEnsembleRegressor", {"x": x}, tol=SUM, n_targets=1,
                **attrs)
    np.testing.assert_allclose(y, np.stack([walk(r) for r in x]),
                               rtol=1e-3, atol=1e-4)


def test_tree_ensemble_bad_feature_raises():
    attrs, _ = _random_forest(1, 2, 9, 1, seed=3, classifier=False)
    attrs["nodes_featureids"] = [8] * len(attrs["nodes_featureids"])
    with pytest.raises(UnsupportedOpError, match="feature 8"):
        run_op_port("TreeEnsembleRegressor",
                    {"x": np.zeros((2, 3), np.float32)}, domain=ML,
                    n_targets=1, **attrs)


# --------------------------------------------------------------------------
# an sklearn-style pipeline with string labels and the ZipMap epilog
# --------------------------------------------------------------------------
@pytest.mark.parametrize("labels", [["no", "yes"], [4, 9]],
                         ids=["strings", "ints"])
def test_sklearn_pipeline_imputer_scaler_forest_zipmap(labels):
    attrs, walk = _random_forest(3, 2, 3, 2, seed=21, classifier=True)
    key = ("classlabels_strings" if isinstance(labels[0], str)
           else "classlabels_int64s")
    nodes = [
        node("Imputer", ["x"], ["x1"], domain=ML,
             imputed_value_floats=[0.0, 0.0, 0.0]),
        node("Scaler", ["x1"], ["x2"], domain=ML,
             offset=[0.1, 0.2, 0.3], scale=[1.0, 2.0, 0.5]),
        node("TreeEnsembleClassifier", ["x2"], ["label", "scores"],
             domain=ML, post_transform="SOFTMAX", **{key: labels}, **attrs),
        node("ZipMap", ["scores"], ["probs"], domain=ML, **{key: labels}),
    ]
    x = _rng(22).normal(size=(5, 3)).astype(np.float32)
    x[0, 1] = np.nan
    m = make_model(nodes, {"x": x}, ["label", "probs"])
    got = Engine(to_port(m), device="cpu").run({"x": x})
    want = JEngine(j_import(j_io.parse_model(j_io.serialize_model(m)))
                   ).run({"x": x})
    assert list(got.outputs) == list(want.outputs)
    np.testing.assert_array_equal(got["label"], want["label"])
    maps, wmaps = got["probs"], want["probs"]
    assert isinstance(maps, list) and isinstance(maps[0], dict)
    assert [list(d) for d in maps] == [list(d) for d in wmaps]
    np.testing.assert_allclose([list(d.values()) for d in maps],
                               [list(d.values()) for d in wmaps],
                               rtol=1e-5, atol=1e-5)
    xs = (np.nan_to_num(x) - [0.1, 0.2, 0.3]) * [1.0, 2.0, 0.5]
    z = np.stack([walk(r) for r in xs])
    assert [str(v) for v in got["label"]] == [str(labels[i])
                                             for i in z.argmax(-1)]
