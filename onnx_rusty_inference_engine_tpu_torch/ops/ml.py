"""ai.onnx.ml domain: classical-ML ops (sklearn, LightGBM and XGBoost
exports).

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/ml.py, with
its 15 ops and their semantics:

* TreeEnsemble{Classifier,Regressor} and the opset-5 TreeEnsemble keep the
  JAX package's GEMM strategy: each row's internal-node features are
  picked (here a gather of the feature columns, which on the JAX chip was
  a one-hot product), compared with the thresholds, resolved to one leaf
  per tree by a product with the path matrix C [NI, NL], and summed into
  the outputs by a product with the leaf matrix E [NL, T]. Above
  _BLOCKED_THRESHOLD cells C is held block-diagonal by tree and the path
  product is a batched matrix product. The tables are built on the host
  once per input signature; the [B, NI] intermediates are made for at
  most _ROW_CHUNK_CELLS cells at a time.
* SVMClassifier / SVMRegressor evaluate the kernel matrix as one product;
  one-vs-one votes and Platt / pairwise-coupling probabilities follow on
  the device. The coupling's 100 rounds are unrolled (about 100 x classes
  x 8 launches in one captured graph).
* String-labelled classifiers emit the class index on the device; the
  Engine's host epilog (host.py) maps it to a label.

Every product runs in full fp32 (utils/fp32.matmul_fp32_exact): under
TF32 the tree leaves' weights, the RBF kernel's x^2 - 2 x.sv + sv^2 (which
cancels) and the coupling's rounds would drift.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..graph import Node
from ..utils.fp32 import matmul_fp32_exact
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import INDEX_DTYPE, true_div

ML = "ai.onnx.ml"

_BIG = 3.4e38  # sentinel for masked min / max (finite: NaN-safe)


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _as_2d(x):
    """ai.onnx.ml feature ops accept [N, C] or [C]; lift to 2-D."""
    return (x.reshape(1, -1), True) if x.dim() == 1 else (x, False)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _const(ctx: LoweringContext, node: Node, name: str, make):
    """A table the emitter makes on the host, on the device once per input
    signature."""
    return ctx.device_constant(f"{node.outputs[0]}:{name}", make)


def _matmul(a, b):
    with matmul_fp32_exact():
        return a @ b


def post_transform(scores, kind: str):
    """The ml ops' post_transform attribute (scores [..., C])."""
    if kind in (None, "NONE"):
        return scores
    if kind == "SOFTMAX":
        return torch.softmax(scores, dim=-1)
    if kind == "LOGISTIC":
        return torch.sigmoid(scores)
    if kind == "SOFTMAX_ZERO":
        # softmax over the nonzero entries only; zero entries stay zero
        nz = scores != 0
        m = torch.where(nz, scores, -_BIG).amax(dim=-1, keepdim=True)
        e = torch.where(nz, torch.exp(scores - m), 0.0)
        return e / e.sum(dim=-1, keepdim=True).clamp(min=1e-38)
    if kind == "PROBIT":
        return torch.special.ndtri(scores)
    raise UnsupportedOpError(f"post_transform {kind!r} not in the ml spec")


def _labels_attr(node: Node, prefix: str) -> Tuple[np.ndarray, bool]:
    """(labels, is_string) from {prefix}_int64s / {prefix}_strings."""
    s = node.attr(f"{prefix}_strings")
    if s is not None:
        return np.asarray(s, dtype=object), True
    i = node.attr(f"{prefix}_int64s")
    if i is None:
        raise UnsupportedOpError(
            f"{node.op_type}: {prefix}_int64s or {prefix}_strings required")
    return np.asarray(i, dtype=np.int64), False


def classifier_string_labels(node: Node) -> Optional[np.ndarray]:
    """The label table when this classifier's Y output is an index the host
    epilog maps to a string; None for int-labelled classifiers."""
    if node.op_type in ("TreeEnsembleClassifier", "LinearClassifier",
                        "SVMClassifier"):
        s = node.attr("classlabels_strings")
        if s is not None:
            return np.asarray(s, dtype=object)
    return None


def _labels_of(ctx, node, idx, labels: np.ndarray, is_string: bool):
    """Class index [B] -> its label (the index itself for string labels,
    which the host epilog maps)."""
    if is_string:
        return idx
    table = _const(ctx, node, "labels", lambda: labels.astype(np.int64))
    return table[idx.long()].to(INDEX_DTYPE)


def _emit_labels(ctx, node, scores_t, labels: np.ndarray, is_string: bool):
    """argmax over the transformed scores -> label (or index if string)."""
    idx = torch.argmax(scores_t, dim=-1).to(INDEX_DTYPE)
    return _labels_of(ctx, node, idx, labels, is_string)


# --------------------------------------------------------------------------
# feature preprocessing ops
# --------------------------------------------------------------------------
@register("Scaler", domain=ML)
def scaler(ctx, node, ins):
    offset = _const(ctx, node, "offset", lambda: np.asarray(
        node.attr("offset", [0.0]), np.float32))
    scale = _const(ctx, node, "scale", lambda: np.asarray(
        node.attr("scale", [1.0]), np.float32))
    return [(_f32(ins[0]) - offset) * scale]


@register("Normalizer", domain=ML)
def normalizer(ctx, node, ins):
    x = _f32(ins[0])
    norm = node.attr("norm", "MAX")
    x2, squeeze = _as_2d(x)
    if norm == "MAX":
        d = x2.abs().amax(dim=-1, keepdim=True)
    elif norm == "L1":
        d = x2.abs().sum(dim=-1, keepdim=True)
    elif norm == "L2":
        d = torch.sqrt((x2 * x2).sum(dim=-1, keepdim=True))
    else:
        raise UnsupportedOpError(f"Normalizer: norm {norm!r}")
    y = x2 / torch.where(d == 0, 1.0, d)
    return [y.reshape(x.shape) if squeeze else y]


@register("Binarizer", domain=ML)
def binarizer(ctx, node, ins):
    t = float(node.attr("threshold", 0.0))
    return [(ins[0] > t).to(ins[0].dtype)]


@register("Imputer", domain=ML)
def imputer(ctx, node, ins):
    x = ins[0]
    if x.is_floating_point():
        imputed = np.asarray(node.attr("imputed_value_floats"), np.float32)
        replaced = float(node.attr("replaced_value_float", np.nan))
        hit = torch.isnan(x) if np.isnan(replaced) else (x == replaced)
    else:
        imputed = np.asarray(node.attr("imputed_value_int64s"), np.int64)
        replaced = int(node.attr("replaced_value_int64", 0))
        hit = x == replaced
    x2, squeeze = _as_2d(x)
    if imputed.size not in (1, x2.shape[-1]):
        raise UnsupportedOpError(
            f"Imputer: {imputed.size} imputed values for {x2.shape[-1]} "
            f"features")
    fill = _const(ctx, node, "fill", lambda: imputed).to(x.dtype)
    y = torch.where(hit.reshape(x2.shape), fill, x2)
    return [y.reshape(x.shape) if squeeze else y]


@register("ArrayFeatureExtractor", domain=ML)
def array_feature_extractor(ctx, node, ins):
    """The columns at the given indices along the last axis: a gather,
    where the JAX package's one-hot product picks the same values (and 0
    for an index out of range, as here)."""
    x = ins[0]
    d = x.shape[-1]
    idx_c = ctx.constant(node.inputs[1])
    if idx_c is not None:
        idx = _const(ctx, node, "idx", lambda: np.asarray(
            idx_c, np.int64).reshape(-1))
    else:
        idx = ins[1].long().reshape(-1)
    y = torch.index_select(x, x.dim() - 1, idx.clamp(0, max(d - 1, 0)))
    y = torch.where((idx >= 0) & (idx < d), y,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return [y.reshape(-1) if x.dim() == 1 else y]


@register("FeatureVectorizer", domain=ML)
def feature_vectorizer(ctx, node, ins):
    """Concat each input's leading columns into one [N, sum(dims)]
    tensor; each input is cut or zero-padded to its declared
    inputdimensions."""
    dims = node.attr("inputdimensions")
    if dims is None:
        dims = [int(np.prod(v.shape[1:])) if v.dim() > 1 else 1 for v in ins]
    cols = []
    for v, d in zip(ins, dims):
        v2 = _f32(v.reshape(v.shape[0], -1) if v.dim() > 1
                  else v.reshape(-1, 1))
        d = int(d)
        if v2.shape[1] >= d:
            v2 = v2[:, :d]
        else:
            v2 = torch.nn.functional.pad(v2, (0, d - v2.shape[1]))
        cols.append(v2)
    return [torch.cat(cols, dim=1)]


@register("OneHotEncoder", domain=ML)
def one_hot_encoder(ctx, node, ins):
    """Numeric categories on the device; string categories run in the host
    prolog (host.py has the numpy twin)."""
    cats = node.attr("cats_int64s")
    if cats is None:
        raise UnsupportedOpError(
            "OneHotEncoder with cats_strings needs a string input (hosted); "
            "numeric inputs require cats_int64s")
    table = _const(ctx, node, "cats", lambda: np.asarray(cats, np.int64))
    # zeros=0 makes an unmatched category a model error; a captured graph
    # cannot raise on a value, so an unmatched row stays all-zero
    return [(ins[0].long()[..., None] == table).to(torch.float32)]


def _label_encoder_table(node: Node, which: str) -> Tuple[np.ndarray, bool]:
    """LabelEncoder v2 ({which}_int64s / _floats / _strings) or v4
    ({which}_tensor) table: (array, is_string)."""
    t = node.attr(f"{which}_tensor")
    if t is not None:
        arr = np.asarray(t)
        return arr, arr.dtype.kind in ("U", "S", "O")
    s = node.attr(f"{which}_strings")
    if s is not None:
        return np.asarray(s, dtype=object), True
    f = node.attr(f"{which}_floats")
    if f is not None:
        return np.asarray(f, np.float32), False
    i = node.attr(f"{which}_int64s")
    if i is not None:
        return np.asarray(i, np.int64), False
    raise UnsupportedOpError(f"LabelEncoder: no {which}_* attribute")


@register("LabelEncoder", domain=ML)
def label_encoder(ctx, node, ins):
    """Numeric -> numeric on the device; a string-keyed or string-valued
    table runs on the host (host.py)."""
    keys, kstr = _label_encoder_table(node, "keys")
    vals, vstr = _label_encoder_table(node, "values")
    if kstr or vstr:
        raise UnsupportedOpError(
            "LabelEncoder over strings runs on host; it reached the device "
            "graph, which means its input is numeric but its table is not")
    default = node.attr("default_float")
    if default is None:
        default = node.attr("default_int64", -1)
    x = ins[0]
    k = _const(ctx, node, "keys", lambda: keys).to(x.dtype)
    v = _const(ctx, node, "values", lambda: vals)
    eq = x[..., None] == k                               # [..., K]
    picked = torch.where(eq, v, torch.zeros((), dtype=v.dtype,
                                            device=v.device)).sum(dim=-1)
    return [torch.where(eq.any(dim=-1), picked,
                        torch.full((), vals.dtype.type(default).item(),
                                   dtype=v.dtype, device=x.device))]


# --------------------------------------------------------------------------
# linear models
# --------------------------------------------------------------------------
@register("LinearRegressor", domain=ML)
def linear_regressor(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))
    targets = int(node.attr("targets", 1))
    w = _const(ctx, node, "wT", lambda: np.asarray(
        node.attr("coefficients"), np.float32).reshape(targets, -1).T.copy())
    b = _const(ctx, node, "b", lambda: np.asarray(
        node.attr("intercepts", [0.0] * targets), np.float32))
    return [post_transform(_matmul(x, w) + b,
                           node.attr("post_transform", "NONE"))]


def _expand_binary(scores):
    """One decision value of a 2-class model -> [-s, s], so that a later
    LOGISTIC / SOFTMAX gives complementary class scores."""
    return torch.cat([-scores, scores], dim=-1)


@register("LinearClassifier", domain=ML)
def linear_classifier(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))
    labels, is_str = _labels_attr(node, "classlabels")
    coeff = np.asarray(node.attr("coefficients"), np.float32)
    n_sets = coeff.size // x.shape[-1] if x.shape[-1] else 1
    w = _const(ctx, node, "wT",
               lambda: coeff.reshape(n_sets, -1).T.copy())   # [F, S]
    b = _const(ctx, node, "b", lambda: np.asarray(
        node.attr("intercepts", [0.0] * n_sets), np.float32))
    z = _matmul(x, w) + b
    if n_sets == 1 and len(labels) == 2:
        z = _expand_binary(z)
    scores = post_transform(z, node.attr("post_transform", "NONE"))
    return [_emit_labels(ctx, node, scores, labels, is_str), scores]


# --------------------------------------------------------------------------
# SVMs (libsvm layout; semantics from the ai.onnx.ml spec)
# --------------------------------------------------------------------------
def _svm_kernel(node: Node, x, sv, sv2):
    """k(x, sv): x [B, F], sv [NSV, F] (sv2: each sv's squared norm) ->
    [B, NSV]: one product and elementwise ops."""
    kind = node.attr("kernel_type", "LINEAR")
    gamma, coef0, degree = 0.0, 0.0, 3.0
    kp = node.attr("kernel_params")
    if kp:
        kp = list(kp) + [0.0] * (3 - len(kp))
        gamma, coef0, degree = float(kp[0]), float(kp[1]), float(kp[2])
    dot = _matmul(x, sv.T)
    if kind == "LINEAR":
        return dot
    if kind == "POLY":
        return (gamma * dot + coef0) ** degree
    if kind == "SIGMOID":
        return torch.tanh(gamma * dot + coef0)
    if kind == "RBF":
        x2 = (x * x).sum(dim=-1, keepdim=True)
        return torch.exp(-gamma * (x2 - 2 * dot + sv2))
    raise UnsupportedOpError(f"SVM kernel_type {kind!r}")


def _support_vectors(ctx, node, nsv: int):
    """The support vectors [NSV, F] and their squared norms [NSV]."""
    sv = _const(ctx, node, "sv", lambda: np.asarray(
        node.attr("support_vectors"), np.float32).reshape(nsv, -1))
    return sv, (sv * sv).sum(dim=-1)


@register("SVMRegressor", domain=ML)
def svm_regressor(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))
    coeff = np.asarray(node.attr("coefficients"), np.float32)
    rho = float(np.asarray(node.attr("rho", [0.0]), np.float32)[0])
    nsv = int(node.attr("n_supports", 0))
    c = _const(ctx, node, "coef", lambda: coeff.reshape(-1, 1))
    if nsv:
        k = _svm_kernel(node, x, *_support_vectors(ctx, node, nsv))
        y = _matmul(k, c) + rho
    else:  # linear mode: the coefficients are feature weights
        y = _matmul(x, c) + rho
    if int(node.attr("one_class", 0)):
        y = torch.sign(y)
    return [post_transform(y, node.attr("post_transform", "NONE"))]


def _pairwise_coupling(pair_probs, n_classes: int, pairs):
    """Wu and Lin's (2004) second method: pairwise class probabilities ->
    class posteriors, the algorithm libsvm and ONNX Runtime use, for 100
    fixed rounds (a loop that stops on convergence would read a device
    value), unrolled."""
    b = pair_probs.shape[0]
    dev = pair_probs.device
    r = torch.full((b, n_classes, n_classes), 0.5, dtype=torch.float32,
                   device=dev)
    for k, (i, j) in enumerate(pairs):
        r[:, i, j] = pair_probs[:, k]
        r[:, j, i] = 1.0 - pair_probs[:, k]
    q = torch.zeros((b, n_classes, n_classes), dtype=torch.float32,
                    device=dev)
    for i in range(n_classes):
        for j in range(n_classes):
            if i == j:
                q[:, i, i] = (r[:, :, i] ** 2).sum(dim=-1) - r[:, i, i] ** 2
            else:
                q[:, i, j] = -r[:, j, i] * r[:, i, j]
    q_diag = torch.diagonal(q, dim1=1, dim2=2).clamp(min=1e-12)

    def qp_of(p):
        qp = _matmul(q, p[..., None])[..., 0]
        return qp, (p * qp).sum(dim=-1)

    p = torch.full((b, n_classes), 1.0 / n_classes, dtype=torch.float32,
                   device=dev)
    for _ in range(100):
        qp, pqp = qp_of(p)
        for i in range(n_classes):
            p[:, i] += (-qp[:, i] + pqp) / q_diag[:, i]
            p = p / p.sum(dim=-1, keepdim=True)
            qp, pqp = qp_of(p)
    return p


@register("SVMClassifier", domain=ML)
def svm_classifier(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))
    labels, is_str = _labels_attr(node, "classlabels")
    n_classes = len(labels)
    rho_np = np.asarray(node.attr("rho"), np.float32)
    rho = _const(ctx, node, "rho", lambda: rho_np)
    coeff = np.asarray(node.attr("coefficients"), np.float32)
    prob_a = node.attr("prob_a")
    prob_b = node.attr("prob_b")
    vpc = node.attr("vectors_per_class")
    pt = node.attr("post_transform", "NONE")

    if not vpc or sum(vpc) == 0:  # linear mode (e.g. LinearSVC)
        n_w = n_classes if n_classes > 2 else 1
        w = _const(ctx, node, "wT",
                   lambda: coeff.reshape(n_w, -1).T.copy())
        z = _matmul(x, w) + rho
        if n_w == 1 and n_classes == 2:
            z = _expand_binary(z)
        scores = post_transform(z, pt)
        return [_emit_labels(ctx, node, scores, labels, is_str), scores]

    vpc = [int(v) for v in vpc]
    nsv = sum(vpc)
    k = _svm_kernel(node, x, *_support_vectors(ctx, node, nsv))  # [B, NSV]
    pairs = [(i, j) for i in range(n_classes)
             for j in range(i + 1, n_classes)]

    def pattern():
        """The dual coefficients of every (i, j) pair as one [NSV, P]
        matrix, so that all pairs' decision values are one product."""
        dual = coeff.reshape(n_classes - 1, nsv)  # libsvm dual-coef layout
        starts = np.concatenate([[0], np.cumsum(vpc)])
        pat = np.zeros((nsv, len(pairs)), np.float32)
        for p, (i, j) in enumerate(pairs):
            si, ei = starts[i], starts[i + 1]
            sj, ej = starts[j], starts[j + 1]
            pat[si:ei, p] = dual[j - 1, si:ei]
            pat[sj:ej, p] = dual[i, sj:ej]
        return pat

    dec = _matmul(k, _const(ctx, node, "pattern", pattern)) + rho  # [B, P]

    if prob_a is not None and prob_b is not None and len(prob_a):
        pa = _const(ctx, node, "prob_a",
                    lambda: np.asarray(prob_a, np.float32))
        pb = _const(ctx, node, "prob_b",
                    lambda: np.asarray(prob_b, np.float32))
        pij = torch.sigmoid(-(pa * dec + pb))  # libsvm: P(first class)
        pij = pij.clamp(1e-7, 1 - 1e-7)
        if n_classes == 2:
            scores = post_transform(torch.cat([pij, 1 - pij], dim=-1), pt)
            return [_emit_labels(ctx, node, scores, labels, is_str), scores]
        scores = post_transform(
            _pairwise_coupling(pij, n_classes, pairs), pt)
        return [_emit_labels(ctx, node, scores, labels, is_str), scores]

    # no probability tables: the scores are the pairs' decision values and
    # the label comes from one-vs-one votes (ties -> lowest class index)
    win = (dec > 0).to(torch.float32)                    # [B, P]
    first = _const(ctx, node, "vote_first", lambda: np.eye(
        n_classes, dtype=np.float32)[[i for i, _ in pairs]])
    second = _const(ctx, node, "vote_second", lambda: np.eye(
        n_classes, dtype=np.float32)[[j for _, j in pairs]])
    votes = _matmul(win, first) + _matmul(1.0 - win, second)
    idx = torch.argmax(votes, dim=-1).to(INDEX_DTYPE)
    if n_classes == 2:
        # libsvm binary: one pair; a positive decision votes the first
        # class (unlike LinearClassifier's sklearn convention), so the
        # score pair is [d, -d] and argmax(scores) is the voted label
        scores = post_transform(torch.cat([dec, -dec], dim=-1), pt)
    else:
        scores = post_transform(dec, pt)
    return [_labels_of(ctx, node, idx, labels, is_str), scores]


# --------------------------------------------------------------------------
# tree ensembles: the GEMM strategy (see the module docstring)
# --------------------------------------------------------------------------
_CMP = {
    "BRANCH_LEQ": torch.le,
    "BRANCH_LT": torch.lt,
    "BRANCH_GTE": torch.ge,
    "BRANCH_GT": torch.gt,
    "BRANCH_EQ": torch.eq,
    "BRANCH_NEQ": torch.ne,
}


# above this many cells the dense path matrix C [NI, NL] switches to the
# block-diagonal form (C only couples nodes and leaves of the same tree):
# per-tree blocks padded to the largest tree, contracted by one batched
# matrix product; a 500-tree depth-8 forest needs ~130 MB blocked, ~65 GB
# dense
_BLOCKED_THRESHOLD = 1 << 22

# at most this many cells of a [B, NI] intermediate at a time: the rows of
# a large batch run in chunks of at least one row
_ROW_CHUNK_CELLS = 1 << 27


class _TreeTables:
    """An ONNX tree ensemble compiled on the host into the GEMM tables:
    feature and threshold per internal node, the path matrix C [NI, NL],
    the true-ancestor counts D [NL], the leaf keys of the output matrix.
    Large forests take the block-diagonal-by-tree layout (see
    _BLOCKED_THRESHOLD). The JAX package's tables, row for row."""

    def __init__(self, tree_ids, node_ids, feats, modes, values,
                 true_ids, false_ids, miss_true):
        n = len(tree_ids)
        row = {(int(tree_ids[i]), int(node_ids[i])): i for i in range(n)}
        if len(row) != n:
            raise UnsupportedOpError("tree ensemble: duplicate (tree, node)")
        is_leaf = [m == "LEAF" for m in modes]
        self.internal = [i for i in range(n) if not is_leaf[i]]
        self.leaves: List[int] = []
        icol = {r: c for c, r in enumerate(self.internal)}

        # roots: the nodes of a tree that no node names as a child
        children = set()
        for i in self.internal:
            children.add(row[(int(tree_ids[i]), int(true_ids[i]))])
            children.add(row[(int(tree_ids[i]), int(false_ids[i]))])
        roots = [i for i in range(n) if i not in children]

        paths: Dict[int, List[Tuple[int, int]]] = {}
        for r in roots:
            stack = [(r, [])]
            while stack:
                i, path = stack.pop()
                if is_leaf[i]:
                    paths[i] = path
                    self.leaves.append(i)
                    continue
                t = row[(int(tree_ids[i]), int(true_ids[i]))]
                f = row[(int(tree_ids[i]), int(false_ids[i]))]
                stack.append((t, path + [(icol[i], +1)]))
                stack.append((f, path + [(icol[i], -1)]))
        if len(paths) + len(self.internal) != n:
            raise UnsupportedOpError(
                "tree ensemble: disconnected nodes (bad child ids)")

        self.n_trees = len(roots)
        by_tree: Dict[int, Tuple[List[int], List[int]]] = {}
        for i in self.internal:
            by_tree.setdefault(int(tree_ids[i]), ([], []))[0].append(i)
        for i in self.leaves:
            by_tree.setdefault(int(tree_ids[i]), ([], []))[1].append(i)
        tree_order = sorted(by_tree)
        ni_m = max((len(v[0]) for v in by_tree.values()), default=1) or 1
        nl_m = max(len(v[1]) for v in by_tree.values())
        t = len(tree_order)
        miss = (np.zeros(n, np.float32) if miss_true is None
                else np.asarray(miss_true, np.float32))
        self.blocked = len(self.internal) * len(self.leaves) \
            > _BLOCKED_THRESHOLD
        if self.blocked:
            # per-tree padded layout: row t * NI_m + j, leaf t * NL_m + j
            self.block_shape = (t, ni_m, nl_m)
            order_i = {}
            order_l = {}
            self.feat = np.zeros(t * ni_m, np.int64)
            self.thresh = np.zeros(t * ni_m, np.float32)
            self.miss = np.zeros(t * ni_m, np.float32)
            self.modes = ["BRANCH_LEQ"] * (t * ni_m)
            self.C = np.zeros((t, ni_m, nl_m), np.float32)
            self.D = np.full((t, nl_m), -1.0, np.float32)  # pads: never hit
            self.leaf_key = [("__pad__", ti, j) for ti in range(t)
                             for j in range(nl_m)]
            for ti, tid in enumerate(tree_order):
                ints, lvs = by_tree[tid]
                for j, i in enumerate(ints):
                    r = ti * ni_m + j
                    order_i[i] = r
                    self.feat[r] = feats[i]
                    self.thresh[r] = values[i]
                    self.modes[r] = modes[i]
                    self.miss[r] = miss[i]
                for j, i in enumerate(lvs):
                    order_l[i] = (ti, j)
                    self.D[ti, j] = 0.0
                    self.leaf_key[ti * nl_m + j] = (
                        int(tree_ids[i]), int(node_ids[i]))
            for leaf, path in paths.items():
                ti, j = order_l[leaf]
                for (col, sign) in path:
                    r = order_i[self.internal[col]]
                    self.C[ti, r - ti * ni_m, j] = sign
                    if sign > 0:
                        self.D[ti, j] += 1.0
        else:
            ni, nl = len(self.internal), len(self.leaves)
            self.feat = np.asarray([feats[i] for i in self.internal],
                                   np.int64)
            self.thresh = np.asarray([values[i] for i in self.internal],
                                     np.float32)
            self.modes = [modes[i] for i in self.internal]
            self.miss = miss[self.internal]
            self.C = np.zeros((ni, nl), np.float32)
            self.D = np.zeros((nl,), np.float32)
            for c, leaf in enumerate(self.leaves):
                for (i, sign) in paths[leaf]:
                    self.C[i, c] = sign
                    if sign > 0:
                        self.D[c] += 1.0
            self.leaf_key = [(int(tree_ids[i]), int(node_ids[i]))
                             for i in self.leaves]

    def mode_masks(self) -> Dict[str, np.ndarray]:
        """Per node mode, which internal nodes take it."""
        out = {}
        for mode in sorted(set(self.modes)):
            if mode not in _CMP:
                raise UnsupportedOpError(f"tree ensemble node mode {mode!r}")
            out[mode] = np.asarray([m == mode for m in self.modes], np.bool_)
        return out


def _tree_outputs(ctx, node, tables: _TreeTables, x, e: np.ndarray,
                  agg: str):
    """Rows x [B, F] -> the aggregated leaf values [B, T] (SUM, AVERAGE,
    MIN or MAX over trees), e the leaf matrix E [NL, T]. Each chunk of
    rows: pick (a gather of the feature columns), compare, path product
    (batched over trees when blocked), leaf one-hot, then E."""
    f = x.shape[-1]
    ni = tables.feat.shape[0]
    if (tables.feat >= f).any():
        raise UnsupportedOpError(
            f"tree ensemble reads feature {int(tables.feat.max())} but "
            f"input has {f} columns")
    feat = _const(ctx, node, "feat", lambda: tables.feat)
    thr = _const(ctx, node, "thresh", lambda: tables.thresh)
    miss = _const(ctx, node, "miss", lambda: tables.miss)
    masks = {m: _const(ctx, node, f"mode:{m}", lambda v=v: v)
             for m, v in tables.mode_masks().items()}
    c_mat = _const(ctx, node, "C", lambda: tables.C)
    d_vec = _const(ctx, node, "D", lambda: tables.D)
    e_mat = _const(ctx, node, "E", lambda: e)
    nl = len(tables.leaf_key)
    step = max(1, _ROW_CHUNK_CELLS // max(ni, nl, 1))
    outs = []
    for lo in range(0, x.shape[0], step):
        xn = torch.index_select(x[lo:lo + step], 1, feat)   # [b, NI]
        pred = torch.zeros(xn.shape, dtype=torch.float32, device=x.device)
        for mode, mask in masks.items():
            pred = torch.where(mask, _CMP[mode](xn, thr).to(torch.float32),
                               pred)
        pred = torch.where(torch.isnan(xn), miss, pred)
        if tables.blocked:
            t, ni_m, nl_m = tables.block_shape
            with matmul_fp32_exact():
                s = torch.bmm(pred.reshape(-1, t, ni_m).transpose(0, 1),
                              c_mat)                     # [T, b, NL_m]
            onehot = (s == d_vec[:, None, :]).transpose(0, 1).reshape(
                -1, t * nl_m).to(torch.float32)
        else:
            onehot = (_matmul(pred, c_mat) == d_vec).to(torch.float32)
        if agg in ("SUM", "AVERAGE"):
            y = _matmul(onehot, e_mat)
            if agg == "AVERAGE":
                y = true_div(y, max(tables.n_trees, 1))
        elif agg in ("MIN", "MAX"):
            # each tree selects one leaf: the min / max over trees is the
            # min / max over the selected leaves
            v = onehot[..., None] * e_mat                    # [b, NL, T]
            sel = onehot[..., None] > 0
            y = (torch.where(sel, v, _BIG).amin(dim=1) if agg == "MIN"
                 else torch.where(sel, v, -_BIG).amax(dim=1))
        else:
            raise UnsupportedOpError(f"aggregate_function {agg!r}")
        outs.append(y)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _tables_from_attrs(node: Node) -> _TreeTables:
    get = node.attr
    required = ("nodes_treeids", "nodes_nodeids", "nodes_featureids",
                "nodes_modes", "nodes_values", "nodes_truenodeids",
                "nodes_falsenodeids")
    vals = [get(k) for k in required]
    if any(v is None for v in vals):
        missing = [k for k, v in zip(required, vals) if v is None]
        raise UnsupportedOpError(f"{node.op_type}: missing {missing}")
    return _TreeTables(*vals, get("nodes_missing_value_tracks_true"))


def _leaf_matrix(tables: _TreeTables, treeids, nodeids, outids, weights,
                 n_out: int) -> np.ndarray:
    """E [NL, n_out]: the summed weights of each leaf's (class | target)
    entries (the spec allows several entries per leaf)."""
    pos = {k: i for i, k in enumerate(tables.leaf_key)}
    e = np.zeros((len(tables.leaf_key), n_out), np.float32)
    for t, nd, o, w in zip(treeids, nodeids, outids, weights):
        i = pos.get((int(t), int(nd)))
        if i is None:
            raise UnsupportedOpError(
                f"tree ensemble: weight on unknown leaf ({t},{nd})")
        e[i, int(o)] += float(w)
    return e


@register("TreeEnsembleRegressor", domain=ML)
def tree_ensemble_regressor(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))

    def make():
        tables = _tables_from_attrs(node)
        return tables, _leaf_matrix(
            tables, node.attr("target_treeids"),
            node.attr("target_nodeids"), node.attr("target_ids"),
            node.attr("target_weights"), int(node.attr("n_targets", 1)))

    tables, e = ctx.host_constant(f"{node.outputs[0]}:tables", make)
    y = _tree_outputs(ctx, node, tables, x, e,
                      node.attr("aggregate_function", "SUM"))
    base = node.attr("base_values")
    if base is not None:
        y = y + _const(ctx, node, "base",
                       lambda: np.asarray(base, np.float32))
    return [post_transform(y, node.attr("post_transform", "NONE"))]


@register("TreeEnsembleClassifier", domain=ML)
def tree_ensemble_classifier(ctx, node, ins):
    x, _ = _as_2d(_f32(ins[0]))
    labels, is_str = _labels_attr(node, "classlabels")
    n_classes = len(labels)
    class_ids = [int(c) for c in node.attr("class_ids")]
    one_sided = n_classes == 2 and len(set(class_ids)) == 1

    def make():
        tables = _tables_from_attrs(node)
        return tables, _leaf_matrix(
            tables, node.attr("class_treeids"), node.attr("class_nodeids"),
            [0] * len(class_ids) if one_sided else class_ids,
            node.attr("class_weights"), 1 if one_sided else n_classes)

    tables, e = ctx.host_constant(f"{node.outputs[0]}:tables", make)
    z = _tree_outputs(ctx, node, tables, x, e, "SUM")    # [B, 1 | C]
    base = node.attr("base_values")
    if base is not None and not one_sided:
        z = z + _const(ctx, node, "base",
                       lambda: np.asarray(base, np.float32))
    if one_sided:
        if base is not None:
            z = z + float(np.asarray(base, np.float32).reshape(-1)[-1])
        # a single-score binary ensemble (GBM style): [-s, s] so that
        # LOGISTIC / SOFTMAX give complementary class scores, flipped when
        # the weights were written for class 0
        z = _expand_binary(z) if class_ids[0] == 1 \
            else _expand_binary(z).flip(-1)
    scores = post_transform(z, node.attr("post_transform", "NONE"))
    return [_emit_labels(ctx, node, scores, labels, is_str), scores]


# --------------------------------------------------------------------------
# TreeEnsemble (ai.onnx.ml opset 5): the tensor-attribute format
# --------------------------------------------------------------------------
_V5_MODES = {0: "BRANCH_LEQ", 1: "BRANCH_LT", 2: "BRANCH_GTE",
             3: "BRANCH_GT", 4: "BRANCH_EQ", 5: "BRANCH_NEQ"}


def _v5_tables(node: Node) -> Tuple[_TreeTables, np.ndarray]:
    """The opset-5 arrays (internal nodes and leaves apart, with leaf
    flags) as the v3 rows, then the same GEMM tables, and E."""
    get = node.attr
    feats = np.asarray(get("nodes_featureids"), np.int64)
    splits = np.asarray(get("nodes_splits"), np.float32)
    modes_i = np.asarray(get("nodes_modes"), np.int64)
    true_ids = np.asarray(get("nodes_truenodeids"), np.int64)
    false_ids = np.asarray(get("nodes_falsenodeids"), np.int64)
    true_leaf = np.asarray(get("nodes_trueleafs"), np.int64)
    false_leaf = np.asarray(get("nodes_falseleafs"), np.int64)
    roots = np.asarray(get("tree_roots"), np.int64)
    leaf_tid = np.asarray(get("leaf_targetids"), np.int64)
    leaf_w = np.asarray(get("leaf_weights"), np.float32)
    miss = get("nodes_missing_value_tracks_true")
    n_targets = int(get("n_targets", int(leaf_tid.max()) + 1
                        if leaf_tid.size else 1))
    if any(int(m) not in _V5_MODES for m in modes_i):
        raise UnsupportedOpError(
            "TreeEnsemble: BRANCH_MEMBER (set membership) has no dense "
            "lowering here yet")

    ni, nl = len(feats), len(leaf_w)
    # the v3 row format: internal nodes first, then leaves
    tree_ids = np.zeros(ni + nl, np.int64)
    node_ids = np.arange(ni + nl, dtype=np.int64)  # unique per row
    modes = ["LEAF"] * (ni + nl)
    values = np.zeros(ni + nl, np.float32)
    t_ids = np.zeros(ni + nl, np.int64)
    f_ids = np.zeros(ni + nl, np.int64)
    feats_full = np.zeros(ni + nl, np.int64)
    miss_full = np.zeros(ni + nl, np.float32)

    def child_row(idx, leaf_flag):
        return ni + int(idx) if leaf_flag else int(idx)

    for t, r in enumerate(roots):
        stack = [int(r)]  # mark the whole subtree with tree id t
        while stack:
            i = stack.pop()
            tree_ids[i] = t
            modes[i] = _V5_MODES[int(modes_i[i])]
            values[i] = splits[i]
            feats_full[i] = feats[i]
            if miss is not None:
                miss_full[i] = float(miss[i])
            tc = child_row(true_ids[i], true_leaf[i])
            fc = child_row(false_ids[i], false_leaf[i])
            t_ids[i] = node_ids[tc]
            f_ids[i] = node_ids[fc]
            tree_ids[tc] = t
            tree_ids[fc] = t
            if not true_leaf[i]:
                stack.append(int(true_ids[i]))
            if not false_leaf[i]:
                stack.append(int(false_ids[i]))

    tables = _TreeTables(tree_ids, node_ids, feats_full, modes, values,
                         t_ids, f_ids, miss_full)
    # leaf rows appear in `tables.leaf_key` as (tree, ni + leaf index)
    e = np.zeros((len(tables.leaf_key), n_targets), np.float32)
    pos = {k: i for i, k in enumerate(tables.leaf_key)}
    for li in range(nl):
        row = pos.get((int(tree_ids[ni + li]), ni + li))
        if row is not None:  # else an unreachable leaf (never referenced)
            e[row, int(leaf_tid[li])] += float(leaf_w[li])
    return tables, e


@register("TreeEnsemble", domain=ML)
def tree_ensemble_v5(ctx, node, ins):
    """The opset-5 unified tree op, through the v3 ops' GEMM tables.
    BRANCH_MEMBER (set membership) raises, as in the JAX package."""
    x, _ = _as_2d(_f32(ins[0]))
    tables, e = ctx.host_constant(f"{node.outputs[0]}:tables",
                                  lambda: _v5_tables(node))
    agg = {0: "AVERAGE", 1: "SUM", 2: "MIN", 3: "MAX"}.get(
        int(node.attr("aggregate_function", 1)), "SUM")
    y = _tree_outputs(ctx, node, tables, x, e, agg)
    kinds = {0: "NONE", 1: "SOFTMAX", 2: "LOGISTIC", 3: "SOFTMAX_ZERO",
             4: "PROBIT"}
    return [post_transform(y, kinds.get(int(node.attr("post_transform", 0)),
                                        "NONE"))]
