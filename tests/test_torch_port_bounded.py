"""The port's bounded-output ops (ops/bounded.py: NonZero, Compress,
Unique, NonMaxSuppression) and the SSD detection family against the JAX
package on the CPU, on the same inputs from a seeded numpy generator.

Every output is held exactly: the valid entries, the padding (0, or rows
of -1 for NMS) and the index dtype (int32 in both packages). The NMS
cases are also held to test_bounded_ops.py's plain greedy reference. The
detection builder gives the JAX builder's ONNX bytes, and its forward
(boxes, scores and the in-graph NMS's rows) equals the JAX Engine's.
"""

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import detection as j_det
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import detection, zoo
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from test_bounded_ops import _nms_ref
from torch_port_util import assert_graphs_equal, run_op_port, to_port
from util import make_model, node, run_op


INDEX_OUTPUTS = {"NonZero": (0,), "Unique": (1, 2, 3),
                 "NonMaxSuppression": (0,)}


def both(op, feeds, inits=None, **kw):
    """The one-node graph through both packages: the port's outputs,
    held equal to the JAX package's, shapes and values. Index outputs are
    int32 in both; an int64 data output is int32 in JAX (x64 off), int64
    in the port."""
    want = run_op(op, feeds, inits, **kw)
    got = run_op_port(op, feeds, inits, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if i in INDEX_OUTPUTS.get(op, ()):
            assert g.dtype == w.dtype == np.int32, (i, g.dtype, w.dtype)
        else:
            assert g.dtype == w.dtype or (g.dtype, w.dtype) == (
                np.int64, np.int32), (i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"out{i}")
    return got


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# NonZero, Compress, Unique
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), ()])
def test_nonzero(shape):
    r = _rng(1)
    x = ((r.random(shape) > 0.6) * r.random(shape)).astype(np.float32)
    (out,) = both("NonZero", {"x": np.asarray(x, np.float32)})
    ref = np.stack(np.nonzero(x.reshape(-1) if x.ndim == 0 else x))
    np.testing.assert_array_equal(out[:, :ref.shape[1]], ref)
    np.testing.assert_array_equal(out[:, ref.shape[1]:], 0)


@pytest.mark.parametrize("x", [np.ones((2, 3), np.float32),
                               np.zeros((2, 3), np.float32),
                               np.array([True, False, True, True, False]),
                               np.array([[0, 4, 0], [-2, 0, 7]], np.int64)],
                         ids=["all", "none", "bool", "int64"])
def test_nonzero_all_none_and_dtypes(x):
    both("NonZero", {"x": x})


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_compress(axis):
    r = _rng(2)
    x = r.standard_normal((4, 5)).astype(np.float32)
    n = x.size if axis is None else x.shape[axis]
    cond = r.random(n) > 0.5
    kw = {} if axis is None else {"axis": axis}
    (out,) = both("Compress", {"x": x}, {"cond": cond}, **kw)
    ref = np.compress(cond, x, axis=axis)
    k = ref.size if axis is None else ref.shape[axis]
    np.testing.assert_array_equal(np.take(out, range(k), axis=axis or 0),
                                  ref.reshape(-1) if axis is None else ref)


@pytest.mark.parametrize("cond", [np.array([False, True, True]),
                                  np.array([True] * 8)],
                         ids=["short", "long"])
def test_compress_condition_length(cond):
    x = np.arange(6, dtype=np.float32)
    both("Compress", {"x": x}, {"cond": cond})


def test_compress_runtime_condition():
    r = _rng(3)
    x = r.integers(-9, 9, (3, 6)).astype(np.int64)
    both("Compress", {"x": x, "cond": r.random(6) > 0.4}, axis=1)


@pytest.mark.parametrize("sorted_", [1, 0])
@pytest.mark.parametrize("x", [
    np.array([2, 1, 1, 3, 4, 3], np.float32),
    np.array([2, 1, 1, 3, 4, 3], np.int64),
    _rng(4).integers(0, 10, 40).astype(np.float32),
    np.array([5.0], np.float32),
    np.array([7, 7, 7, 7], np.int64),
], ids=["small_f32", "small_i64", "random", "one", "all_equal"])
def test_unique(x, sorted_):
    y, idx, inv, cnt = both("Unique", {"x": x}, n_outputs=4, opset=11,
                            sorted=sorted_)
    uy, uidx, uinv, ucnt = np.unique(x, return_index=True,
                                     return_inverse=True, return_counts=True)
    k = uy.size
    if sorted_:
        np.testing.assert_array_equal(y[:k], uy)
        np.testing.assert_array_equal(inv, uinv.reshape(-1))
    else:
        order = np.argsort(uidx)  # order of first occurrence
        np.testing.assert_array_equal(y[:k], uy[order])
        np.testing.assert_array_equal(idx[:k], uidx[order])
        np.testing.assert_array_equal(y[inv], x)
    np.testing.assert_array_equal(y[k:], 0)
    np.testing.assert_array_equal(cnt[k:], 0)


def test_unique_axis_raises():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with pytest.raises(UnsupportedOpError, match="axis"):
        run_op_port("Unique", {"x": x}, n_outputs=4, opset=11, axis=0)


# ---------------------------------------------------------------------------
# NonMaxSuppression
# ---------------------------------------------------------------------------
def _nms(boxes, scores, max_out, iou_thr=None, score_thr=None, **kw):
    inits = {"max_out": np.array(max_out, np.int64)}
    if iou_thr is not None:
        inits["iou_thr"] = np.array(iou_thr, np.float32)
    if score_thr is not None:
        inits["score_thr"] = np.array(score_thr, np.float32)
    (out,) = both("NonMaxSuppression", {"boxes": boxes, "scores": scores},
                  inits, opset=11, **kw)
    return out


@pytest.mark.parametrize("B,S,C,max_out,iou_thr,score_thr", [
    (2, 12, 3, 4, 0.5, 0.3),
    (1, 40, 2, 40, 0.3, 0.0),
    (3, 25, 4, 7, 0.6, 0.45),
    (2, 9, 1, 20, 0.5, 0.1),      # max_out above S: S rows per class
])
def test_nms_matches_reference(B, S, C, max_out, iou_thr, score_thr):
    r = _rng(5 + S)
    boxes = (r.random((B, S, 4)) * 10).astype(np.float32)
    scores = r.random((B, C, S)).astype(np.float32)
    out = _nms(boxes, scores, max_out, iou_thr, score_thr)
    ref = _nms_ref(boxes, scores, min(max_out, S), iou_thr, score_thr)
    assert out.shape == (B * C * min(max_out, S), 3)
    np.testing.assert_array_equal(out[out[:, 0] >= 0], ref)
    np.testing.assert_array_equal(out[out[:, 0] < 0], -1)


def test_nms_ties_pick_the_first_maximum():
    """Equal scores (saturated sigmoids at full size): the pick is the
    first maximum, as jnp.argmax's."""
    r = _rng(6)
    boxes = (r.random((1, 30, 4)) * 10).astype(np.float32)
    scores = np.round(r.random((1, 2, 30)) * 3).astype(np.float32) / 3
    out = _nms(boxes, scores, 10, 0.4, 0.1)
    ref = _nms_ref(boxes, scores, 10, 0.4, 0.1)
    np.testing.assert_array_equal(out[out[:, 0] >= 0], ref)


def test_nms_center_point_boxes():
    boxes_c = np.array([[[5, 5, 2, 2], [5.2, 5.2, 2, 2], [9, 9, 1, 1]]],
                       np.float32)
    scores = np.array([[[0.9, 0.8, 0.7]]], np.float32)
    out = _nms(boxes_c, scores, 3, 0.5, center_point_box=1)
    np.testing.assert_array_equal(out[out[:, 0] >= 0],
                                  [[0, 0, 0], [0, 0, 2]])


def test_nms_defaults_and_empty():
    r = _rng(7)
    boxes = r.random((1, 5, 4)).astype(np.float32)
    scores = r.random((1, 2, 5)).astype(np.float32)
    # no thresholds: IoU 0 suppresses every overlapping box
    _nms(boxes, scores, 3)
    out = _nms(boxes, scores * 0.1, 3, 0.5, 0.99)
    np.testing.assert_array_equal(out, -1)
    (none,) = both("NonMaxSuppression", {"boxes": boxes, "scores": scores},
                   opset=11)
    assert none.shape == (0, 3)


def test_nms_runtime_thresholds():
    """The IoU and score thresholds as graph inputs (tensors at run time);
    max_output_boxes_per_class stays an initializer."""
    r = _rng(8)
    feeds = {"boxes": (r.random((2, 16, 4)) * 8).astype(np.float32),
             "scores": r.random((2, 3, 16)).astype(np.float32),
             "iou_thr": np.array(0.45, np.float32),
             "score_thr": np.array(0.2, np.float32)}
    m = make_model([node("NonMaxSuppression",
                         ["boxes", "scores", "max_out", "iou_thr",
                          "score_thr"], ["sel"])],
                   feeds, ["sel"], {"max_out": np.array(5, np.int64)},
                   opset=11)
    got = Engine(to_port(m), device="cpu").run(feeds).outputs["sel"]
    want = JEngine(j_import(j_io.parse_model(j_io.serialize_model(m)))
                   ).run(feeds).outputs["sel"]
    np.testing.assert_array_equal(got, want)
    ref = _nms_ref(feeds["boxes"], feeds["scores"], 5, 0.45, 0.2)
    np.testing.assert_array_equal(got[got[:, 0] >= 0], ref)


# ---------------------------------------------------------------------------
# the SSD detection family
# ---------------------------------------------------------------------------
CONFIGS = {
    "tiny": dict(cfg=detection.TINY, batch=2),
    "wide": dict(cfg=detection.DetectionConfig(
        image_size=64, n_classes=5, anchors_per_cell=3, backbone_ch=24,
        max_out=12, iou_threshold=0.45, score_threshold=0.2),
        batch=1, seed=3),
}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_builder_gives_the_jax_bytes(kind):
    kw = dict(CONFIGS[kind])
    jkw = dict(kw, cfg=j_det.DetectionConfig(**vars(kw["cfg"])))
    ours, theirs = detection.build_detection(**kw), \
        j_det.build_detection(**jkw)
    assert t_io.serialize_model(ours) == j_io.serialize_model(theirs)
    assert_graphs_equal(j_import(theirs), import_model(ours))
    np.testing.assert_array_equal(detection.make_anchors(kw["cfg"]),
                                  j_det.make_anchors(jkw["cfg"]))


@pytest.mark.parametrize("kind,seed", [("tiny", 31), ("tiny", 0),
                                       ("wide", 5)])
def test_detection_matches_jax(kind, seed):
    kw = CONFIGS[kind]
    cfg, B = kw["cfg"], kw["batch"]
    m = detection.build_detection(**kw)
    img = _rng(seed).standard_normal(
        (B, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    got = Engine(to_port(m), device="cpu").run({"image": img}).outputs
    want = JEngine(j_import(m)).run({"image": img}).outputs
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-6)
    sel = got["selected_indices"]
    assert sel.dtype == want["selected_indices"].dtype == np.int32
    np.testing.assert_array_equal(sel, want["selected_indices"])
    # the in-graph NMS equals the plain greedy reference on its own
    # boxes and scores, padding rows included
    ref = _nms_ref(got["boxes"], got["scores"], cfg.max_out,
                   cfg.iou_threshold, cfg.score_threshold)
    np.testing.assert_array_equal(sel[sel[:, 0] >= 0], ref)
    np.testing.assert_array_equal(sel[sel[:, 0] < 0], -1)


def test_detection_box_decode_matches_reference():
    cfg = detection.TINY
    m = detection.build_detection(cfg, batch=1)
    img = _rng(9).standard_normal((1, 3, 32, 32)).astype(np.float32)
    boxes = Engine(to_port(m), device="cpu").run(
        {"image": img}).outputs["boxes"][0]
    anchors = detection.make_anchors(cfg)
    ctr = (boxes[:, :2] + boxes[:, 2:]) / 2
    size = boxes[:, 2:] - boxes[:, :2]
    t_ctr = (ctr - anchors[:, :2]) / (0.1 * anchors[:, 2:])
    t_size = np.log(size / anchors[:, 2:]) / 0.2
    redecoded = detection.decode_boxes_ref(
        np.concatenate([t_ctr, t_size], -1)[None], anchors)[0]
    np.testing.assert_allclose(redecoded, boxes, rtol=1e-4, atol=1e-5)


def test_zoo_detection_is_the_jax_zoo_model():
    assert "detection" not in zoo.NOT_PORTED
    m = t_io.load_model(zoo.get_model_path("detection"))
    theirs = j_det.build_detection(j_det.TINY, batch=1)
    assert t_io.serialize_model(m) == j_io.serialize_model(theirs)
