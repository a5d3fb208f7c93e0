"""The port's loss ops (ops/losses.py) and RoI ops (ops/vision_roi.py)
against the JAX package on the CPU, on the same inputs from a seeded numpy
generator.

- NegativeLogLikelihoodLoss and SoftmaxCrossEntropyLoss: every reduction,
  class weights, ignore_index inside and outside [0, C), 2-D and 4-D
  inputs, the optional log_prob output; against JAX and torch's own loss
  at rtol 2e-5, atol 1e-6 (test_losses.py's bounds).
- RoiAlign (avg and max, both coordinate transforms, rois off the image,
  the adaptive grid on constant rois), MaxRoiPool and DeformConv: against
  JAX and test_roi_ops.py's scalar references at its tolerances (RoiAlign
  rtol 1e-4, atol 1e-5; MaxRoiPool 1e-5, 1e-6; DeformConv 1e-3, 1e-4).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from test_roi_ops import ref_deform_conv, ref_max_roi_pool, ref_roi_align
from torch_port_util import run_op_port
from util import run_op

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
ROI_TOL = dict(rtol=1e-4, atol=1e-5)
POOL_TOL = dict(rtol=1e-5, atol=1e-6)
DEFORM_TOL = dict(rtol=1e-3, atol=1e-4)


def both(op, feeds, inits=None, tol=LOSS_TOL, **kw):
    """The one-node graph through both packages; the port's outputs, held
    to the JAX package's at `tol`."""
    want = run_op(op, feeds, inits, **kw)
    got = run_op_port(op, feeds, inits, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.dtype,
                                                          w.dtype)
        np.testing.assert_allclose(g, w, err_msg=f"out{i}", **tol)
    return got


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _nll_case(seed, shape, reduction, weighted=False, ignore_index=None):
    r = np.random.default_rng(seed)
    N, C = shape[0], shape[1]
    logp = np.log(r.dirichlet(np.ones(C), size=(N,) + tuple(shape[2:]))
                  ).astype(np.float32)
    if logp.ndim > 2:
        logp = np.moveaxis(logp, -1, 1)
    target = r.integers(0, C, size=(N,) + tuple(shape[2:])).astype(np.int64)
    if ignore_index is not None:
        target.flat[:: max(target.size // 3, 1)] = ignore_index
    attrs = {"reduction": reduction}
    if ignore_index is not None:
        attrs["ignore_index"] = ignore_index
    feeds = {"logp": logp, "t": target}
    weight = None
    if weighted:
        weight = feeds["w"] = r.uniform(0.5, 2.0, size=C).astype(np.float32)
    (got,) = both("NegativeLogLikelihoodLoss", feeds, **attrs)
    want = F.nll_loss(
        torch.from_numpy(logp), torch.from_numpy(target),
        weight=None if weight is None else torch.from_numpy(weight),
        reduction=reduction,
        ignore_index=-100 if ignore_index is None else ignore_index).numpy()
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("shape,weighted", [((6, 5), False),
                                            ((3, 5, 4, 2), True),
                                            ((2, 7, 5), False)])
def test_nll(shape, weighted, reduction):
    _nll_case(1, shape, reduction, weighted)


@pytest.mark.parametrize("ignore_index,weighted", [(2, True), (1, False),
                                                   (-100, False),
                                                   (-100, True)])
def test_nll_ignore_index_mean(ignore_index, weighted):
    _nll_case(2, (8, 4), "mean", weighted, ignore_index)


def test_nll_all_ignored_mean_is_zero():
    """Every position ignored: the weighted mean's denominator is 0 and the
    loss is 0, as in the JAX package."""
    logp = np.log(np.full((3, 4), 0.25, np.float32))
    t = np.full(3, 1, np.int64)
    (got,) = both("NegativeLogLikelihoodLoss", {"logp": logp, "t": t},
                  reduction="mean", ignore_index=1)
    assert got == 0.0


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_softmax_ce(reduction):
    r = np.random.default_rng(3)
    scores = (r.standard_normal((5, 7)) * 3).astype(np.float32)
    target = r.integers(0, 7, size=5).astype(np.int64)
    loss, logp = both("SoftmaxCrossEntropyLoss", {"s": scores, "t": target},
                      n_outputs=2, reduction=reduction)
    want = F.cross_entropy(torch.from_numpy(scores), torch.from_numpy(target),
                           reduction=reduction).numpy()
    np.testing.assert_allclose(loss, want, **LOSS_TOL)
    np.testing.assert_allclose(
        logp, F.log_softmax(torch.from_numpy(scores), dim=1).numpy(),
        **LOSS_TOL)


@pytest.mark.parametrize("shape,ignore_index", [((4, 6, 3), 5),
                                                ((2, 50, 16), -100),
                                                ((3, 9, 2, 3), 0)])
def test_softmax_ce_weighted_ignore(shape, ignore_index):
    r = np.random.default_rng(4)
    scores = r.standard_normal(shape).astype(np.float32)
    C = shape[1]
    target = r.integers(0, C, size=(shape[0],) + shape[2:]).astype(np.int64)
    target.flat[::4] = ignore_index
    w = r.uniform(0.2, 1.5, size=C).astype(np.float32)
    (got,) = both("SoftmaxCrossEntropyLoss",
                  {"s": scores, "t": target, "w": w},
                  reduction="mean", ignore_index=ignore_index)
    want = F.cross_entropy(torch.from_numpy(scores), torch.from_numpy(target),
                           weight=torch.from_numpy(w), reduction="mean",
                           ignore_index=ignore_index).numpy()
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_loss_unknown_reduction_raises():
    x = np.zeros((2, 3), np.float32)
    t = np.zeros(2, np.int64)
    with pytest.raises(UnsupportedOpError, match="reduction"):
        run_op_port("SoftmaxCrossEntropyLoss", {"s": x, "t": t},
                    reduction="median")


# ---------------------------------------------------------------------------
# RoiAlign
# ---------------------------------------------------------------------------
ROIS = np.array([[0.4, 1.1, 7.2, 9.0],
                 [2.0, 0.0, 9.5, 5.5],
                 [0.0, 0.0, 9.9, 11.9]], np.float32)


@pytest.mark.parametrize("mode,ctm,sr", [
    ("avg", "half_pixel", 2),
    ("max", "half_pixel", 3),
    ("avg", "output_half_pixel", 2),
    ("max", "output_half_pixel", 1),
])
def test_roi_align_runtime_rois(mode, ctm, sr):
    x = np.random.default_rng(5).standard_normal(
        (2, 3, 12, 10)).astype(np.float32)
    bidx = np.array([0, 1, 1], np.int64)
    (got,) = both("RoiAlign", {"x": x, "rois": ROIS, "b": bidx},
                  tol=ROI_TOL, output_height=4, output_width=3,
                  sampling_ratio=sr, spatial_scale=1.0, mode=mode,
                  coordinate_transformation_mode=ctm)
    want = ref_roi_align(x, ROIS, bidx, 4, 3, sr, 1.0, mode, ctm)
    np.testing.assert_allclose(got, want, **ROI_TOL)


def test_roi_align_spatial_scale_and_oob():
    x = np.random.default_rng(6).standard_normal(
        (1, 2, 8, 8)).astype(np.float32)
    rois = np.array([[-2.0, -2.0, 10.0, 6.0],
                     [8.0, 8.0, 18.0, 18.0],
                     [-9.0, -9.0, -4.0, -3.0]], np.float32)
    bidx = np.zeros(3, np.int64)
    (got,) = both("RoiAlign", {"x": x, "rois": rois, "b": bidx},
                  tol=ROI_TOL, output_height=2, output_width=2,
                  sampling_ratio=2, spatial_scale=0.5, mode="avg")
    want = ref_roi_align(x, rois, bidx, 2, 2, 2, 0.5, "avg", "half_pixel")
    np.testing.assert_allclose(got, want, **ROI_TOL)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_roi_align_adaptive_static_rois(mode):
    """sampling_ratio=0: the per-roi adaptive grid, for constant rois."""
    x = np.random.default_rng(7).standard_normal(
        (2, 2, 10, 10)).astype(np.float32)
    rois = np.array([[0.0, 0.0, 9.0, 9.0],
                     [1.0, 2.0, 4.0, 8.0]], np.float32)
    bidx = np.array([1, 0], np.int64)
    (got,) = both("RoiAlign", {"x": x}, {"rois": rois, "b": bidx},
                  tol=ROI_TOL, output_height=3, output_width=3,
                  sampling_ratio=0, mode=mode)
    want = ref_roi_align(x, rois, bidx, 3, 3, 0, 1.0, mode, "half_pixel")
    np.testing.assert_allclose(got, want, **ROI_TOL)


def test_roi_align_adaptive_runtime_rois_rejected():
    x = np.zeros((1, 1, 6, 6), np.float32)
    rois = np.array([[0.0, 0.0, 5.0, 5.0]], np.float32)
    with pytest.raises(UnsupportedOpError, match="sampling_ratio"):
        run_op_port("RoiAlign", {"x": x, "rois": rois,
                                 "b": np.array([0], np.int64)},
                    output_height=2, output_width=2, sampling_ratio=0)


# ---------------------------------------------------------------------------
# MaxRoiPool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rois,pooled,scale", [
    (np.array([[0, 1.0, 1.0, 8.0, 6.0],
               [1, 0.0, 0.0, 10.0, 8.0],
               [0, 3.0, 2.0, 4.0, 3.0]], np.float32), [3, 4], 1.0),
    (np.array([[0, 2.0, 2.0, 10.0, 10.0],
               [1, 4.0, 4.0, 4.0, 4.0],
               [0, -4.0, -4.0, 2.0, 2.0],
               [1, 30.0, 30.0, 40.0, 44.0]], np.float32), [2, 2], 0.5),
], ids=["plain", "scale_degenerate_outside"])
def test_max_roi_pool(rois, pooled, scale):
    x = np.random.default_rng(8).standard_normal(
        (2, 3, 9, 11)).astype(np.float32)
    (got,) = both("MaxRoiPool", {"x": x, "rois": rois}, tol=POOL_TOL,
                  pooled_shape=pooled, spatial_scale=scale)
    want = ref_max_roi_pool(x, rois, *pooled, scale)
    np.testing.assert_allclose(got, want, **POOL_TOL)


# ---------------------------------------------------------------------------
# DeformConv
# ---------------------------------------------------------------------------
def test_deform_conv_zero_offsets_equals_conv():
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 4, 7, 7)).astype(np.float32)
    w = r.standard_normal((6, 4, 3, 3)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    off = np.zeros((2, 18, 7, 7), np.float32)
    kw = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1])
    (got,) = both("DeformConv", {"x": x, "w": w, "off": off, "b": b},
                  tol=DEFORM_TOL, **kw)
    (conv,) = run_op_port("Conv", {"x": x, "w": w, "b": b}, **kw)
    np.testing.assert_allclose(got, conv, **ROI_TOL)


@pytest.mark.parametrize("with_mask", [True, False])
def test_deform_conv_offsets_mask_groups(with_mask):
    N, C, H, W_ = 1, 4, 9, 8
    M, KH, KW = 4, 2, 3
    groups, og = 2, 2
    strides, pads, dil = [2, 1], [1, 2, 1, 2], [2, 1]
    OH = (H + pads[0] + pads[2] - dil[0] * (KH - 1) - 1) // strides[0] + 1
    OW = (W_ + pads[1] + pads[3] - dil[1] * (KW - 1) - 1) // strides[1] + 1
    r = np.random.default_rng(10)
    x = r.standard_normal((N, C, H, W_)).astype(np.float32)
    w = r.standard_normal((M, C // groups, KH, KW)).astype(np.float32)
    off = (r.standard_normal((N, og * KH * KW * 2, OH, OW)) * 1.7
           ).astype(np.float32)
    feeds = {"x": x, "w": w, "off": off, "b": np.zeros(M, np.float32)}
    mask = None
    if with_mask:
        mask = feeds["mask"] = r.uniform(
            0.0, 1.0, (N, og * KH * KW, OH, OW)).astype(np.float32)
    (got,) = both("DeformConv", feeds, tol=DEFORM_TOL,
                  kernel_shape=[KH, KW], strides=strides, pads=pads,
                  dilations=dil, group=groups, offset_group=og)
    want = ref_deform_conv(x, w, off, None, mask, strides,
                           [pads[0], pads[1]], dil, groups, og)
    np.testing.assert_allclose(got, want, **DEFORM_TOL)
