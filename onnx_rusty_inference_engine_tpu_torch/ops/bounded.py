"""Ops whose output shape depends on input values: NonZero, Compress,
Unique, NonMaxSuppression.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/bounded.py,
with its static-bound convention: each output is padded to a static
worst case (the input extent, or NMS's max_output_boxes_per_class), valid
entries come first in the op's specified order, and the padding is 0 (NMS:
rows of -1). Index outputs are INDEX_DTYPE (int32), as elsewhere in the
port.

No emitter here reads a device value on the host: no `torch.nonzero`,
`torch.unique`, `masked_select`, `.item()` or Python `if` on a tensor, so
a graph holding these ops still captures into one CUDA graph. Compaction is
a stable argsort of the inverted mask; the JAX package's segment_min / sum
/ max become `scatter_reduce_` with `include_self=False`; NMS runs a fixed
number of rounds on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import UnsupportedOpError, register
from .standard import INDEX_DTYPE


def _stable_front_order(keep: torch.Tensor) -> torch.Tensor:
    """Permutation that moves the True positions of a 1-D mask to the
    front, keeping the relative order on both sides."""
    return torch.argsort((~keep).to(torch.uint8), stable=True)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


@register("NonZero")
def nonzero(ctx, node, ins):
    """Indices of the nonzero elements, row-major, as [rank, numel(x)]:
    valid columns first, padding columns 0. The valid count is
    ReduceSum(Cast(x != 0)) for a consumer that needs it."""
    x = ins[0]
    if x.dim() == 0:
        x = x[None]
    mask = (x != 0).reshape(-1)
    n = mask.shape[0]
    count = mask.sum()
    flat = torch.where(_arange(n, x) < count, _stable_front_order(mask), 0)
    idx = []
    for size in reversed(x.shape):  # unravel, last axis first
        idx.append(flat % size)
        flat = flat // size
    return (torch.stack(idx[::-1]).to(INDEX_DTYPE),)


@register("Compress")
def compress(ctx, node, ins):
    """The elements along an axis (or of the flattened tensor) where the
    condition holds: the input's extent, selected elements first in their
    order, padding 0. A condition shorter than the axis counts its missing
    entries as False."""
    x, cond = ins[0], ins[1].to(torch.bool).reshape(-1)
    axis = node.attr("axis")
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    else:
        axis = int(axis) % x.dim()
    n = x.shape[axis]
    if cond.shape[0] < n:
        cond = torch.cat([cond, cond.new_zeros(n - cond.shape[0])])
    else:
        cond = cond[:n]
    y = torch.index_select(x, axis, _stable_front_order(cond))
    shape = [1] * x.dim()
    shape[axis] = n
    valid = (_arange(n, x) < cond.sum()).reshape(shape)
    return (torch.where(valid, y, torch.zeros((), dtype=x.dtype,
                                              device=x.device)),)


@register("Unique")
def unique(ctx, node, ins):
    """Unique values with their first indices, the inverse and the counts,
    padded to the input's extent (valid entries first, padding 0).
    sorted=1 (the default): ascending values; sorted=0: order of first
    occurrence. Flattened semantics only, as in the JAX package: the axis
    attribute (unique subtensors) raises."""
    if node.attr("axis") is not None:
        raise UnsupportedOpError(
            "Unique: axis attribute (unique subtensors) not supported; "
            "flattened semantics only")
    want_sorted = bool(int(node.attr("sorted", 1)))
    x = ins[0].reshape(-1)
    n = x.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=INDEX_DTYPE, device=x.device)
        return x, e, e, e

    sort_perm = torch.argsort(x, stable=True)   # ties keep their order
    sx = x[sort_perm]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                          sx[1:] != sx[:-1]])   # group starts
    group_id = torch.cumsum(is_first, 0) - 1    # per sorted position
    count = is_first.sum()                      # number of uniques

    first_idx = torch.full((n,), torch.iinfo(torch.int64).max,
                           dtype=torch.int64, device=x.device)
    first_idx.scatter_reduce_(0, group_id, sort_perm, "amin",
                              include_self=False)
    counts = torch.zeros(n, dtype=torch.int64, device=x.device)
    counts.scatter_reduce_(0, group_id, torch.ones_like(sort_perm), "sum",
                           include_self=False)
    values = torch.zeros_like(sx)
    values.scatter_reduce_(0, group_id, sx, "amax", include_self=False)

    slots = _arange(n, x)
    valid = slots < count
    if want_sorted:
        rank_of_group = slots                   # already ascending
    else:
        # groups in order of first occurrence; the invalid ones last
        occ_order = torch.argsort(
            torch.where(valid, first_idx, torch.iinfo(torch.int64).max),
            stable=True)
        values = values[occ_order]
        first_idx = first_idx[occ_order]
        counts = counts[occ_order]
        rank_of_group = torch.argsort(occ_order)  # sorted group -> slot

    y = torch.where(valid, values, torch.zeros((), dtype=x.dtype,
                                               device=x.device))
    indices = torch.where(valid, first_idx, 0).to(INDEX_DTYPE)
    counts = torch.where(valid, counts, 0).to(INDEX_DTYPE)
    inverse = torch.zeros(n, dtype=INDEX_DTYPE, device=x.device)
    inverse.scatter_(0, sort_perm, rank_of_group[group_id].to(INDEX_DTYPE))
    return y, indices, inverse, counts


def _corners(boxes: torch.Tensor, center_point_box: int):
    """[..., 4] boxes -> (y1, x1, y2, x2, area), each [...]. Corner format
    per the ONNX default ([y1, x1, y2, x2], flipped corners allowed);
    center format ([x_c, y_c, w, h]) when center_point_box=1."""
    if center_point_box:
        xc, yc, w, h = boxes.unbind(-1)
        x1, x2 = xc - w / 2, xc + w / 2
        y1, y2 = yc - h / 2, yc + h / 2
    else:
        y1 = torch.minimum(boxes[..., 0], boxes[..., 2])
        y2 = torch.maximum(boxes[..., 0], boxes[..., 2])
        x1 = torch.minimum(boxes[..., 1], boxes[..., 3])
        x2 = torch.maximum(boxes[..., 1], boxes[..., 3])
    return y1, x1, y2, x2, (y2 - y1) * (x2 - x1)


def _suppressed(chosen, every, iou_thr):
    """Whether each box of an image [B, 1, S] overlaps its (batch, class)'s
    chosen box [B, C] by more than iou_thr -> [B, C, S]. The IoU is the
    chosen box's row of the JAX package's [B, S, S] IoU matrix, the same
    operations in the same order (so the same bits), computed for this
    round's boxes only; in place where it can be."""
    cy1, cx1, cy2, cx2, carea = (v[..., None] for v in chosen)
    y1, x1, y2, x2, area = (v[:, None, :] for v in every)
    inter = torch.minimum(cy2, y2).sub_(torch.maximum(cy1, y1)).clamp_(min=0)
    inter.mul_(torch.minimum(cx2, x2).sub_(torch.maximum(cx1, x1))
               .clamp_(min=0))
    union = (carea + area).sub_(inter)
    iou = torch.where(union > 0, inter.div_(union), 0.0)
    return iou > iou_thr


@register("NonMaxSuppression")
def non_max_suppression(ctx, node, ins):
    """Greedy per-class NMS. boxes [B, S, 4], scores [B, C, S] -> selected
    indices [B * C * max_out, 3], rows (batch, class, box) grouped by
    (batch, class), each group's picks in descending score order; invalid
    rows are (-1, -1, -1), so a consumer masks with `row[..., 0] >= 0`.

    max_output_boxes_per_class must be known before the run (it is an
    initializer in every detection export); the IoU and score thresholds
    may be tensors. The selection runs max_out rounds on the device, every
    (batch, class) pair at once: argmax over its still-live scores (the
    first maximum, as jnp.argmax), that box's IoU with every box of its
    image, suppression. The [B, S, S] IoU matrix the JAX package builds is
    never made: each round computes only the chosen boxes' rows of it."""
    boxes, scores = ins[0], ins[1]
    if len(node.inputs) > 2 and node.inputs[2]:
        max_out = int(np.asarray(ctx.require_constant(
            node.inputs[2], "NonMaxSuppression max_output_boxes_per_class")
        ).reshape(()))
    else:
        max_out = 0
    if max_out <= 0:
        return (torch.zeros((0, 3), dtype=INDEX_DTYPE, device=boxes.device),)
    iou_thr = (ins[3].reshape(()) if len(ins) > 3 and ins[3] is not None
               else 0.0)
    score_thr = (ins[4].reshape(()) if len(ins) > 4 and ins[4] is not None
                 else -float("inf"))
    center = int(node.attr("center_point_box", 0))
    B, S, _ = boxes.shape
    C = scores.shape[1]
    max_out = min(max_out, S)

    every = _corners(boxes, center)                      # each [B, S]
    neg_inf = torch.full((), -float("inf"), dtype=scores.dtype,
                         device=scores.device)
    # the live boxes' scores, -inf once a box is chosen or suppressed
    live = torch.where(scores > score_thr, scores, neg_inf)  # [B, C, S]
    sels, oks = [], []
    for _ in range(max_out):
        best = torch.argmax(live, dim=-1, keepdim=True)  # [B, C, 1]
        any_left = torch.gather(live, 2, best)[..., 0] > neg_inf
        sels.append(torch.where(any_left, best[..., 0], 0))
        oks.append(any_left)
        chosen = [torch.gather(v, 1, best[..., 0]) for v in every]
        # where no box is left every score is -inf already, so the
        # updates below change nothing there
        live.masked_fill_(_suppressed(chosen, every, iou_thr), -float("inf"))
        live.scatter_(2, best, -float("inf"))
    sel = torch.stack(sels, dim=-1)                      # [B, C, max_out]
    ok = torch.stack(oks, dim=-1)
    b_idx = torch.arange(B, device=boxes.device)[:, None, None].expand_as(sel)
    c_idx = torch.arange(C, device=boxes.device)[None, :, None].expand_as(sel)
    rows = torch.stack([b_idx, c_idx, sel], dim=-1).to(INDEX_DTYPE)
    rows = torch.where(ok[..., None], rows, -1)
    return (rows.reshape(-1, 3),)
