"""Region-of-interest ops: RoiAlign, MaxRoiPool, DeformConv.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/vision_roi.py,
with the same semantics. The JAX forms avoid index gathers, which are slow
on its chip: RoiAlign selects each roi's image with a one-hot einsum that
materializes [R, C, H, W] and samples it with dense [R, P, H] and [R, Q, W]
bilinear weight matrices; MaxRoiPool materializes a [R, C, PH, H, W]
select. At a detector's widths the first is tens of GB. Gathers are cheap
on the card, so the port gathers:

* RoiAlign fetches each sample point's four bilinear taps as rows of the
  channels-last feature map ([N * H * W, C]) and sums them with their
  weights; the same sums as the JAX einsum, in another order.
* MaxRoiPool reduces one bin row, then one bin column, at a time over the
  rois' images (Caffe's integer bin boundaries, as in JAX).
* DeformConv gathers its four corners per tap (as the JAX form does) and
  contracts them with the weights in one batched matrix product, in full
  fp32 (utils/fp32.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import Node
from ..utils.fp32 import matmul_fp32_exact
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import true_div


def _sample_pos(n_bins: int, grid: int, dtype=np.float32) -> np.ndarray:
    """The sample offsets in bin units, [n_bins * grid]:
    bin + (i + 0.5) / grid."""
    k = np.arange(n_bins * grid)
    return ((k // grid) + ((k % grid) + 0.5) / grid).astype(dtype)


def _taps(start, bin_size, pos, size: int):
    """The bilinear taps of the sample points start + pos * bin_size along
    one axis of extent `size`: (low index, high index, low weight, high
    weight), each [R, P]. A sample outside [-1, size] weighs 0; one inside
    is clamped to [0, size - 1] and split between its floor and the next
    row (the same row at the edge). Works on torch tensors and on numpy
    arrays alike."""
    xp = torch if isinstance(start, torch.Tensor) else np
    y = start[:, None] + pos[None, :] * bin_size[:, None]
    valid = (y >= -1.0) & (y <= size)
    yc = xp.clip(y, 0.0, size - 1.0)
    y0 = xp.floor(yc)
    ly = yc - y0
    lo = y0.long() if xp is torch else y0.astype(np.int64)
    hi = (lo + 1).clamp(max=size - 1) if xp is torch \
        else np.minimum(lo + 1, size - 1)
    w_lo = xp.where(valid, 1.0 - ly, 0.0)
    w_hi = xp.where(valid, ly, 0.0)
    return lo, hi, w_lo, w_hi


def _roi_samples(x_rows, base, H, W, ty, tx):
    """The bilinear value of every sample point of every roi: x_rows is
    the channels-last map [N * H * W, C], base [R] each roi's image
    offset (batch index * H * W), ty / tx the taps of `_taps` ([R, P] and
    [R, Q]) -> [R, P, Q, C]."""
    y_lo, y_hi, wy_lo, wy_hi = ty
    x_lo, x_hi, wx_lo, wx_hi = tx
    R, P = y_lo.shape
    Q = x_lo.shape[1]
    out = None
    for yi, wy in ((y_lo, wy_lo), (y_hi, wy_hi)):
        for xi, wx in ((x_lo, wx_lo), (x_hi, wx_hi)):
            idx = (base[:, None, None] + yi[:, :, None] * W
                   + xi[:, None, :]).reshape(-1)
            v = torch.index_select(x_rows, 0, idx).reshape(R, P, Q, -1)
            w = (wy[:, :, None] * wx[:, None, :])[..., None].to(v.dtype)
            out = v * w if out is None else out.add_(v * w)
    return out


@register("RoiAlign")
def roi_align(ctx: LoweringContext, node: Node, ins):
    x, rois, batch_idx = ins[0], ins[1], ins[2]
    out_h = int(node.attr("output_height", 1))
    out_w = int(node.attr("output_width", 1))
    sr = int(node.attr("sampling_ratio", 0))
    scale = float(node.attr("spatial_scale", 1.0))
    mode = node.attr("mode", "avg")
    ctm = node.attr("coordinate_transformation_mode", "half_pixel")
    if mode not in ("avg", "max"):
        raise UnsupportedOpError(f"RoiAlign: unknown mode {mode!r}")
    N, C, H, W = x.shape
    R = rois.shape[0]
    offset = 0.5 if ctm == "half_pixel" else 0.0

    def roi_geometry(r):
        """r: [..., 4] -> (start_y, start_x, bin_h, bin_w)."""
        start_x = r[..., 0] * scale - offset
        start_y = r[..., 1] * scale - offset
        roi_w = r[..., 2] * scale - offset - start_x
        roi_h = r[..., 3] * scale - offset - start_y
        if ctm != "half_pixel":  # legacy mode clamps degenerate rois
            xp = torch if isinstance(r, torch.Tensor) else np
            roi_w = xp.maximum(roi_w, xp.ones_like(roi_w))
            roi_h = xp.maximum(roi_h, xp.ones_like(roi_h))
        return start_y, start_x, true_div(roi_h, out_h), true_div(roi_w,
                                                                  out_w)

    x_rows = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = batch_idx.long() * (H * W)

    def pool(samples, gh, gw):
        """[R', out_h * gh, out_w * gw, C] -> [R', C, out_h, out_w]."""
        s = samples.reshape(-1, out_h, gh, out_w, gw, C)
        s = (true_div(s.sum(dim=(2, 4)), gh * gw) if mode == "avg"
             else s.amax(dim=(2, 4)))
        return s.permute(0, 3, 1, 2)

    if sr > 0:
        sy, sx, bh, bw = roi_geometry(rois)
        pos_y = ctx.device_constant(f"{node.outputs[0]}:pos:{out_h}:{sr}",
                                    lambda: _sample_pos(out_h, sr))
        pos_x = ctx.device_constant(f"{node.outputs[0]}:pos:{out_w}:{sr}",
                                    lambda: _sample_pos(out_w, sr))
        samples = _roi_samples(x_rows, base, H, W, _taps(sy, bh, pos_y, H),
                               _taps(sx, bw, pos_x, W))
        return (pool(samples, sr, sr).contiguous(),)

    # sampling_ratio=0: the grid density is ceil(roi / bin) per roi, a
    # shape that depends on the data: legal only for rois known before the
    # run (each roi then runs with its exact grid), as in the JAX package
    rois_c = ctx.constant(node.inputs[1])
    if rois_c is None:
        raise UnsupportedOpError(
            "RoiAlign: sampling_ratio=0 (adaptive grid) needs rois known "
            "before the run under static shapes; set sampling_ratio > 0 "
            "for runtime rois")
    rois_np = np.asarray(rois_c, dtype=np.float64)
    outs = []
    for r in range(R):
        sy, sx, bh, bw = roi_geometry(rois_np[r:r + 1])
        gh = max(int(np.ceil(bh[0])), 1)  # spec: ceil(roi_extent / out_bins)
        gw = max(int(np.ceil(bw[0])), 1)

        key = f"{node.outputs[0]}:roi{r}"
        ty = _taps(sy, bh, _sample_pos(out_h, gh, np.float64), H)
        tx = _taps(sx, bw, _sample_pos(out_w, gw, np.float64), W)
        ty, tx = ([ctx.device_constant(f"{key}:{ax}{i}", lambda v=v: (
            v.astype(np.float32) if v.dtype == np.float64 else v))
            for i, v in enumerate(t)] for ax, t in (("y", ty), ("x", tx)))
        outs.append(pool(_roi_samples(x_rows, base[r:r + 1], H, W, ty, tx),
                         gh, gw))
    return (torch.cat(outs).contiguous(),)


@register("DeformConv")
def deform_conv(ctx: LoweringContext, node: Node, ins):
    """Deformable convolution (DCNv1 / v2, opset 19): each kernel tap
    samples X at its grid position plus a learned per-position offset,
    bilinearly, with zero padding; v2 scales each tap by a mask. Offset
    channels are [offset_group, kH, kW, (dy, dx)], the order of the ONNX
    reference implementation. The four corners of every tap are gathered
    from X as [N, C, kH * kW * OH * OW] and contracted with the weights in
    one batched matrix product in full fp32."""
    x, w, offset = ins[0], ins[1], ins[2]
    bias = ins[3] if len(ins) > 3 else None
    mask = ins[4] if len(ins) > 4 else None
    N, C, H, W_ = x.shape
    M, _, KH, KW = w.shape
    groups = int(node.attr("group", 1))
    og = int(node.attr("offset_group", 1))
    strides = [int(v) for v in node.attr("strides", [1, 1])]
    dil = [int(v) for v in node.attr("dilations", [1, 1])]
    pads = [int(v) for v in node.attr("pads", [0, 0, 0, 0])]
    OH, OW = offset.shape[2], offset.shape[3]
    dev = x.device

    # the regular grid per (tap, output position)
    base_y = ((torch.arange(OH, device=dev) * strides[0] - pads[0])[None, :]
              + (torch.arange(KH, device=dev) * dil[0])[:, None])  # [KH,OH]
    base_x = ((torch.arange(OW, device=dev) * strides[1] - pads[1])[None, :]
              + (torch.arange(KW, device=dev) * dil[1])[:, None])  # [KW,OW]
    off = offset.reshape(N, og, KH, KW, 2, OH, OW)
    y = base_y[None, None, :, None, :, None] + off[:, :, :, :, 0]
    xx = base_x[None, None, None, :, None, :] + off[:, :, :, :, 1]
    # y, xx: [N, OG, KH, KW, OH, OW]

    cg = C // og
    L = KH * KW * OH * OW
    xg = x.reshape(N, og, cg, H * W_)

    def corner(yi, xi):
        """X at integer (yi, xi) per (n, group, tap, position), zero
        outside the image -> [N, OG, Cg, KH, KW, OH, OW]."""
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W_)
        flat = yi.clamp(0, H - 1) * W_ + xi.clamp(0, W_ - 1)
        v = torch.gather(xg, 3, flat.reshape(N, og, 1, L).expand(
            N, og, cg, L)).reshape(N, og, cg, KH, KW, OH, OW)
        return torch.where(inb[:, :, None], v, 0)

    y0 = torch.floor(y)
    x0 = torch.floor(xx)
    ly = (y - y0)[:, :, None]
    lx = (xx - x0)[:, :, None]
    y0i, x0i = y0.long(), x0.long()
    samp = (corner(y0i, x0i) * (1 - ly) * (1 - lx)
            + corner(y0i, x0i + 1) * (1 - ly) * lx
            + corner(y0i + 1, x0i) * ly * (1 - lx)
            + corner(y0i + 1, x0i + 1) * ly * lx)
    if mask is not None:
        samp = samp * mask.reshape(N, og, 1, KH, KW, OH, OW)

    # [N, OG, Cg, KH, KW, OH, OW] -> [N, G, (C/G) KH KW, OH OW]
    s = samp.reshape(N, groups, (C // groups) * KH * KW, OH * OW)
    wg = w.reshape(groups, M // groups, (C // groups) * KH * KW)
    with matmul_fp32_exact():
        out = torch.matmul(wg[None], s)              # [N, G, M/G, OH OW]
    out = out.reshape(N, M, OH, OW)
    if bias is not None:
        out = out + bias.reshape(1, M, 1, 1)
    return (out.to(x.dtype),)


@register("MaxRoiPool")
def max_roi_pool(ctx: LoweringContext, node: Node, ins):
    """Caffe RoIPool: rois [R, 5] = (batch, x1, y1, x2, y2); the max over
    each of the pooled_shape bins (integer boundaries from the rounded,
    scaled roi), an empty bin 0."""
    x, rois = ins[0], ins[1]
    ph_, pw_ = [int(v) for v in node.attr("pooled_shape")]
    scale = float(node.attr("spatial_scale", 1.0))
    N, C, H, W = x.shape

    def axis_masks(lo, hi, n_bins, size):
        """Bin membership [R, n_bins, size] and per-bin emptiness
        [R, n_bins]."""
        start = torch.round(lo * scale)
        end = torch.round(hi * scale)
        length = torch.clamp(end - start + 1.0, min=1.0)
        b = torch.arange(n_bins, dtype=x.dtype, device=x.device)[None, :]
        bin_lo = (torch.floor(true_div(b * length[:, None], n_bins))
                  + start[:, None])
        bin_hi = (torch.ceil(true_div((b + 1) * length[:, None], n_bins))
                  + start[:, None])
        bin_lo = bin_lo.clamp(0, size)
        bin_hi = bin_hi.clamp(0, size)
        cells = torch.arange(size, dtype=x.dtype, device=x.device)
        mask = ((cells >= bin_lo[..., None]) & (cells < bin_hi[..., None]))
        return mask, bin_hi <= bin_lo

    mask_h, empty_h = axis_masks(rois[:, 2], rois[:, 4], ph_, H)
    mask_w, empty_w = axis_masks(rois[:, 1], rois[:, 3], pw_, W)

    neg = torch.full((), -float("inf"), dtype=x.dtype, device=x.device)
    xsel = x[rois[:, 0].long()]                          # [R, C, H, W]
    # one bin row at a time: the max over H per (bin row, w), then one
    # bin column at a time: the max over W
    rows = torch.stack([
        torch.where(mask_h[:, None, p, :, None], xsel, neg).amax(dim=2)
        for p in range(ph_)], dim=2)                     # [R, C, PH, W]
    out = torch.stack([
        torch.where(mask_w[:, None, None, q, :], rows, neg).amax(dim=3)
        for q in range(pw_)], dim=3)                     # [R, C, PH, PW]
    empty = empty_h[:, None, :, None] | empty_w[:, None, None, :]
    return (torch.where(empty, 0.0, out).to(x.dtype),)
