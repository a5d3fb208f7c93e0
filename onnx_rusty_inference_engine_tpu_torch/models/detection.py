"""SSD-style detection head: the port's copy of
onnx_rusty_inference_engine_tpu/models/detection.py, the family that runs
the bounded-output ops (ops/bounded.py).

A small conv backbone feeds two 1x1 heads (box offsets and class logits);
the graph then does the whole SSD post-processing in ONNX ops: the anchor
decode (Split / Mul / Exp / Add / Concat), Sigmoid scores and
NonMaxSuppression with the static-bound convention, so the whole detector,
selection included, is one captured graph on the card. The same config,
batch and seed give the JAX package's ONNX bytes.

Outputs:
- boxes   [B, S, 4]  decoded corner boxes (y1, x1, y2, x2)
- scores  [B, C, S]  per-class sigmoid scores
- selected_indices [B * C * max_out, 3] rows (batch, class, box index);
  padding rows are (-1, -1, -1), the bounded-NMS convention.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder


@dataclasses.dataclass
class DetectionConfig:
    image_size: int = 32
    n_classes: int = 3
    anchors_per_cell: int = 2
    backbone_ch: int = 16
    max_out: int = 8          # NMS max_output_boxes_per_class
    iou_threshold: float = 0.5
    score_threshold: float = 0.35

    @property
    def grid(self) -> int:
        return self.image_size // 4  # two stride-2 convs

    @property
    def n_boxes(self) -> int:
        return self.grid * self.grid * self.anchors_per_cell


TINY = DetectionConfig()


def make_anchors(cfg: DetectionConfig) -> np.ndarray:
    """[S, 4] anchors as (cy, cx, h, w) in [0, 1] image coordinates."""
    g, a = cfg.grid, cfg.anchors_per_cell
    centers = (np.arange(g) + 0.5) / g
    cy, cx = np.meshgrid(centers, centers, indexing="ij")
    sizes = np.array([0.15 * (1.6 ** k) for k in range(a)])
    anchors = np.zeros((g, g, a, 4), np.float32)
    anchors[..., 0] = cy[..., None]
    anchors[..., 1] = cx[..., None]
    anchors[..., 2] = sizes
    anchors[..., 3] = sizes
    return anchors.reshape(-1, 4)


def decode_boxes_ref(offsets: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Numpy reference of the in-graph anchor decode: offsets [B, S, 4]
    (ty, tx, th, tw) -> corner boxes [B, S, 4] (y1, x1, y2, x2)."""
    cy = anchors[:, 0] + offsets[..., 0] * 0.1 * anchors[:, 2]
    cx = anchors[:, 1] + offsets[..., 1] * 0.1 * anchors[:, 3]
    h = anchors[:, 2] * np.exp(offsets[..., 2] * 0.2)
    w = anchors[:, 3] * np.exp(offsets[..., 3] * 0.2)
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                    axis=-1)


def build_detection(
    cfg: DetectionConfig = TINY,
    *,
    batch: int = 1,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    b = GraphBuilder("ssd_head", opset=opset, seed=seed)
    B, C, A = batch, cfg.n_classes, cfg.anchors_per_cell
    F, G, S = cfg.backbone_ch, cfg.grid, cfg.n_boxes

    img = b.input("image", [B, 3, cfg.image_size, cfg.image_size])

    def conv(x, name, cin, cout, stride):
        w = b.init(f"{name}_w", (b.rng.standard_normal((cout, cin, 3, 3))
                                 * (9 * cin) ** -0.5).astype(np.float32))
        bias = b.zeros(f"{name}_b", (cout,))
        (y,) = b.node("Conv", [x, w, bias], [f"{name}_y"],
                      kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                      strides=[stride, stride])
        return y

    x = conv(img, "bb1", 3, F, 2)
    (x,) = b.node("Relu", [x], ["bb1_r"])
    x = conv(x, "bb2", F, F, 2)
    (x,) = b.node("Relu", [x], ["bb2_r"])          # [B, F, G, G]

    # heads: 1x1 convs
    def head(x, name, cout):
        w = b.init(f"{name}_w", (b.rng.standard_normal((cout, F, 1, 1))
                                 * F ** -0.5).astype(np.float32))
        bias = b.zeros(f"{name}_b", (cout,))
        (y,) = b.node("Conv", [x, w, bias], [f"{name}_y"])
        return y

    loc = head(x, "loc", 4 * A)                    # [B, 4A, G, G]
    cls = head(x, "cls", C * A)                    # [B, CA, G, G]

    # loc [B, 4A, G, G] -> [B, S, 4]: per cell, A anchors x 4 offsets.
    # channel layout chosen as (a, coord): reshape to [B, A, 4, G, G] then
    # transpose to [B, G, G, A, 4] and flatten the (G, G, A) box axis.
    (l5,) = b.node("Reshape", [loc, b.init(
        "shape_ba4gg", np.array([B, A, 4, G, G], np.int64))], ["loc5"])
    (lt,) = b.node("Transpose", [l5], ["loc_t"], perm=[0, 3, 4, 1, 2])
    (offsets,) = b.node("Reshape", [lt, b.init(
        "shape_bs4", np.array([B, S, 4], np.int64))], ["offsets"])

    # cls [B, CA, G, G] -> scores [B, C, S] (same box ordering as loc!)
    (c5,) = b.node("Reshape", [cls, b.init(
        "shape_bacgg", np.array([B, A, C, G, G], np.int64))], ["cls5"])
    (ct,) = b.node("Transpose", [c5], ["cls_t"], perm=[0, 2, 3, 4, 1])
    (logits,) = b.node("Reshape", [ct, b.init(
        "shape_bcs", np.array([B, C, S], np.int64))], ["cls_logits"])
    (scores,) = b.node("Sigmoid", [logits], ["scores"])

    # anchor decode, all elementwise ONNX ops over [B, S, *]
    anchors = make_anchors(cfg)                    # [S, 4] (cy, cx, h, w)
    b.init("anchor_ctr", anchors[:, :2].reshape(1, S, 2))
    b.init("anchor_size", anchors[:, 2:].reshape(1, S, 2))
    b.init("var_ctr", np.float32(0.1))
    b.init("var_size", np.float32(0.2))
    half = b.init("half", np.float32(0.5))
    (t_ctr, t_size) = b.node("Split", [offsets], ["t_ctr", "t_size"],
                             axis=-1, split=[2, 2])
    (d_ctr,) = b.node("Mul", [t_ctr, "var_ctr"], ["d_ctr"])
    (d_ctr,) = b.node("Mul", [d_ctr, "anchor_size"], ["d_ctr_s"])
    (ctr,) = b.node("Add", ["anchor_ctr", d_ctr], ["ctr"])
    (d_size,) = b.node("Mul", [t_size, "var_size"], ["d_size"])
    (d_size,) = b.node("Exp", [d_size], ["d_size_e"])
    (size,) = b.node("Mul", ["anchor_size", d_size], ["size"])
    (half_size,) = b.node("Mul", [size, half], ["half_size"])
    (lo,) = b.node("Sub", [ctr, half_size], ["box_lo"])   # (y1, x1)
    (hi,) = b.node("Add", [ctr, half_size], ["box_hi"])   # (y2, x2)
    (boxes,) = b.node("Concat", [lo, hi], ["boxes"], axis=-1)  # [B, S, 4]

    b.init("nms_max", np.int64(cfg.max_out))
    b.init("nms_iou", np.float32(cfg.iou_threshold))
    b.init("nms_score", np.float32(cfg.score_threshold))
    (sel,) = b.node("NonMaxSuppression",
                    [boxes, scores, "nms_max", "nms_iou", "nms_score"],
                    ["selected_indices"])

    b.output(boxes, [B, S, 4])
    b.output(scores, [B, C, S])
    b.output(sel, [B * C * cfg.max_out, 3], dtype=np.int64)
    return b.model()
