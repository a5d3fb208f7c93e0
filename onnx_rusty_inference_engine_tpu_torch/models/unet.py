"""Compact UNet ONNX builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/unet.py.

The encoder-decoder segmentation family: 3x3 conv + Relu per level, a
stride-2 conv to go down, ConvTranspose (2x2, stride 2) to come back up,
and skip connections joined by channel Concat. `UNetConfig()` is base 16,
depth 3, 2 classes; `TINY` is the tests' size. Its INT8 form
(quant.quantize_graph) runs the 11 convs of UNetConfig() as QLinearConvs
on the hand int8 kernel; the ConvTransposes stay fp32 between them. The
same config, batch, size and seed give the JAX package's ONNX bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder


@dataclasses.dataclass
class UNetConfig:
    in_channels: int = 3
    base: int = 16
    depth: int = 3  # number of down/up levels
    num_classes: int = 2


TINY = UNetConfig(base=8, depth=2, num_classes=3)


def _conv_relu(b: GraphBuilder, x: str, name: str, cin: int, cout: int,
               stride: int = 1) -> str:
    w = b.he(f"{name}_w", (cout, cin, 3, 3))
    bias = b.zeros(f"{name}_b", (cout,))
    (y,) = b.node("Conv", [x, w, bias], [f"{name}_y"], kernel_shape=[3, 3],
                  strides=[stride, stride], pads=[1, 1, 1, 1])
    (y,) = b.node("Relu", [y], [f"{name}_r"])
    return y


def build_unet(cfg: UNetConfig = TINY, *, batch: int = 1, size: int = 32,
               opset: int = 13, seed: int = 0) -> onnx_io.ModelProto:
    b = GraphBuilder("unet", opset=opset, seed=seed)
    x = b.input("image", [batch, cfg.in_channels, size, size])

    # encoder: conv + strided-conv downsample per level, keeping skips
    skips = []
    h, cin = x, cfg.in_channels
    ch = cfg.base
    for d in range(cfg.depth):
        h = _conv_relu(b, h, f"enc{d}", cin, ch)
        skips.append((h, ch))
        h = _conv_relu(b, h, f"down{d}", ch, ch * 2, stride=2)
        cin, ch = ch * 2, ch * 2

    h = _conv_relu(b, h, "bottleneck", ch, ch)

    # decoder: ConvTranspose x2 upsample, concat skip, fuse
    for d in reversed(range(cfg.depth)):
        skip, sk_ch = skips[d]
        up_ch = ch // 2
        w = b.he(f"up{d}_w", (ch, up_ch, 2, 2))  # [C_in, C_out, k, k]
        (h,) = b.node("ConvTranspose", [h, w], [f"up{d}_y"],
                      kernel_shape=[2, 2], strides=[2, 2])
        (h,) = b.node("Concat", [h, skip], [f"cat{d}"], axis=1)
        h = _conv_relu(b, h, f"dec{d}", up_ch + sk_ch, up_ch)
        ch = up_ch

    w = b.he("head_w", (cfg.num_classes, ch, 1, 1))
    bias = b.zeros("head_b", (cfg.num_classes,))
    (logits,) = b.node("Conv", [h, w, bias], ["mask_logits"],
                       kernel_shape=[1, 1])
    b.output("mask_logits", [batch, cfg.num_classes, size, size])
    return b.model()
