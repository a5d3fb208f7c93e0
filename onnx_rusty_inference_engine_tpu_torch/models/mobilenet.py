"""MobileNetV2 ONNX builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/mobilenet.py.

Standard torchvision/ONNX-zoo topology (width 1.0): 3x3/s2 stem, 17
inverted residual blocks (t,c,n,s config below), 1x1 head to 1280, GAP,
Gemm classifier, Softmax. Its inverted residual blocks exercise what the
other CNNs do not: `group == channels` depthwise convs (17 of its 52
convs; in INT8 the grouped kernel, ops/kernels/qconv_grouped_int8.py),
ReLU6 as a Clip with constant bounds kept in int8 by the quantizer, and
residual Adds between quantized tensors (QLinearAdd). The input is declared
[1, 3, 224, 224]; other batches run through the engine's batch
polymorphism. The same seed gives the JAX package's constants bit for bit.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder

# (expansion t, out channels c, repeats n, first stride s)
_IR_CFG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _conv(b: GraphBuilder, x: str, name: str, c_in: int, c_out: int, k: int,
          stride: int = 1, pad: int = 0, group: int = 1) -> str:
    # depthwise convs have weight [C, 1, k, k]; fan-in accordingly
    w = b.he(f"{name}_w", (c_out, c_in // group, k, k))
    bias = b.zeros(f"{name}_b", (c_out,))
    (y,) = b.node("Conv", [x, w, bias], [f"{name}_y"], kernel_shape=[k, k],
                  strides=[stride, stride], pads=[pad, pad, pad, pad],
                  dilations=[1, 1], group=group)
    return y


def _relu6(b: GraphBuilder, x: str, name: str) -> str:
    lo = b.init(f"{name}_min", np.float32(0.0))
    hi = b.init(f"{name}_max", np.float32(6.0))
    (y,) = b.node("Clip", [x, lo, hi], [f"{name}_y"])
    return y


def _inverted_residual(b: GraphBuilder, x: str, idx: int, c_in: int,
                       c_out: int, stride: int, expand: int) -> str:
    name = f"block{idx}"
    mid = c_in * expand
    h = x
    if expand != 1:
        h = _conv(b, h, f"{name}/expand", c_in, mid, 1)
        h = _relu6(b, h, f"{name}/expand_relu6")
    h = _conv(b, h, f"{name}/dw", mid, mid, 3, stride=stride, pad=1,
              group=mid)
    h = _relu6(b, h, f"{name}/dw_relu6")
    h = _conv(b, h, f"{name}/project", mid, c_out, 1)
    if stride == 1 and c_in == c_out:
        (h,) = b.node("Add", [x, h], [f"{name}/add_y"])
    return h


def build_mobilenetv2(opset: int = 13, seed: int = 0,
                      num_classes: int = 1000) -> onnx_io.ModelProto:
    b = GraphBuilder("mobilenetv2-1.0", opset=opset, seed=seed)
    x = b.input("input", [1, 3, 224, 224])

    y = _conv(b, x, "stem", 3, 32, 3, stride=2, pad=1)
    y = _relu6(b, y, "stem_relu6")

    c_in, idx = 32, 0
    for t, c, n, s in _IR_CFG:
        for i in range(n):
            y = _inverted_residual(b, y, idx, c_in, c, s if i == 0 else 1, t)
            c_in = c
            idx += 1

    y = _conv(b, y, "head", c_in, 1280, 1)
    y = _relu6(b, y, "head_relu6")
    (y,) = b.node("GlobalAveragePool", [y], ["gap_y"])
    (y,) = b.node("Flatten", [y], ["flat_y"], axis=1)
    w = b.he("fc_w", (1280, num_classes), fan_in=1280)
    bias = b.zeros("fc_b", (num_classes,))
    (y,) = b.node("Gemm", [y, w, bias], ["logits"], alpha=1.0, beta=1.0)
    (y,) = b.node("Softmax", [y], ["output"], axis=1)
    b.output(y, [1, num_classes])
    return b.model()
