"""SqueezeNet 1.0 (opset 8) ONNX builder.

The reference wires squeezenet1.0-8.onnx as its second demo model
(reference: src/main.rs:16-20) but the blob is missing from its checkout
(.MISSING_LARGE_BLOBS). This builder reconstructs the exact ONNX-zoo
SqueezeNet 1.0 graph topology — same op sequence (Conv/Relu/MaxPool, eight
fire modules with 1x1/3x3 parallel expand branches feeding Concat, Dropout,
1x1 conv head, GlobalAveragePool, Softmax), same I/O names (`data_0` →
`softmaxout_1`) and shapes ([1,3,224,224] → [1,1000,1,1]) — with seeded
He-initialized weights. The fire modules' parallel expand branches are the
graph shape the reference's thread-spawning scheduler exists for
(SURVEY.md §3.3); here the engine runs them one after the other.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder

# (squeeze_channels, expand1x1_channels, expand3x3_channels) per fire module
_FIRE_CFG = [
    (16, 64, 64),    # fire2
    (16, 64, 64),    # fire3
    (32, 128, 128),  # fire4
    (32, 128, 128),  # fire5
    (48, 192, 192),  # fire6
    (48, 192, 192),  # fire7
    (64, 256, 256),  # fire8
    (64, 256, 256),  # fire9
]
# MaxPool placed after fire module index (0-based, post-module); SqueezeNet1.0
# pools after conv1, fire4 (idx 2), fire8 (idx 6).
_POOL_AFTER = {2, 6}


def _conv(b: GraphBuilder, x: str, name: str, c_in: int, c_out: int,
          k: int, stride: int = 1, pads=None) -> str:
    w = b.he(f"{name}_w_0", (c_out, c_in, k, k))
    bias = b.zeros(f"{name}_b_0", (c_out,))
    pads = pads if pads is not None else [0, 0, 0, 0]
    (y,) = b.node(
        "Conv", [x, w, bias], [f"{name}_1"],
        kernel_shape=[k, k], strides=[stride, stride], pads=pads,
        dilations=[1, 1], group=1,
    )
    (r,) = b.node("Relu", [y], [f"{name}_relu_1"])
    return r


def _fire(b: GraphBuilder, x: str, idx: int, c_in: int, sq: int, e1: int,
          e3: int) -> str:
    name = f"fire{idx}"
    s = _conv(b, x, f"{name}/squeeze1x1", c_in, sq, 1)
    left = _conv(b, s, f"{name}/expand1x1", sq, e1, 1)
    right = _conv(b, s, f"{name}/expand3x3", sq, e3, 3, pads=[1, 1, 1, 1])
    (out,) = b.node("Concat", [left, right], [f"{name}/concat_1"], axis=1)
    return out


def build_squeezenet(opset: int = 8, seed: int = 0,
                     num_classes: int = 1000) -> onnx_io.ModelProto:
    b = GraphBuilder("squeezenet1.0", opset=opset, seed=seed)
    x = b.input("data_0", [1, 3, 224, 224])

    y = _conv(b, x, "conv1", 3, 96, 7, stride=2)
    (y,) = b.node("MaxPool", [y], ["pool1_1"], kernel_shape=[3, 3],
                  strides=[2, 2], pads=[0, 0, 0, 0])

    c_in = 96
    for i, (sq, e1, e3) in enumerate(_FIRE_CFG):
        y = _fire(b, y, i + 2, c_in, sq, e1, e3)
        c_in = e1 + e3
        if i in _POOL_AFTER:
            (y,) = b.node("MaxPool", [y], [f"pool{i + 2}_1"],
                          kernel_shape=[3, 3], strides=[2, 2],
                          pads=[0, 0, 0, 0])

    (y,) = b.node("Dropout", [y], ["drop9_1"], ratio=0.5)
    y = _conv(b, y, "conv10", c_in, num_classes, 1)
    (y,) = b.node("GlobalAveragePool", [y], ["pool10_1"])
    (y,) = b.node("Softmax", [y], ["softmaxout_1"])
    b.output(y, [1, num_classes, 1, 1])
    return b.model()
