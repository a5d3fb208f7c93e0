"""ResNet-50 v1 ONNX builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/resnet.py (north-star configuration
#4 is ResNet-50 INT8).

Standard zoo topology: 7x7/2 stem conv + BN + MaxPool, four bottleneck
stages [3,4,6,3], GlobalAveragePool, Flatten, Gemm(1000). BatchNormalization
nodes are kept explicit (not pre-folded) so the importer's BN-fold pass
runs on a real topology; after import the graph holds 53 Conv, 1 Gemm and
no BN. Its INT8 form runs 53 QLinearConvs, 16 QLinearAdds (the residual
adds) and the head as a QLinearMatMul. The same seed gives the JAX
package's constants bit for bit.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder

_STAGES = [  # (n_blocks, mid_channels, out_channels, first_stride)
    (3, 64, 256, 1),
    (4, 128, 512, 2),
    (6, 256, 1024, 2),
    (3, 512, 2048, 2),
]


def _conv(b: GraphBuilder, x: str, name: str, c_in: int, c_out: int, k: int,
          stride: int = 1, pad: int = 0) -> str:
    w = b.he(f"{name}_w", (c_out, c_in, k, k))
    (y,) = b.node("Conv", [x, w], [f"{name}_y"], kernel_shape=[k, k],
                  strides=[stride, stride], pads=[pad, pad, pad, pad])
    return y


def _bn(b: GraphBuilder, x: str, name: str, c: int) -> str:
    rng = b.rng
    scale = b.init(f"{name}_scale", (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    bias = b.zeros(f"{name}_bias", (c,))
    mean = b.init(f"{name}_mean", (0.05 * rng.standard_normal(c)).astype(np.float32))
    var = b.init(f"{name}_var", (1.0 + 0.1 * np.abs(rng.standard_normal(c))).astype(np.float32))
    (y,) = b.node("BatchNormalization", [x, scale, bias, mean, var],
                  [f"{name}_y"], epsilon=1e-5)
    return y


def _bottleneck(b: GraphBuilder, x: str, name: str, c_in: int, mid: int,
                out: int, stride: int) -> str:
    y = _conv(b, x, f"{name}_conv1", c_in, mid, 1)
    y = _bn(b, y, f"{name}_bn1", mid)
    (y,) = b.node("Relu", [y], [f"{name}_relu1"])
    y = _conv(b, y, f"{name}_conv2", mid, mid, 3, stride=stride, pad=1)
    y = _bn(b, y, f"{name}_bn2", mid)
    (y,) = b.node("Relu", [y], [f"{name}_relu2"])
    y = _conv(b, y, f"{name}_conv3", mid, out, 1)
    y = _bn(b, y, f"{name}_bn3", out)
    if stride != 1 or c_in != out:
        sc = _conv(b, x, f"{name}_down", c_in, out, 1, stride=stride)
        sc = _bn(b, sc, f"{name}_down_bn", out)
    else:
        sc = x
    (y,) = b.node("Add", [y, sc], [f"{name}_add"])
    (y,) = b.node("Relu", [y], [f"{name}_out"])
    return y


def build_resnet50(opset: int = 13, seed: int = 0, num_classes: int = 1000,
                   batch: int = 1) -> onnx_io.ModelProto:
    b = GraphBuilder("resnet50", opset=opset, seed=seed)
    x = b.input("data", [batch, 3, 224, 224])

    y = _conv(b, x, "stem", 3, 64, 7, stride=2, pad=3)
    y = _bn(b, y, "stem_bn", 64)
    (y,) = b.node("Relu", [y], ["stem_relu"])
    (y,) = b.node("MaxPool", [y], ["stem_pool"], kernel_shape=[3, 3],
                  strides=[2, 2], pads=[1, 1, 1, 1])

    c_in = 64
    for si, (n_blocks, mid, out, stride) in enumerate(_STAGES):
        for bi in range(n_blocks):
            y = _bottleneck(b, y, f"s{si}b{bi}", c_in, mid, out,
                            stride if bi == 0 else 1)
            c_in = out

    (y,) = b.node("GlobalAveragePool", [y], ["gap"])
    (y,) = b.node("Flatten", [y], ["feat"], axis=1)
    fc_w = b.he("fc_w", (2048, num_classes), fan_in=2048)
    fc_b = b.zeros("fc_b", (num_classes,))
    (y,) = b.node("Gemm", [y, fc_w, fc_b], ["logits"])
    b.output(y, [batch, num_classes])
    return b.model()
