"""R3D-18 (torchvision's `models/video/resnet.py::r3d_18`, Kinetics-400) as
ONNX bytes, for the port's tests and chip_smoke.py.

The graph `torch.onnx.export` writes for the model in eval mode, with
BatchNorm folded into the convs' weights and biases:
- stem: Conv3d 3 -> 64, kernel (3, 7, 7), stride (1, 2, 2), pad (1, 3, 3),
  Relu;
- four stages of BasicBlocks at 64 / 128 / 256 / 512 channels, stride 1 /
  2 / 2 / 2 in time, height and width: Conv 3x3x3 (pad 1, the stage's
  stride on the first block), Relu, Conv 3x3x3, the shortcut (a 1x1x1
  stride-s Conv where the stride or the width changes), Add, Relu;
- GlobalAveragePool, Flatten, Gemm 512 -> 400.
Weights are random from a numpy seed (He-initialized convs, BatchNorm
statistics and affine terms drawn near 1 and 0, then folded). `width`
scales every stage's channels and `blocks` sets the BasicBlocks a stage,
for the narrow CPU tests; the defaults are the published widths
(2 blocks a stage, 20 convs).

It imports the port only, never JAX: the file is ONNX bytes
(`onnx_io.serialize_model`) that both packages parse.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.models._builder import (
    GraphBuilder)

__all__ = ["build_r3d18", "r3d18_bytes", "R3D_INPUT", "R3D_LOGITS",
           "R3D_CLIP"]

R3D_INPUT = "video"
R3D_LOGITS = "logits"
# Kinetics-400 clips as torchvision's video models take them: 3 x T x H x W
R3D_CLIP = (3, 16, 112, 112)
BN_EPS = 1e-5


def _conv_bn(b: GraphBuilder, x: str, name: str, c_in: int, c_out: int,
             kernel: Tuple[int, int, int], stride: Tuple[int, int, int],
             pad: Tuple[int, int, int]) -> str:
    """Conv3d (no bias) + BatchNorm3d folded as the eval-mode export
    writes them: w * gamma / sqrt(var + eps) and beta - mean * that."""
    fan = c_in * int(np.prod(kernel))
    w = (b.rng.standard_normal((c_out, c_in, *kernel))
         * np.sqrt(2.0 / fan)).astype(np.float32)
    gamma = (1.0 + 0.1 * b.rng.standard_normal(c_out)).astype(np.float32)
    beta = (0.1 * b.rng.standard_normal(c_out)).astype(np.float32)
    mean = (0.1 * b.rng.standard_normal(c_out)).astype(np.float32)
    var = (1.0 + 0.1 * np.abs(b.rng.standard_normal(c_out))).astype(
        np.float32)
    k = gamma / np.sqrt(var + np.float32(BN_EPS))
    wf = b.init(f"{name}.weight", (w * k.reshape(-1, 1, 1, 1, 1)).astype(
        np.float32))
    bf = b.init(f"{name}.bias", (beta - mean * k).astype(np.float32))
    (y,) = b.node("Conv", [x, wf, bf], [f"{name}_out"], name=name,
                  kernel_shape=list(kernel), strides=list(stride),
                  pads=list(pad) * 2, dilations=[1, 1, 1], group=1)
    return y


def _block(b: GraphBuilder, x: str, name: str, c_in: int, c_out: int,
           stride: int) -> str:
    s = (stride,) * 3
    y = _conv_bn(b, x, f"{name}.conv1", c_in, c_out, (3, 3, 3), s,
                 (1, 1, 1))
    (y,) = b.node("Relu", [y], [f"{name}.relu1"])
    y = _conv_bn(b, y, f"{name}.conv2", c_out, c_out, (3, 3, 3), (1, 1, 1),
                 (1, 1, 1))
    short = x
    if stride != 1 or c_in != c_out:
        short = _conv_bn(b, x, f"{name}.downsample", c_in, c_out, (1, 1, 1),
                         s, (0, 0, 0))
    (y,) = b.node("Add", [y, short], [f"{name}.add"])
    (y,) = b.node("Relu", [y], [f"{name}.out"])
    return y


def build_r3d18(seed: int = 0, width: int = 64,
                blocks: Sequence[int] = (2, 2, 2, 2),
                num_classes: int = 400,
                clip: Sequence[int] = R3D_CLIP) -> onnx_io.ModelProto:
    """R3D-18 at `width` channels in its first stage (64: the published
    model) with `blocks` BasicBlocks a stage, over [N, 3, T, H, W] clips."""
    b = GraphBuilder("r3d_18", opset=13, seed=seed)
    x = b.input(R3D_INPUT, ["N", *clip])
    y = _conv_bn(b, x, "stem.0", clip[0], width, (3, 7, 7), (1, 2, 2),
                 (1, 3, 3))
    (y,) = b.node("Relu", [y], ["stem.relu"])
    c_in = width
    for i, n in enumerate(blocks):
        c_out = width * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            y = _block(b, y, f"layer{i + 1}.{j}", c_in, c_out, stride)
            c_in = c_out
    (y,) = b.node("GlobalAveragePool", [y], ["avgpool"])
    (y,) = b.node("Flatten", [y], ["flatten"], axis=1)
    fc_w = b.init("fc.weight", (b.rng.standard_normal((num_classes, c_in))
                                * np.sqrt(1.0 / c_in)).astype(np.float32))
    fc_b = b.init("fc.bias", (0.01 * b.rng.standard_normal(num_classes)
                              ).astype(np.float32))
    (y,) = b.node("Gemm", [y, fc_w, fc_b], [R3D_LOGITS], name="fc",
                  transB=1)
    b.output(y, ["N", num_classes])
    return b.model(producer="pytorch")


def r3d18_bytes(**kw) -> bytes:
    """`build_r3d18(**kw)` serialized: the ONNX file both packages parse."""
    return onnx_io.serialize_model(build_r3d18(**kw))
