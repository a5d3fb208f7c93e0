"""Vision Transformer (ViT) ONNX builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/vit.py.

Patch embedding as a stride-P convolution, learned CLS token + position
embeddings (Concat of an expanded constant with the patch sequence), pre-LN
encoder blocks with erf-Gelu MLPs, and a classification head over the CLS
position. `ViTConfig()` holds ViT-B/16's published widths (224x224, patch
16, hidden 768, 12 layers of 12 heads, 1000 classes); `TINY` is the tests'
size. The batch is baked into the Reshape and Expand constants, so a graph
is built at the batch it runs. Its INT8 form runs the patch conv as one
QLinearConv and every weight MatMul as a QLinearMatMul (6 a layer and the
head); the attention matmuls stay fp32. The same config, batch and seed
give the JAX package's graph node for node and weight for weight.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden: int = 768
    n_layer: int = 12
    n_head: int = 12
    num_classes: int = 1000

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_head


TINY = ViTConfig(image_size=32, patch_size=8, hidden=48, n_layer=2,
                 n_head=4, num_classes=10)


def _linear(b: GraphBuilder, x: str, name: str, d_in: int, d_out: int) -> str:
    w = b.init(f"{name}_w", (b.rng.standard_normal((d_in, d_out))
                             * 0.02).astype(np.float32))
    bias = b.zeros(f"{name}_b", (d_out,))
    (y,) = b.node("MatMul", [x, w], [f"{name}_mm"])
    (y,) = b.node("Add", [y, bias], [f"{name}_y"])
    return y


def _layernorm(b: GraphBuilder, x: str, name: str, d: int) -> str:
    g = b.init(f"{name}_g", np.ones(d, np.float32))
    bb = b.zeros(f"{name}_b", (d,))
    (y,) = b.node("LayerNormalization", [x, g, bb], [f"{name}_y"],
                  axis=-1, epsilon=1e-6)
    return y


def build_vit(cfg: ViTConfig = TINY, *, batch: int = 1, opset: int = 17,
              seed: int = 0) -> onnx_io.ModelProto:
    b = GraphBuilder("vit", opset=opset, seed=seed)
    B, D, H, hd = batch, cfg.hidden, cfg.n_head, cfg.head_dim
    P, N = cfg.patch_size, cfg.n_patches
    S = N + 1  # CLS + patches

    x = b.input("pixel_values", [B, 3, cfg.image_size, cfg.image_size])

    # patch embedding: stride-P conv -> [B, D, H/P, W/P] -> [B, N, D]
    pw = b.he("patch_w", (D, 3, P, P))
    pb = b.zeros("patch_b", (D,))
    (h,) = b.node("Conv", [x, pw, pb], ["patches"], kernel_shape=[P, P],
                  strides=[P, P], pads=[0, 0, 0, 0])
    (h,) = b.node("Reshape", [h, b.init(
        "flat_shape", np.array([B, D, N], np.int64))], ["patches_flat"])
    (h,) = b.node("Transpose", [h], ["patch_seq"], perm=[0, 2, 1])

    # CLS token (expanded over the batch) + position embeddings
    cls = b.init("cls_token", (b.rng.standard_normal((1, 1, D))
                               * 0.02).astype(np.float32))
    (cls_b,) = b.node("Expand", [cls, b.init(
        "cls_shape", np.array([B, 1, D], np.int64))], ["cls_batched"])
    (h,) = b.node("Concat", [cls_b, h], ["seq0"], axis=1)
    pos = b.init("pos_emb", (b.rng.standard_normal((1, S, D))
                             * 0.02).astype(np.float32))
    (h,) = b.node("Add", [h, pos], ["h0"])

    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    qshape = b.init("shape_bshd", np.array([B, S, H, hd], np.int64))
    mshape = b.init("shape_bsd", np.array([B, S, D], np.int64))

    for i in range(cfg.n_layer):
        ln1 = _layernorm(b, h, f"l{i}_ln1", D)
        q = _linear(b, ln1, f"l{i}_q", D, D)
        k = _linear(b, ln1, f"l{i}_k", D, D)
        v = _linear(b, ln1, f"l{i}_v", D, D)

        def _heads(t, tag):
            (r,) = b.node("Reshape", [t, qshape], [f"l{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"l{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")
        (kt,) = b.node("Transpose", [kh], [f"l{i}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"l{i}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"l{i}_scaled"])
        (att,) = b.node("Softmax", [att], [f"l{i}_probs"], axis=-1)
        (ctxt,) = b.node("MatMul", [att, vh], [f"l{i}_ctx"])
        (ctxt,) = b.node("Transpose", [ctxt], [f"l{i}_ctx_t"],
                         perm=[0, 2, 1, 3])
        (ctxt,) = b.node("Reshape", [ctxt, mshape], [f"l{i}_ctx_m"])
        proj = _linear(b, ctxt, f"l{i}_proj", D, D)
        (h,) = b.node("Add", [h, proj], [f"l{i}_res1"])

        ln2 = _layernorm(b, h, f"l{i}_ln2", D)
        m = _linear(b, ln2, f"l{i}_fc", D, 4 * D)
        (m,) = b.node("Gelu", [m], [f"l{i}_gelu"])
        m = _linear(b, m, f"l{i}_out", 4 * D, D)
        (h,) = b.node("Add", [h, m], [f"l{i}_res2"])

    h = _layernorm(b, h, "ln_f", D)
    # classification over the CLS position
    (cls_out,) = b.node("Slice", [h, b.init("s0", np.array([0], np.int64)),
                                  b.init("s1", np.array([1], np.int64)),
                                  b.init("sa", np.array([1], np.int64))],
                        ["cls_hidden"])
    (cls_out,) = b.node("Reshape", [cls_out, b.init(
        "shape_bd", np.array([B, D], np.int64))], ["cls_flat"])
    logits = _linear(b, cls_out, "head", D, cfg.num_classes)
    b.node("Identity", [logits], ["logits"])
    b.output("logits", [B, cfg.num_classes])
    return b.model()
