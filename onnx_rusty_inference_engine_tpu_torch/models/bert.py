"""BERT-style transformer encoder ONNX builder: the port's copy of
onnx_rusty_inference_engine_tpu/models/bert.py.

Bidirectional self-attention driven by a runtime `attention_mask` input
(Cast/Sub/Mul -> additive bias), token + position + segment embeddings,
post-LayerNorm residuals, erf-Gelu, and a Slice + Tanh pooler head: the
standard HuggingFace/ONNX-zoo BERT export graph shape. Its INT8 form runs
every weight MatMul as a QLinearMatMul while the activation x activation
attention matmuls stay fp32 islands. The same config, batch, length and
seed give the JAX package's graph node for node and weight for weight.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    max_positions: int = 512
    type_vocab_size: int = 2
    hidden: int = 768
    n_layer: int = 12
    n_head: int = 12

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_head


TINY = BertConfig(vocab_size=128, max_positions=32, hidden=48, n_layer=2,
                  n_head=4)
BASE = BertConfig()


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
                  axis=-1, epsilon=1e-12)
    return y


def build_bert(
    cfg: BertConfig = TINY,
    *,
    batch: int = 1,
    seq_len: int = 16,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    b = GraphBuilder("bert", opset=opset, seed=seed)
    B, T = batch, seq_len
    D, H, hd = cfg.hidden, cfg.n_head, cfg.head_dim

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    seg = b.input("token_type_ids", [B, T], dtype=np.int64)
    am = b.input("attention_mask", [B, T], dtype=np.int64)

    wte = b.init("word_emb", (b.rng.standard_normal((cfg.vocab_size, D))
                              * 0.02).astype(np.float32))
    wpe = b.init("pos_emb", (b.rng.standard_normal((cfg.max_positions, D))
                             * 0.01).astype(np.float32))
    wtt = b.init("type_emb", (b.rng.standard_normal((cfg.type_vocab_size, D))
                              * 0.01).astype(np.float32))
    pos = b.init("positions", np.arange(T, dtype=np.int64))

    (tok,) = b.node("Gather", [wte, ids], ["tok_e"], axis=0)
    (pe,) = b.node("Gather", [wpe, pos], ["pos_e"], axis=0)
    (te,) = b.node("Gather", [wtt, seg], ["type_e"], axis=0)
    (x,) = b.node("Add", [tok, pe], ["emb_tp"])
    (x,) = b.node("Add", [x, te], ["emb_sum"])
    x = _layernorm(b, x, "emb_ln", D)

    # attention_mask [B,T] {0,1} -> additive bias [B,1,1,T]: (1-m) * -1e9
    (mf,) = b.node("Cast", [am], ["mask_f"], to=int(onnx_io.NUMPY_TO_DTYPE[
        np.dtype(np.float32)]))
    one = b.init("one_f", np.float32(1.0))
    neg = b.init("neg_1e9", np.float32(-1e9))
    (inv,) = b.node("Sub", [one, mf], ["mask_inv"])
    (bias,) = b.node("Mul", [inv, neg], ["mask_bias2d"])
    (bias,) = b.node("Reshape", [bias, b.init(
        "mask_shape", np.array([B, 1, 1, T], np.int64))], ["mask_bias"])

    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))

    for i in range(cfg.n_layer):
        # BERT exports use separate Q/K/V projections (vs GPT-2's fused QKV)
        q = _linear(b, x, f"l{i}_q", D, D)
        k = _linear(b, x, f"l{i}_k", D, D)
        v = _linear(b, x, f"l{i}_v", D, D)

        def _heads(t: str, tag: str) -> str:
            (r,) = b.node("Reshape", [t, shape_split], [f"l{i}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"l{i}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr  # [B,H,T,hd]

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")
        (kt,) = b.node("Transpose", [kh], [f"l{i}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"l{i}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"l{i}_scaled"])
        (att,) = b.node("Add", [att, bias], [f"l{i}_masked"])
        (att,) = b.node("Softmax", [att], [f"l{i}_probs"], axis=-1)
        (ctxt,) = b.node("MatMul", [att, vh], [f"l{i}_ctx"])
        (ctxt,) = b.node("Transpose", [ctxt], [f"l{i}_ctx_t"],
                         perm=[0, 2, 1, 3])
        (ctxt,) = b.node("Reshape", [ctxt, shape_merge], [f"l{i}_ctx_m"])
        proj = _linear(b, ctxt, f"l{i}_attn_out", D, D)
        # post-LN (BERT) — vs GPT-2's pre-LN
        (res1,) = b.node("Add", [x, proj], [f"l{i}_res1"])
        x = _layernorm(b, res1, f"l{i}_ln1", D)

        h = _linear(b, x, f"l{i}_ffn_in", D, 4 * D)
        (h,) = b.node("Gelu", [h], [f"l{i}_gelu"])  # exact erf form
        h = _linear(b, h, f"l{i}_ffn_out", 4 * D, D)
        (res2,) = b.node("Add", [x, h], [f"l{i}_res2"])
        x = _layernorm(b, res2, f"l{i}_ln2", D)

    b.node("Identity", [x], ["last_hidden_state"])

    # pooler: first (CLS) token -> dense -> Tanh
    (cls,) = b.node("Slice", [x, b.init("sl_starts", np.array([0], np.int64)),
                              b.init("sl_ends", np.array([1], np.int64)),
                              b.init("sl_axes", np.array([1], np.int64))],
                    ["cls_tok"])
    (cls,) = b.node("Reshape", [cls, b.init(
        "shape_bd", np.array([B, D], np.int64))], ["cls_flat"])
    pooled = _linear(b, cls, "pooler", D, D)
    (pooled,) = b.node("Tanh", [pooled], ["pooler_output"])

    b.output("last_hidden_state", [B, T, D])
    b.output("pooler_output", [B, D])
    return b.model()
