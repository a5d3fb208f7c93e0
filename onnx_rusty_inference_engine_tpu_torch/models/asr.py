"""Whisper-style ASR family, raw waveform -> text tokens: the port's copy of
onnx_rusty_inference_engine_tpu/models/asr.py.

The in-graph audio trunk (models/audio.encoder_trunk: STFT + mel + conv
stem + transformer encoder, one graph) feeds an autoregressive token
decoder with cross-attention, split as T5 is (models/t5.py):

- build_asr_encoder: audio [B, n_samples] -> enc_out [B, S, D] plus
  per-decoder-layer cross_key_i / cross_value_i (projected here with the
  decoder's cross weights, so decode never reads enc_out again);
- build_asr_decode: one token per step over a fixed self-attention KV
  cache (per-slot `pos [B]`, int8-capable) + static cross K/V.

Decoder shape (whisper lineage, not a weight port): pre-LN blocks with
LayerNormalization, 1/sqrt(hd)-scaled attention, a GELU MLP, sinusoidal
decoder positions baked as a constant table, a tied lm head.
`ASRConfig()` is whisper-tiny's front end and encoder widths with a
2-layer decoder over a 128-token vocabulary.

Waveform pads are zeros (silence) and the encoder attends them like any
frames, so a source padded to n_samples decodes the same wherever it is
padded to that length; no source mask is needed. The same config and seed
give the JAX package's ONNX bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder, memo
from .audio import AudioEncoderConfig, _sinusoids, encoder_trunk


@dataclasses.dataclass
class ASRConfig(AudioEncoderConfig):
    vocab_size: int = 128
    n_dec_layer: int = 2
    n_positions: int = 64     # max decoded length


TINY = ASRConfig(n_fft=64, hop=32, n_mels=16, sample_rate=1600,
                 d_model=32, n_layer=2, n_head=4,
                 vocab_size=96, n_dec_layer=2, n_positions=64)


def _dec_weights(cfg: ASRConfig, seed: int) -> Dict[str, np.ndarray]:
    """Decoder-side parameters in ONE fixed rng order (rng independent of
    the encoder trunk's draws: seed+1), shared by both builders: the
    encoder graph inits the ca_k/ca_v projections, the decode graph
    everything else (inside host_memo, drawn once per config and seed)."""
    return memo(("asr", dataclasses.astuple(cfg), seed),
                lambda: _draw_dec_weights(cfg, seed))


def _draw_dec_weights(cfg: ASRConfig, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed + 1)
    D = cfg.d_model
    w: Dict[str, np.ndarray] = {}

    def lin(name, din, dout):
        w[name] = (rng.standard_normal((din, dout)) * din ** -0.5
                   ).astype(np.float32)

    w["dec_emb"] = (rng.standard_normal((cfg.vocab_size, D)) * 0.02
                    ).astype(np.float32)
    for i in range(cfg.n_dec_layer):
        for p in ("q", "k", "v", "o"):
            lin(f"dec{i}_sa_{p}", D, D)
        for p in ("q", "k", "v", "o"):
            lin(f"dec{i}_ca_{p}", D, D)
        lin(f"dec{i}_fc", D, 4 * D)
        lin(f"dec{i}_out", 4 * D, D)
    return w


def build_asr_encoder(
    cfg: ASRConfig = TINY,
    *,
    batch: int = 1,
    n_samples: int = 1024,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    """audio [B, n_samples] -> enc_out [B, S, D] + cross_{key,value}_i
    [B, H, S, hd] per decoder layer."""
    w = _dec_weights(cfg, seed)
    b = GraphBuilder("asr_encoder", opset=opset, seed=seed)
    B, D, H, hd = batch, cfg.d_model, cfg.n_head, cfg.head_dim
    h, S = encoder_trunk(b, cfg, batch, n_samples)
    (enc_out,) = b.node("Identity", [h], ["enc_out"])
    b.output(enc_out, [B, S, D])

    shape_bshd = b.init("x_shape_bshd", np.array([B, S, H, hd], np.int64))
    for i in range(cfg.n_dec_layer):
        b.init(f"dec{i}_ca_k", w[f"dec{i}_ca_k"])
        b.init(f"dec{i}_ca_v", w[f"dec{i}_ca_v"])
        (ck,) = b.node("MatMul", [enc_out, f"dec{i}_ca_k"], [f"x{i}_ck"])
        (cv,) = b.node("MatMul", [enc_out, f"dec{i}_ca_v"], [f"x{i}_cv"])
        for t, tag in ((ck, "ck"), (cv, "cv")):
            (r,) = b.node("Reshape", [t, shape_bshd], [f"x{i}_{tag}_r"])
            b.node("Transpose", [r],
                   [f"cross_{'key' if tag == 'ck' else 'value'}_{i}"],
                   perm=[0, 2, 1, 3])
        b.output(f"cross_key_{i}", [B, H, S, hd])
        b.output(f"cross_value_{i}", [B, H, S, hd])
    return b.model()


def enc_frames(cfg: ASRConfig, n_samples: int) -> int:
    """Cross-attention length S for a given waveform length (frontend
    frames after the stride-2 conv) — keep in sync with encoder_trunk."""
    return ((n_samples - cfg.n_fft) // cfg.hop + 1) // 2


def build_asr_decode(
    cfg: ASRConfig = TINY,
    *,
    batch: int = 1,
    max_len: int = 32,
    src_len: int = 16,          # S: encoder frames (enc_frames())
    opset: int = 17,
    seed: int = 0,
    kv_dtype: str = "float32",
) -> onnx_io.ModelProto:
    """Single-token ASR decode step: fixed self-attn KV cache (per-slot
    pos [B], int8-capable exactly like gpt2/t5) + static cross K/V from
    build_asr_encoder."""
    w = _dec_weights(cfg, seed)
    b = GraphBuilder("asr_decode", opset=opset, seed=seed)
    B, T, L, S = batch, 1, max_len, src_len
    D, H, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    int8_kv = np.dtype(kv_dtype) == np.int8
    cache_np = np.int8 if int8_kv else np.float32

    ids = b.input("input_ids", [B, T], dtype=np.int64)
    pos = b.input("pos", [B], dtype=np.int64)
    pasts = [(b.input(f"past_key_{i}", [B, H, L, hd], dtype=cache_np),
              b.input(f"past_value_{i}", [B, H, L, hd], dtype=cache_np))
             for i in range(cfg.n_dec_layer)]
    crosses = [(b.input(f"cross_key_{i}", [B, H, S, hd]),
                b.input(f"cross_value_{i}", [B, H, S, hd]))
               for i in range(cfg.n_dec_layer)]
    kv_scales = [(b.input(f"kv_scale_key_{i}", [H]),
                  b.input(f"kv_scale_value_{i}", [H]))
                 for i in range(cfg.n_dec_layer)] if int8_kv else None
    zp8 = b.init("kv_zp8", np.int8(0)) if int8_kv else None

    for name, arr in w.items():
        if "_ca_k" in name or "_ca_v" in name:
            continue            # projected once by the encoder
        b.init(name, arr)

    (tok,) = b.node("Gather", ["dec_emb", ids], ["tok_emb"], axis=0)
    b.init("dec_pos_table", _sinusoids(max(L, cfg.n_positions), D))
    (pe,) = b.node("Gather", ["dec_pos_table", pos], ["pos_emb"], axis=0)
    (pe,) = b.node("Reshape", [pe, b.init(
        "shape_B_1_D", np.array([B, 1, D], np.int64))], ["pos_emb3"])
    (x,) = b.node("Add", [tok, pe], ["h0"])

    # cache bookkeeping (same scheme as gpt2/t5 decode)
    arange = b.init("cache_positions", np.arange(L, dtype=np.int64))
    (pos2d,) = b.node("Reshape", [pos, b.init(
        "shape_B_1", np.array([B, 1], np.int64))], ["pos2d"])
    (is_now,) = b.node("Equal", [arange, pos2d], ["is_now"])
    (is_now4,) = b.node("Reshape", [is_now, b.init(
        "shape_B_1_L_1", np.array([B, 1, L, 1], np.int64))], ["is_now4"])
    (valid,) = b.node("LessOrEqual", [arange, pos2d], ["valid"])
    neg = b.init("neg_inf", np.float32(-1e9))
    zero = b.init("zero_f", np.float32(0.0))
    (attn_bias,) = b.node("Where", [valid, zero, neg], ["attn_bias"])
    (attn_bias4,) = b.node("Reshape", [attn_bias, b.init(
        "shape_B_1_1_L", np.array([B, 1, 1, L], np.int64))], ["attn_bias4"])

    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    shape_split = b.init("shape_bthd", np.array([B, T, H, hd], np.int64))
    shape_merge = b.init("shape_btd", np.array([B, T, D], np.int64))

    def _ln(x, tag):
        g = b.init(f"{tag}_g", np.ones(D, np.float32))
        bb = b.zeros(f"{tag}_b", (D,))
        (y,) = b.node("LayerNormalization", [x, g, bb], [f"{tag}_y"],
                      axis=-1, epsilon=1e-5)
        return y

    def _heads(t, tag):
        (r,) = b.node("Reshape", [t, shape_split], [f"{tag}_r"])
        (tr,) = b.node("Transpose", [r], [f"{tag}_t"], perm=[0, 2, 1, 3])
        return tr

    for i in range(cfg.n_dec_layer):
        # -- causal self-attention over the fixed cache ---------------------
        xn = _ln(x, f"d{i}_ln1")
        (qp,) = b.node("MatMul", [xn, f"dec{i}_sa_q"], [f"d{i}_saq"])
        (kp,) = b.node("MatMul", [xn, f"dec{i}_sa_k"], [f"d{i}_sak"])
        (vp,) = b.node("MatMul", [xn, f"dec{i}_sa_v"], [f"d{i}_sav"])
        qh, kh, vh = (_heads(qp, f"d{i}_qh"), _heads(kp, f"d{i}_kh"),
                      _heads(vp, f"d{i}_vh"))
        pk, pv = pasts[i]
        if int8_kv:
            sk, sv = kv_scales[i]
            (kh8,) = b.node("QuantizeLinear", [kh, sk, zp8],
                            [f"d{i}_k_q8"], axis=1)
            (vh8,) = b.node("QuantizeLinear", [vh, sv, zp8],
                            [f"d{i}_v_q8"], axis=1)
            (kc8,) = b.node("Where", [is_now4, kh8, pk],
                            [f"present_key_{i}"])
            (vc8,) = b.node("Where", [is_now4, vh8, pv],
                            [f"present_value_{i}"])
            (kc,) = b.node("DequantizeLinear", [kc8, sk, zp8],
                           [f"d{i}_k_dq"], axis=1)
            (vc,) = b.node("DequantizeLinear", [vc8, sv, zp8],
                           [f"d{i}_v_dq"], axis=1)
        else:
            (kc,) = b.node("Where", [is_now4, kh, pk], [f"present_key_{i}"])
            (vc,) = b.node("Where", [is_now4, vh, pv],
                           [f"present_value_{i}"])
        (kt,) = b.node("Transpose", [kc], [f"d{i}_kT"], perm=[0, 1, 3, 2])
        (s,) = b.node("MatMul", [qh, kt], [f"d{i}_scores"])
        (s,) = b.node("Mul", [s, scale], [f"d{i}_scaled"])
        (s,) = b.node("Add", [s, attn_bias4], [f"d{i}_masked"])
        (p,) = b.node("Softmax", [s], [f"d{i}_probs"], axis=-1)
        (c,) = b.node("MatMul", [p, vc], [f"d{i}_ctx"])
        (c,) = b.node("Transpose", [c], [f"d{i}_ctx_t"], perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, shape_merge], [f"d{i}_ctx_m"])
        (o,) = b.node("MatMul", [c, f"dec{i}_sa_o"], [f"d{i}_sao"])
        (x,) = b.node("Add", [x, o], [f"d{i}_res1"])

        # -- cross-attention over the precomputed encoder K/V ---------------
        ck, cv = crosses[i]
        xn = _ln(x, f"d{i}_ln2")
        (qp,) = b.node("MatMul", [xn, f"dec{i}_ca_q"], [f"d{i}_caq"])
        qh = _heads(qp, f"d{i}_cqh")
        (ckt,) = b.node("Transpose", [ck], [f"d{i}_ckT"], perm=[0, 1, 3, 2])
        (s,) = b.node("MatMul", [qh, ckt], [f"d{i}_xscores"])
        (s,) = b.node("Mul", [s, scale], [f"d{i}_xscaled"])
        (p,) = b.node("Softmax", [s], [f"d{i}_xprobs"], axis=-1)
        (c,) = b.node("MatMul", [p, cv], [f"d{i}_xctx"])
        (c,) = b.node("Transpose", [c], [f"d{i}_xctx_t"],
                      perm=[0, 2, 1, 3])
        (c,) = b.node("Reshape", [c, shape_merge], [f"d{i}_xctx_m"])
        (o,) = b.node("MatMul", [c, f"dec{i}_ca_o"], [f"d{i}_cao"])
        (x,) = b.node("Add", [x, o], [f"d{i}_res2"])

        # -- GELU MLP --------------------------------------------------------
        hn = _ln(x, f"d{i}_ln3")
        (m,) = b.node("MatMul", [hn, f"dec{i}_fc"], [f"d{i}_ff1"])
        (m,) = b.node("Gelu", [m], [f"d{i}_gelu"])
        (m,) = b.node("MatMul", [m, f"dec{i}_out"], [f"d{i}_ff2"])
        (x,) = b.node("Add", [x, m], [f"d{i}_res3"])

    x = _ln(x, "dec_norm")
    emb_t = b.init("dec_emb_T", np.ascontiguousarray(w["dec_emb"].T))
    (logits,) = b.node("MatMul", [x, emb_t], ["logits"])
    b.output(logits, [B, T, cfg.vocab_size])
    for i in range(cfg.n_dec_layer):
        b.output(f"present_key_{i}", [B, H, L, hd], dtype=cache_np)
        b.output(f"present_value_{i}", [B, H, L, hd], dtype=cache_np)
    return b.model()
