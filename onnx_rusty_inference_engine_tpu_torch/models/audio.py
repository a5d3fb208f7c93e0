"""Whisper-style audio encoder: the port's copy of
onnx_rusty_inference_engine_tpu/models/audio.py.

Raw waveform in, logits out, the log-mel front end inside the graph
(STFT with a Hann window -> power -> MelWeightMatrix -> log; ops/extra.py),
then a GELU conv stem whose second conv subsamples 2x, sinusoidal
positions, a pre-LN transformer encoder and a mean-pooled classification
head. `AudioEncoderConfig()` is whisper-tiny's front end and widths
(n_fft 400, hop 160, 80 mels, d_model 384, 4 layers of 6 heads); a 30 s
clip at 16 kHz (480,000 samples) gives 2,998 frames and 1,499 positions.
`TINY` is the tests' size. The same config, batch, length and seed give
the JAX package's ONNX bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import onnx_io
from ._builder import GraphBuilder
from .vit import _layernorm, _linear


@dataclasses.dataclass
class AudioEncoderConfig:
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    sample_rate: int = 16000
    d_model: int = 384
    n_layer: int = 4
    n_head: int = 6
    num_classes: int = 35     # e.g. speech-commands

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


TINY = AudioEncoderConfig(n_fft=64, hop=32, n_mels=16, sample_rate=1600,
                          d_model=32, n_layer=2, n_head=4, num_classes=10)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper-style sinusoidal position embeddings [length, channels]."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def encoder_trunk(b: GraphBuilder, cfg: AudioEncoderConfig,
                  batch: int, n_samples: int) -> tuple:
    """Shared waveform->hidden-states trunk: in-graph log-mel frontend +
    GELU conv stem + sinusoidal positions + pre-LN transformer encoder.
    Declares the "audio" input; returns (hidden_name [B, S, D], S).
    The classification encoder (build_audio_encoder) and the ASR encoder
    (models/asr.py) share it."""
    B, D, H, hd = batch, cfg.d_model, cfg.n_head, cfg.head_dim
    n_frames = (n_samples - cfg.n_fft) // cfg.hop + 1
    bins = cfg.n_fft // 2 + 1
    S = n_frames // 2  # after the stride-2 conv

    audio = b.input("audio", [B, n_samples])

    # ---- in-graph log-mel frontend ----------------------------------------
    i = np.arange(cfg.n_fft, dtype=np.float32)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * i / cfg.n_fft)).astype(np.float32)
    b.init("hann", hann)
    b.init("frame_step", np.int64(cfg.hop))
    (spec,) = b.node("STFT", [audio, "frame_step", "hann"], ["spec"],
                     onesided=1)                      # [B, F, bins, 2]
    (re,) = b.node("Slice", [spec, b.init("c0", np.array([0], np.int64)),
                             b.init("c1", np.array([1], np.int64)),
                             b.init("cax", np.array([-1], np.int64))],
                   ["spec_re"])
    (im,) = b.node("Slice", [spec, "c1", b.init(
        "c2", np.array([2], np.int64)), "cax"], ["spec_im"])
    (re2,) = b.node("Mul", [re, re], ["re2"])
    (im2,) = b.node("Mul", [im, im], ["im2"])
    (power,) = b.node("Add", [re2, im2], ["power4"])  # [B, F, bins, 1]
    (power,) = b.node("Reshape", [power, b.init(
        "pw_shape", np.array([B, n_frames, bins], np.int64))], ["power"])

    for name, val in (("n_mel_bins", np.int32(cfg.n_mels)),
                      ("dft_len", np.int32(cfg.n_fft)),
                      ("sr", np.int32(cfg.sample_rate)),
                      ("f_lo", np.float32(0.0)),
                      ("f_hi", np.float32(cfg.sample_rate / 2))):
        b.init(name, val)
    (melw,) = b.node("MelWeightMatrix",
                     ["n_mel_bins", "dft_len", "sr", "f_lo", "f_hi"],
                     ["mel_w"])                       # [bins, n_mels]
    (mel,) = b.node("MatMul", [power, melw], ["mel"])  # [B, F, n_mels]
    (mel,) = b.node("Add", [mel, b.init("mel_eps", np.float32(1e-6))],
                    ["mel_eps_add"])
    (logmel,) = b.node("Log", [mel], ["logmel"])

    # ---- GELU conv stem (k=3; second conv subsamples 2x) ------------------
    (lm_t,) = b.node("Transpose", [logmel], ["logmel_cf"], perm=[0, 2, 1])
    c1w = b.he("conv1_w", (D, cfg.n_mels, 3))
    c1b = b.zeros("conv1_b", (D,))
    (h,) = b.node("Conv", [lm_t, c1w, c1b], ["conv1"], kernel_shape=[3],
                  pads=[1, 1])
    (h,) = b.node("Gelu", [h], ["conv1_act"])
    c2w = b.he("conv2_w", (D, D, 3))
    c2b = b.zeros("conv2_b", (D,))
    (h,) = b.node("Conv", [h, c2w, c2b], ["conv2"], kernel_shape=[3],
                  strides=[2], pads=[1, 0])
    (h,) = b.node("Gelu", [h], ["conv2_act"])         # [B, D, S]
    (h,) = b.node("Transpose", [h], ["frames_seq"], perm=[0, 2, 1])

    pos = b.init("pos_emb", _sinusoids(S, D)[None])
    (h,) = b.node("Add", [h, pos], ["h0"])

    # ---- pre-LN transformer encoder (ViT-style blocks) --------------------
    scale = b.init("attn_scale", np.float32(1.0 / np.sqrt(hd)))
    qshape = b.init("shape_bshd", np.array([B, S, H, hd], np.int64))
    mshape = b.init("shape_bsd", np.array([B, S, D], np.int64))
    for li in range(cfg.n_layer):
        ln1 = _layernorm(b, h, f"l{li}_ln1", D)
        q = _linear(b, ln1, f"l{li}_q", D, D)
        k = _linear(b, ln1, f"l{li}_k", D, D)
        v = _linear(b, ln1, f"l{li}_v", D, D)

        def _heads(t, tag):
            (r,) = b.node("Reshape", [t, qshape], [f"l{li}_{tag}_r"])
            (tr,) = b.node("Transpose", [r], [f"l{li}_{tag}_t"],
                           perm=[0, 2, 1, 3])
            return tr

        qh, kh, vh = _heads(q, "q"), _heads(k, "k"), _heads(v, "v")
        (kt,) = b.node("Transpose", [kh], [f"l{li}_kT"], perm=[0, 1, 3, 2])
        (att,) = b.node("MatMul", [qh, kt], [f"l{li}_scores"])
        (att,) = b.node("Mul", [att, scale], [f"l{li}_scaled"])
        (att,) = b.node("Softmax", [att], [f"l{li}_probs"], axis=-1)
        (ctxt,) = b.node("MatMul", [att, vh], [f"l{li}_ctx"])
        (ctxt,) = b.node("Transpose", [ctxt], [f"l{li}_ctx_t"],
                         perm=[0, 2, 1, 3])
        (ctxt,) = b.node("Reshape", [ctxt, mshape], [f"l{li}_ctx_m"])
        proj = _linear(b, ctxt, f"l{li}_proj", D, D)
        (h,) = b.node("Add", [h, proj], [f"l{li}_res1"])
        ln2 = _layernorm(b, h, f"l{li}_ln2", D)
        m = _linear(b, ln2, f"l{li}_fc", D, 4 * D)
        (m,) = b.node("Gelu", [m], [f"l{li}_gelu"])
        m = _linear(b, m, f"l{li}_out", 4 * D, D)
        (h,) = b.node("Add", [h, m], [f"l{li}_res2"])

    h = _layernorm(b, h, "ln_f", D)
    return h, S


def build_audio_encoder(
    cfg: AudioEncoderConfig = TINY,
    *,
    batch: int = 1,
    n_samples: int = 1024,
    opset: int = 17,
    seed: int = 0,
) -> onnx_io.ModelProto:
    """audio [B, n_samples] f32 -> logits [B, num_classes]."""
    b = GraphBuilder("audio_encoder", opset=opset, seed=seed)
    B, D = batch, cfg.d_model
    h, _ = encoder_trunk(b, cfg, batch, n_samples)
    (pooled,) = b.node("ReduceMean", [h], ["pooled"], axes=[1], keepdims=0)
    logits = _linear(b, pooled, "head", D, cfg.num_classes)
    b.node("Identity", [logits], ["logits"])
    b.output("logits", [B, cfg.num_classes])
    return b.model()
