"""Beam search through the port on the CPU (generate.BeamGenerator and
Seq2SeqBeamGenerator), against the JAX package and against references
that use neither the cache tiling nor the beam reorder. The nine cases of
tests/test_beam.py, on the port:

- beam=1 is the greedy Generator (gpt2; t5 against Seq2SeqGenerator);
- the beams equal a cache-free reference (every candidate prefix scored by
  a full forward) and, for t5, a batch-1 replay of every prefix;
- the best beam scores at least greedy's; eos freezes a finished row;
- device_loop=True (every step after the first as one graph; on the CPU
  the same body as a Python loop) equals the host loop, with and without
  eos, with a length penalty, and for t5 with source lengths.

Against the JAX package, at the same seeds and inputs (one JAX run per
case, shared by a module fixture): gpt2 (with and without eos, with the
length penalty), GQA llama, t5 with source lengths and asr give JAX's
tokens, scores within 1e-5 relative, from both loops. With int4 weights
both packages round the int4 kernel's A operand to bf16 (JAX runs its
Pallas kernel in interpret mode, ORIET_KERNELS=pallas, the form the port
implements), and a 1e-7 difference upstream moves an element of A by one
bf16 step now and then: tokens equal JAX's, scores within 1e-3 relative
(the largest relative distance measured is asserted below it and printed),
and the device loop within 1e-5 of the port's host loop.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import generate as jgen
from onnx_rusty_inference_engine_tpu.models import asr as j_asr
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models import llama as j_llama
from onnx_rusty_inference_engine_tpu.models import t5 as j_t5
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import (
    BeamGenerator, Generator, Seq2SeqBeamGenerator, Seq2SeqGenerator)
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import (
    asr, gpt2, llama, seq2seq_family, t5)


N_SAMPLES = 512


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int64)


def _wave(seed, batch):
    t = np.arange(N_SAMPLES) / asr.TINY.sample_rate
    r = np.random.default_rng(seed)
    return np.stack([np.sin(2 * np.pi * r.uniform(100, 600) * t)
                     for _ in range(batch)]).astype(np.float32)


# case -> (family, JAX config, port config, generator kwargs, generate
# kwargs, source); every decoder case at batch 2, prompt 4, max_len 16
GPT2_IDS = _ids(23, (2, 4), gpt2.TINY.vocab_size)
T5_SRC = _ids(24, (2, 8), t5.TINY.vocab_size)
CASES = {
    "gpt2": ("gpt2", j_gpt2.TINY, gpt2.TINY, dict(beam=3), {}, GPT2_IDS),
    "gpt2_eos": ("gpt2", j_gpt2.TINY, gpt2.TINY, dict(beam=3),
                 dict(eos_id=7), GPT2_IDS),
    "gpt2_length_penalty": ("gpt2", j_gpt2.TINY, gpt2.TINY, dict(beam=4),
                            dict(eos_id=3, length_penalty=0.8), GPT2_IDS),
    "llama_gqa": ("llama", j_llama.TINY, llama.TINY, dict(beam=3), {},
                  _ids(25, (2, 4), llama.TINY.vocab_size)),
    "gpt2_int4": ("gpt2", j_gpt2.TINY, gpt2.TINY,
                  dict(beam=3, int4_weights=True), {}, GPT2_IDS),
    "t5": ("t5", j_t5.TINY, t5.TINY, dict(beam=3),
           dict(eos_id=2, src_lengths=np.array([5, 8])), T5_SRC),
    "asr": ("asr", j_asr.TINY, asr.TINY, dict(beam=2), {}, _wave(26, 2)),
}
N_NEW = 6


def _make(package_gen, fam, cfg, gkw, device_loop, **extra):
    kw = dict(batch=2, max_len=16, device_loop=device_loop, **gkw, **extra)
    if fam in ("t5", "asr"):
        src_len = N_SAMPLES if fam == "asr" else 8
        return package_gen.Seq2SeqBeamGenerator(cfg, src_len=src_len,
                                                family=fam, **kw)
    return package_gen.BeamGenerator(cfg, prompt_len=4, family=fam, **kw)


class _Port:
    Seq2SeqBeamGenerator = Seq2SeqBeamGenerator
    BeamGenerator = BeamGenerator


@pytest.fixture(scope="module")
def jax_beams():
    """Each case's JAX host-loop (tokens, scores), computed once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (fam, jcfg, _, gkw, kw, src) in CASES.items():
            if gkw.get("int4_weights"):
                mp.setenv("ORIET_KERNELS", "pallas")
            else:
                mp.delenv("ORIET_KERNELS", raising=False)
            toks, scores = _make(jgen, fam, jcfg, gkw, False).generate(
                src, N_NEW, **kw)
            out[name] = (np.asarray(toks), np.asarray(scores))
    return out


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.abs(np.asarray(b))))


@pytest.mark.parametrize("case", list(CASES))
def test_beams_equal_jax(case, jax_beams):
    fam, _, cfg, gkw, kw, src = CASES[case]
    want_t, want_s = jax_beams[case]
    tol = 1e-3 if gkw.get("int4_weights") else 1e-5
    got = {}
    for dl in (False, True):
        gen = _make(_Port, fam, cfg, gkw, dl, device="cpu")
        got[dl] = gen.generate(src, N_NEW, **kw)
        np.testing.assert_array_equal(got[dl][0], want_t)
        err = _rel(got[dl][1], want_s)
        print(f"{case} device_loop={dl}: scores {err:.2e} from JAX's")
        assert err <= tol, (case, dl, err)
    np.testing.assert_array_equal(got[True][0], got[False][0])
    assert _rel(got[True][1], got[False][1]) <= 1e-5


# -------------------------------------------------------------------------
# tests/test_beam.py's cases on the port
# -------------------------------------------------------------------------
def test_beam_one_is_greedy():
    ids = _ids(1, (2, 4), gpt2.TINY.vocab_size)
    want, _ = Generator(gpt2.TINY, batch=2, prompt_len=4, max_len=16,
                        device="cpu").generate(ids, 6)
    got, _ = BeamGenerator(gpt2.TINY, batch=2, beam=1, prompt_len=4,
                           max_len=16, device="cpu").generate(ids, 6)
    np.testing.assert_array_equal(got, want)


def _next_logprobs(engines, prefix):
    """[V] log-probs of the next token after `prefix`, from a full forward
    at seq_len = len(prefix): no cache involved."""
    L = len(prefix)
    if L not in engines:
        engines[L] = Engine(import_model(gpt2.build_gpt2(
            gpt2.TINY, batch=1, seq_len=L, with_presents=False)),
            device="cpu")
    out = engines[L].run({"input_ids": np.asarray(prefix, np.int64)[None]})
    return torch.log_softmax(torch.from_numpy(
        out.outputs["logits"][0, -1]), -1).numpy()


def _reference_beam(logp, prompt, n_new, K):
    lp = logp(list(prompt))
    top = np.argsort(lp)[::-1][:K]
    beams = [(list(prompt) + [int(t)], float(lp[t])) for t in top]
    for _ in range(1, n_new):
        cands = []
        for seq, sc in beams:
            lp = logp(seq)
            cands.extend((seq + [int(t)], sc + float(lp[t]))
                         for t in np.argsort(lp)[::-1][:K])
        cands.sort(key=lambda x: -x[1])
        beams = cands[:K]
    return beams[0]


def test_beam_matches_cachefree_reference():
    ids = _ids(2, (2, 4), gpt2.TINY.vocab_size)
    K, n_new = 3, 4
    got, scores = BeamGenerator(gpt2.TINY, batch=2, beam=K, prompt_len=4,
                                max_len=16, device="cpu").generate(ids,
                                                                   n_new)
    engines = {}
    for b in range(2):
        seq, score = _reference_beam(lambda p: _next_logprobs(engines, p),
                                     list(ids[b]), n_new, K)
        assert list(got[b]) == seq[4:], (b, list(got[b]), seq)
        np.testing.assert_allclose(scores[b], score, atol=1e-4)


def test_beam_scores_at_least_greedy():
    """The best beam's total log-prob is never worse than greedy's."""
    ids = _ids(3, (1, 4), gpt2.TINY.vocab_size)
    kw = dict(batch=1, prompt_len=4, max_len=16, device="cpu")
    _, s1 = BeamGenerator(gpt2.TINY, beam=1, **kw).generate(ids, 5)
    _, s4 = BeamGenerator(gpt2.TINY, beam=4, **kw).generate(ids, 5)
    assert s4[0] >= s1[0] - 1e-5


def test_beam_eos_freezes():
    """Rows that emit eos keep emitting eos; the output stays n_new long."""
    ids = _ids(4, (1, 4), gpt2.TINY.vocab_size)
    kw = dict(batch=1, beam=2, prompt_len=4, max_len=20, device="cpu")
    probe, _ = BeamGenerator(gpt2.TINY, **kw).generate(ids, 3)
    eos = int(probe[0][1])   # an eos the search actually hits
    for dl in (False, True):
        got, _ = BeamGenerator(gpt2.TINY, device_loop=dl, **kw).generate(
            ids, 8, eos_id=eos)
        assert got.shape == (1, 8)
        row = list(got[0])
        assert eos in row
        i = row.index(eos)
        assert all(t == eos for t in row[i:])


def test_seq2seq_beam_one_is_greedy():
    src = _ids(5, (2, 8), t5.TINY.vocab_size)
    want, _ = Seq2SeqGenerator(t5.TINY, batch=2, src_len=8, max_len=16,
                               device="cpu").generate(src, 6)
    got, _ = Seq2SeqBeamGenerator(t5.TINY, batch=2, beam=1, src_len=8,
                                  max_len=16, device="cpu").generate(src, 6)
    np.testing.assert_array_equal(got, want)


def test_seq2seq_beam_matches_sequential_replay():
    """beam=K against each candidate prefix replayed step by step on a
    batch-1 decode (no K x cross tiling, no cache reorder)."""
    K, n_new, S, ML = 3, 4, 8, 16
    fam = seq2seq_family("t5")
    cfg = t5.TINY
    src = _ids(6, (1, S), cfg.vocab_size)
    enc = Engine(import_model(fam.build_encoder(cfg, batch=1, src_len=S)),
                 device="cpu").run({"src_ids": src,
                                    "src_len": np.array([S])}).outputs
    cross = {k: v for k, v in enc.items() if k.startswith("cross_")}
    dec = Engine(import_model(fam.build_decode(cfg, batch=1, max_len=ML,
                                               src_len=S)), device="cpu")
    L = fam.n_layers(cfg)

    def replay_logp(prefix):
        cache = {f"past_{k}_{i}": np.zeros((1, cfg.n_head, ML,
                                            cfg.head_dim), np.float32)
                 for i in range(L) for k in ("key", "value")}
        for t, tok in enumerate([0] + list(prefix)):
            out = dec.run({"input_ids": np.array([[tok]]),
                           "pos": np.array([t]), "src_len": np.array([S]),
                           **cross, **cache}).outputs
            cache = {f"past_{k}_{i}": out[f"present_{k}_{i}"]
                     for i in range(L) for k in ("key", "value")}
        return torch.log_softmax(torch.from_numpy(out["logits"][0, -1]),
                                 -1).numpy()

    seq, score = _reference_beam(replay_logp, [], n_new, K)
    got, scores = Seq2SeqBeamGenerator(cfg, batch=1, beam=K, src_len=S,
                                       max_len=ML, device="cpu").generate(
        src, n_new)
    assert list(got[0]) == seq
    np.testing.assert_allclose(scores[0], score, atol=1e-4)


def test_device_beam_matches_host_loop():
    ids = _ids(7, (2, 4), gpt2.TINY.vocab_size)
    kw = dict(batch=2, beam=3, prompt_len=4, max_len=16, device="cpu")
    for eos in (None, 7):
        ht, hs = BeamGenerator(gpt2.TINY, **kw).generate(ids, 6, eos_id=eos)
        dt, ds = BeamGenerator(gpt2.TINY, device_loop=True, **kw).generate(
            ids, 6, eos_id=eos)
        np.testing.assert_array_equal(dt, ht)
        np.testing.assert_allclose(ds, hs, rtol=1e-5, atol=1e-5)


def test_device_beam_length_penalty():
    ids = _ids(8, (1, 4), gpt2.TINY.vocab_size)
    kw = dict(batch=1, beam=4, prompt_len=4, max_len=16, device="cpu")
    ht, hs = BeamGenerator(gpt2.TINY, **kw).generate(
        ids, 5, eos_id=3, length_penalty=0.8)
    dt, ds = BeamGenerator(gpt2.TINY, device_loop=True, **kw).generate(
        ids, 5, eos_id=3, length_penalty=0.8)
    np.testing.assert_array_equal(dt, ht)
    np.testing.assert_allclose(ds, hs, rtol=1e-5, atol=1e-5)


def test_device_seq2seq_beam_matches_host_loop():
    src = _ids(9, (2, 8), t5.TINY.vocab_size)
    lens = np.array([5, 8], np.int64)
    kw = dict(batch=2, beam=3, src_len=8, max_len=16, device="cpu")
    host = Seq2SeqBeamGenerator(t5.TINY, **kw)
    dev = Seq2SeqBeamGenerator(t5.TINY, device_loop=True, **kw)
    for eos in (None, 2):
        ht, hs = host.generate(src, 6, eos_id=eos, src_lengths=lens)
        dt, ds = dev.generate(src, 6, eos_id=eos, src_lengths=lens)
        np.testing.assert_array_equal(dt, ht)
        np.testing.assert_allclose(ds, hs, rtol=1e-5, atol=1e-5)


def test_device_loop_reuses_its_state_per_key():
    """The device loop keeps one state (and, on the card, one graph) per
    (n_new, eos_id); a second call with the same key reuses it and gives
    the same beams; another n_new makes another."""
    ids = _ids(10, (2, 4), gpt2.TINY.vocab_size)
    gen = BeamGenerator(gpt2.TINY, batch=2, beam=2, prompt_len=4,
                        max_len=16, device_loop=True, device="cpu")
    a = gen.generate(ids, 5)
    b = gen.generate(ids, 5)
    gen.generate(ids, 4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert sorted(gen.steps._dev) == [(4, None), (5, None)]


def test_beam_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BeamGenerator(gpt2.TINY, beam=2)
