"""serving.Seq2SeqServer through the port on the CPU, against the JAX
package's server and the isolated Seq2SeqGenerator, and both new servers
behind http_serve's /v1/generate.

- t5 (token sources of 2-8 tokens, padded to src_len 8, their true
  lengths fed to the decode graph) and asr (waveforms of 256-512 samples)
  over 2 slots: served greedy tokens equal the JAX server's and an
  isolated batch-1 Seq2SeqGenerator's on the padded source; with
  multi_step=4 (four steps, selection included, as one block through the
  device sampler) too.
- encoder_cache=2: a repeated source skips the encoder, counted in
  stats()["encoder_cache_hits"] as in JAX, with the same tokens.
- A sampled request's tokens from the K-step blocks do not depend on K
  (the device sampler keys on the seed and the cache position).
- POST /v1/generate on a Seq2SeqServer (a token source under "src") and a
  SpeculativeServer (lossless: the target's greedy tokens; a refused knob
  answers 400 naming DecodeServer); /v1/stats carries their counters.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.models import asr as j_asr
from onnx_rusty_inference_engine_tpu.models import t5 as j_t5
from onnx_rusty_inference_engine_tpu.serve_llm import (
    Seq2SeqServer as JSeq2SeqServer)
from onnx_rusty_inference_engine_tpu_torch.generate import (
    Generator, Seq2SeqGenerator)
from onnx_rusty_inference_engine_tpu_torch.http_serve import (
    serve_generate_http)
from onnx_rusty_inference_engine_tpu_torch.models import asr, gpt2, t5
from onnx_rusty_inference_engine_tpu_torch.serving import (
    Seq2SeqServer, SpeculativeServer)

N_SAMPLES = 512


def _tokens(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, t5.TINY.vocab_size, (int(rng.integers(2, 9)),)
                         ).astype(np.int64) for _ in range(n)]


def _waves(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(N_SAMPLES // 2, N_SAMPLES + 1))
        t = np.arange(m) / asr.TINY.sample_rate
        out.append(np.sin(2 * np.pi * rng.uniform(100, 600) * t).astype(
            np.float32))
    return out


# family -> (JAX config, port config, src_len, sources, new tokens)
FAMILIES = {"t5": (j_t5.TINY, t5.TINY, 8, _tokens(81, 4), 5),
            "asr": (j_asr.TINY, asr.TINY, N_SAMPLES, _waves(82, 4), 6)}


def _serve(srv, srcs, n_new, **kw):
    try:
        futs = [srv.submit(s, n_new, **kw) for s in srcs]
        return [f.result(timeout=300) for f in futs], srv.stats()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_served():
    """Each family's JAX server tokens, run once."""
    out = {}
    for fam, (jcfg, _, S, srcs, n_new) in FAMILIES.items():
        out[fam] = _serve(JSeq2SeqServer(jcfg, slots=2, src_len=S,
                                         max_len=16, family=fam),
                          srcs, n_new)[0]
    return out


def _isolated(fam, cfg, S, srcs, n_new):
    gen = Seq2SeqGenerator(cfg, batch=1, src_len=S, max_len=16, family=fam,
                           device="cpu")
    want = []
    for src in srcs:
        padded = np.zeros((1, S), src.dtype)
        padded[0, :src.size] = src
        kw = ({"src_lengths": np.array([src.size])} if fam == "t5"
              else {})
        want.append([int(t) for t in gen.generate(padded, n_new,
                                                  **kw)[0][0]])
    return want


@pytest.mark.parametrize("multi_step", [0, 4])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_served_equals_jax_and_isolated(fam, multi_step, jax_served):
    _, cfg, S, srcs, n_new = FAMILIES[fam]
    got, st = _serve(Seq2SeqServer(cfg, slots=2, src_len=S, max_len=16,
                                   family=fam, multi_step=multi_step,
                                   device="cpu"), srcs, n_new)
    assert got == jax_served[fam]
    assert got == _isolated(fam, cfg, S, srcs, n_new)
    assert st["requests"] == len(srcs) and st["decode_steps"] > 0


@pytest.mark.parametrize("multi_step", [0, 4])
def test_encoder_cache_hit(multi_step):
    srcs = _tokens(83, 3)
    srcs = srcs + [srcs[1]]          # repeated while still in the LRU
    jgot, jst = _serve(JSeq2SeqServer(j_t5.TINY, slots=2, src_len=8,
                                      max_len=16, encoder_cache=2),
                       srcs, 5)
    got, st = _serve(Seq2SeqServer(t5.TINY, slots=2, src_len=8, max_len=16,
                                   encoder_cache=2, multi_step=multi_step,
                                   device="cpu"), srcs, 5)
    assert st["encoder_cache_hits"] == jst["encoder_cache_hits"] == 1
    assert got == jgot
    assert got[3] == got[1]


def test_sampled_blocks_do_not_depend_on_k():
    srcs = _tokens(84, 2)
    outs = []
    for K in (2, 4):
        outs.append(_serve(Seq2SeqServer(t5.TINY, slots=2, src_len=8,
                                         max_len=16, multi_step=K,
                                         device="cpu"), srcs, 8,
                           temperature=0.9, seed=5)[0])
    assert outs[0] == outs[1]
    assert all(0 <= t < t5.TINY.vocab_size for t in outs[0][0])


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                timeout=60) as r:
        return json.loads(r.read())


def test_http_generate_seq2seq_server():
    srv = Seq2SeqServer(t5.TINY, slots=2, src_len=8, max_len=16,
                        device="cpu")
    httpd = serve_generate_http(srv, port=0, block=False)
    port = httpd.server_address[1]
    try:
        status, out = _post(port, {"src": [3, 5, 7], "max_new_tokens": 4})
        assert status == 200
        assert out["generated_ids"] == _isolated(
            "t5", t5.TINY, 8, [np.array([3, 5, 7])], 4)[0]
        assert _stats(port)["requests"] == 1
    finally:
        httpd.shutdown()
        srv.stop()


def test_http_generate_speculative_server():
    import dataclasses

    srv = SpeculativeServer(gpt2.TINY,
                            dataclasses.replace(gpt2.TINY, n_layer=1),
                            slots=2, prompt_len=6, max_len=32, k=3,
                            device="cpu")
    httpd = serve_generate_http(srv, port=0, block=False)
    port = httpd.server_address[1]
    try:
        prompt = [3, 1, 4, 1]
        status, out = _post(port, {"prompt_ids": prompt,
                                   "max_new_tokens": 4})
        assert status == 200
        want, _ = Generator(gpt2.TINY, batch=1, prompt_len=4, max_len=32,
                            device="cpu").generate(
            np.asarray([prompt], np.int64), 4)
        assert out["generated_ids"] == [int(t) for t in want[0]]
        status, err = _post(port, {"prompt_ids": prompt,
                                   "max_new_tokens": 4, "top_k": 5})
        assert status == 400 and "DecodeServer" in err["error"]
        assert "acceptance_rate" in _stats(port)
    finally:
        httpd.shutdown()
        srv.stop()


def test_seq2seq_server_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Seq2SeqServer(t5.TINY)
