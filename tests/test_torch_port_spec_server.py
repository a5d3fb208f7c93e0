"""serving.SpeculativeServer through the port on the CPU, against the JAX
package's server and against the target's isolated greedy decode (the
cases of tests/test_spec_server.py, on the port).

- Greedy verification is lossless: with a 1-layer draft (host rounds and
  multi_step=R rounds as one block) and with prompt lookup (ngram=2, host
  rounds and blocks), staggered requests over fewer slots get the
  target's isolated greedy tokens, which are also the JAX server's, at
  JAX's acceptance rate. With the draft equal to the target every
  proposal is accepted.
- eos and stop sequences, streaming, and the refusals (top_k, top_p,
  logit_bias, adapter; temperature with prompt lookup).
- multi_step equals the host rounds; eos mid-block discards the
  overshoot and the freed slot serves the next request exactly; a lane
  parked through a block keeps a finite cache (max_len = the position
  table's 64, so an unclamped window would run past it), and the next
  requests admitted to such lanes are exact.
- Host-round rejection sampling draws from the request's numpy generator
  as JAX does: a sampled request's tokens equal the JAX server's at the
  same seed. Device rejection sampling keeps the seed contract: a sampled
  request gives the same tokens alone and beside other traffic, and the
  first device-sampled token's distribution over seeds tracks plain
  target sampling (the Leviathan identity).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.serve_llm import (
    SpeculativeServer as JSpeculativeServer)
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY
from onnx_rusty_inference_engine_tpu_torch.serving import SpeculativeServer

DRAFT = dataclasses.replace(TINY, n_layer=1)
J_DRAFT = dataclasses.replace(j_gpt2.TINY, n_layer=1)


def _prompts(seed, n, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY.vocab_size, (int(rng.integers(lo, hi)),)
                         ).astype(np.int64) for _ in range(n)]


STAGGERED = list(zip(_prompts(61, 5), [3, 8, 5, 6, 4]))
REPETITIVE = [(np.array([7, 3, 7, 3, 7, 3], np.int64), 6),
              (np.tile(np.array([5, 9, 2], np.int64), 3)[:7], 10)] + \
    list(zip(_prompts(62, 3, 5, 6), [5, 5, 5]))
_ref_cache: dict = {}


def _reference(prompt, n_new, max_len=48):
    """The target's isolated greedy decode (the port's Generator)."""
    key = (prompt.tobytes(), n_new, max_len)
    if key not in _ref_cache:
        gen = Generator(TINY, batch=1, prompt_len=prompt.size,
                        max_len=max_len, device="cpu")
        _ref_cache[key] = [int(t) for t in gen.generate(prompt[None],
                                                        n_new)[0][0]]
    return _ref_cache[key]


def _serve(srv, reqs, **kw):
    """Submit every (prompt, n_new), collect the tokens and the stats,
    stop the server."""
    try:
        futs = [srv.submit(p, n, **kw) for p, n in reqs]
        return [f.result(timeout=300) for f in futs], srv.stats()
    finally:
        srv.stop()


def _port(draft=DRAFT, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("prompt_len", 8)
    kw.setdefault("max_len", 48)
    return SpeculativeServer(TINY, None if kw.get("ngram") else draft,
                             device="cpu", **kw)


# case -> (server kwargs, requests)
JAX_CASES = {
    "draft": (dict(k=4, draft_seed=1), STAGGERED),
    "draft_multi_step": (dict(k=3, draft_seed=1, multi_step=3), STAGGERED),
    "ngram": (dict(k=4, ngram=2), REPETITIVE),
    "ngram_multi_step": (dict(k=4, ngram=2, multi_step=3), REPETITIVE),
}


@pytest.fixture(scope="module")
def jax_served():
    """Each case's JAX server (tokens, acceptance rate), run once."""
    out = {}
    for name, (kw, reqs) in JAX_CASES.items():
        srv = JSpeculativeServer(j_gpt2.TINY,
                                 None if kw.get("ngram") else J_DRAFT,
                                 slots=2, prompt_len=8, max_len=48, **kw)
        toks, st = _serve(srv, reqs)
        out[name] = (toks, st["acceptance_rate"])
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_served_greedy_equals_jax_and_isolated(case, jax_served):
    kw, reqs = JAX_CASES[case]
    srv = _port(**kw)
    if kw.get("ngram"):
        assert srv.d_decode is None          # really no draft engines
    got, st = _serve(srv, reqs)
    assert got == jax_served[case][0]
    assert got == [_reference(p, n) for p, n in reqs]
    assert st["acceptance_rate"] == jax_served[case][1]
    assert st["requests"] == len(reqs)


@pytest.mark.parametrize("multi_step", [0, 2])
def test_draft_is_target_accepts_everything(multi_step):
    p = _prompts(63, 1, 5, 6)[0]
    got, st = _serve(_port(TINY, prompt_len=6, k=4, draft_seed=0,
                           multi_step=multi_step), [(p, 9)])
    assert got == [_reference(p, 9)]
    assert st["acceptance_rate"] == 1.0


def test_eos_and_stop():
    p = _prompts(64, 1, 4, 5)[0]
    ref = _reference(p, 8)
    eos, stop = ref[2], ref[3:5]
    srv = _port(prompt_len=6, k=3)
    try:
        got = srv.submit(p, 8, eos_id=eos).result(timeout=300)
        got_stop = srv.submit(p, 8, stop_sequences=[stop]).result(
            timeout=300)
    finally:
        srv.stop()
    assert got == ref[: ref.index(eos) + 1]
    # the shortest prefix that ends with the stop sequence
    assert got_stop == ref[:next(i for i in range(2, 9)
                                 if ref[i - 2:i] == stop)]


def test_refusals():
    """temperature is served (rejection sampling); top_k / top_p /
    logit_bias / adapter would break the verification identity; prompt
    lookup has no q to rejection-sample against."""
    srv = _port(prompt_len=6)
    ngram = _port(prompt_len=6, ngram=2, multi_step=2)
    try:
        for bad in ({"top_k": 5}, {"top_p": 0.9}, {"logit_bias": {1: -1e9}},
                    {"adapter": 1}):
            with pytest.raises(ValueError, match="DecodeServer"):
                srv.submit(np.array([1, 2, 3]), 4, **bad)
        with pytest.raises(ValueError, match="greedy only"):
            ngram.submit(np.array([1, 2, 3]), 4, temperature=1.0)
    finally:
        srv.stop()
        ngram.stop()


def test_streams_tokens():
    p = _prompts(65, 1, 4, 5)[0]
    srv = _port(prompt_len=6, k=3)
    seen = []
    try:
        got = srv.submit(p, 6, on_token=seen.append).result(timeout=300)
    finally:
        srv.stop()
    assert seen == got == _reference(p, 6)


@pytest.mark.parametrize("ngram", [0, 2])
def test_multi_step_eos_and_slot_reuse(ngram):
    """eos mid-block discards the overshoot; the slot then serves the next
    request exactly, as the host rounds do."""
    kw = dict(slots=1, k=3, ngram=ngram, draft_seed=1)
    p, p5 = _prompts(66, 1, 6, 7)[0], _prompts(67, 1, 5, 6)[0]
    eos = _reference(p, 10)[3]
    want = [_reference(p, 10)[: _reference(p, 10).index(eos) + 1],
            _reference(p5, 6)]
    for ms in (0, 2):
        srv = _port(multi_step=ms, **kw)
        try:
            a = srv.submit(p, 10, eos_id=eos).result(timeout=300)
            b = srv.submit(p5, 6).result(timeout=300)
        finally:
            srv.stop()
        assert [a, b] == want, ms


@pytest.mark.parametrize("ngram", [0, 2])
def test_parked_lane_cache_stays_finite(ngram):
    """max_len = 64, the position table's length: lanes parked at
    max_len - k through a block must not walk the verify window past it.
    After one request with three lanes parked, every cache row is finite,
    and a full batch on the parked lanes is exact."""
    assert TINY.n_positions == 64
    srv = _port(slots=4, max_len=64, k=4, ngram=ngram, draft_seed=1,
                multi_step=3)
    try:
        srv.submit(_prompts(68, 1, 8, 9)[0], 6).result(timeout=300)
        for cache in (srv._t_cache, srv._d_cache):
            assert all(torch.isfinite(v).all() for v in cache.values())
        prompts = _prompts(69, 4, 8, 9)
        got = [f.result(timeout=300)
               for f in [srv.submit(p, 12) for p in prompts]]
    finally:
        srv.stop()
    assert got == [_reference(p, 12, 64) for p in prompts]


def test_host_sampled_rounds_equal_jax():
    """Host rounds: per-request numpy generators, as in JAX; a greedy
    co-slot stays lossless."""
    pg, ps = _prompts(70, 2, 4, 5)
    outs = []
    for srv in (JSpeculativeServer(j_gpt2.TINY, J_DRAFT, slots=2,
                                   prompt_len=6, max_len=48, k=3),
                _port(prompt_len=6, k=3)):
        try:
            fg = srv.submit(pg, 6)
            fs = srv.submit(ps, 6, temperature=1.0, seed=9)
            outs.append((fg.result(timeout=300), fs.result(timeout=300)))
        finally:
            srv.stop()
    assert outs[1] == outs[0]
    assert outs[1][0] == _reference(pg, 6)


def test_device_sampling_keeps_the_seed_contract():
    """multi_step draft rounds: a sampled request's tokens are a function
    of its seed and prompt, whatever else is resident (alone in a 2-slot
    server; in another slot beside a greedy and a sampled request of
    another seed); the greedy co-slot stays lossless."""
    ps, pg, po = _prompts(71, 3, 4, 5)
    alone, _ = _serve(_port(prompt_len=6, k=3, multi_step=2),
                      [(ps, 8)], temperature=1.0, seed=9)
    srv = _port(slots=3, prompt_len=6, k=3, multi_step=2, autostart=False)
    try:
        fg = srv.submit(pg, 8)
        fo = srv.submit(po, 8, temperature=0.7, seed=2)
        fs = srv.submit(ps, 8, temperature=1.0, seed=9)
        srv.start()
        beside = [f.result(timeout=300) for f in (fg, fo, fs)]
    finally:
        srv.stop()
    assert beside[2] == alone[0]
    assert beside[0] == _reference(pg, 8)
    assert len(alone[0]) == 8
    assert all(0 <= t < TINY.vocab_size for t in alone[0])
    # q == p: acceptance probability 1, up to the chunk graph's rounding
    _, st = _serve(_port(TINY, prompt_len=6, k=3, draft_seed=0,
                         multi_step=2), [(ps, 12)], temperature=0.7, seed=3)
    assert st["acceptance_rate"] >= 0.9


def test_device_sampled_distribution():
    """The first token the device rejection sampler draws, over 60 seeds,
    against plain target sampling at the same temperature (the port's
    Generator): the two empirical distributions share most mass."""
    cfg = dataclasses.replace(TINY, vocab_size=32)
    p = np.random.default_rng(72).integers(0, 32, (4,)).astype(np.int64)
    n_seeds = 60
    srv = SpeculativeServer(cfg, dataclasses.replace(cfg, n_layer=1),
                            slots=4, prompt_len=6, max_len=32, k=3,
                            multi_step=2, device="cpu")
    try:
        futs = [srv.submit(p, 2, temperature=1.0, seed=s)
                for s in range(n_seeds)]
        # index 1: the first token of the device sampler (index 0 is the
        # host's, at admission)
        spec_first = [f.result(timeout=600)[1] for f in futs]
    finally:
        srv.stop()
    gen = Generator(cfg, batch=1, prompt_len=4, max_len=32, device="cpu")
    ref_first = [int(gen.generate(p[None], 2, temperature=1.0,
                                  sample_seed=s)[0][0][1])
                 for s in range(n_seeds)]
    cs, cr = collections.Counter(spec_first), collections.Counter(ref_first)
    l1 = sum(abs(cs[t] - cr[t]) for t in set(cs) | set(cr)) / n_seeds
    assert l1 < 0.8, (l1, cs, cr)


def test_spec_server_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeculativeServer(TINY, DRAFT)
