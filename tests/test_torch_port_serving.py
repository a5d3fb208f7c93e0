"""The port's serving stack (onnx_rusty_inference_engine_tpu_torch.serve,
.serve_llm, .serving) held against the JAX package's on the CPU.

- DecodeServer: the same seeded TINY GPT-2 and the same requests through
  the JAX server and the port's give the same greedy tokens in every mode
  (staggered admission, INT8 KV, slot reuse, prompt buckets, eos, stop
  sequences, concurrent clients, multi_step, chunked prefill, len_buckets,
  prompt_cache), and the same host-sampled tokens (the host sampler is
  numpy, seeded per request, on both sides).
- The multi_step device sampler draws other random numbers than JAX's
  PRNG, so it is held within the port: a request's stream is the same for
  any K and any co-resident requests, and where sampling collapses to a
  deterministic choice it equals the host sampler and JAX.
- InferenceServer: results equal the Engine on the same padded bucket,
  and the JAX InferenceServer's within test_torch_port_squeezenet.py's
  INT8 tolerance.
- Lifecycle (cancel, stop, drain), the two repaired faults of the
  reference (futures resolved under one lock; the watchdog exempting every
  step that runs a new graph), and the options not ported yet.
"""

import os
import subprocess
import sys
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as J_TINY
from onnx_rusty_inference_engine_tpu.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu.quant import (
    calibrate as j_calibrate, quantize_graph as j_quantize)
from onnx_rusty_inference_engine_tpu.serve import (
    InferenceServer as JInferenceServer)
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_graph as t_quantize)
from onnx_rusty_inference_engine_tpu_torch.serve import InferenceServer
from onnx_rusty_inference_engine_tpu_torch.serve_llm import (
    DecodeServer, _Request, _device_select)
from onnx_rusty_inference_engine_tpu_torch.serving.request import _uniform
from torch_port_util import to_port
from util import make_model, node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = TINY.vocab_size


def _prompt(rng, n):
    return rng.integers(0, V, (n,)).astype(np.int64)


def _serve(port: bool, server_kw: dict, reqs, sequential=False):
    """Run `reqs` [(prompt, n_new, submit kwargs)] through one server:
    (token lists, stats)."""
    if port:
        srv = DecodeServer(TINY, device="cpu", **server_kw)
    else:
        srv = JDecodeServer(J_TINY, **server_kw)
    try:
        if sequential:
            outs = [srv.submit(p, n, **kw).result(timeout=300)
                    for p, n, kw in reqs]
        else:
            futs = [srv.submit(p, n, **kw) for p, n, kw in reqs]
            outs = [f.result(timeout=300) for f in futs]
        stats = srv.stats()
    finally:
        srv.stop()
    return [[int(t) for t in o] for o in outs], stats


def _both(server_kw, reqs, sequential=False):
    j = _serve(False, server_kw, reqs, sequential)
    t = _serve(True, server_kw, reqs, sequential)
    return j, t


def _staggered(seed, n, plen, n_new):
    rng = np.random.default_rng(seed)
    return [(_prompt(rng, int(rng.integers(*plen))),
             int(rng.integers(*n_new)), {}) for _ in range(n)]


# --------------------------------------------------------------------------
# DecodeServer: greedy tokens equal JAX's
# --------------------------------------------------------------------------
# name -> (server kwargs, requests)
GREEDY_CASES = {
    "staggered_fp32": (dict(slots=4, prompt_len=8, max_len=24),
                       _staggered(53, 6, (2, 9), (2, 7))),
    "int8_kv": (dict(slots=2, prompt_len=8, max_len=24, kv_dtype="int8"),
                _staggered(54, 3, (2, 9), (4, 8))),
    "slot_reuse": (dict(slots=2, prompt_len=4, max_len=16),
                   _staggered(55, 5, (3, 4), (4, 5))),
    "prompt_buckets": (dict(slots=2, prompt_len=8, max_len=24,
                            prompt_buckets=(2, 4, 8)),
                       [(_prompt(np.random.default_rng(56 + n), n), 3, {})
                        for n in (2, 3, 5, 8)]),
    "multi_step3": (dict(slots=3, prompt_len=8, max_len=24, multi_step=3),
                    _staggered(57, 5, (2, 9), (2, 8))),
    "multi_step4_int8": (dict(slots=2, prompt_len=4, max_len=24,
                              kv_dtype="int8", multi_step=4),
                         _staggered(58, 3, (2, 5), (6, 11))),
    "chunked_fp32": (dict(slots=3, max_len=40, chunked_prefill=True,
                          chunk=4), _staggered(59, 6, (2, 20), (2, 8))),
    "chunked_int8": (dict(slots=2, max_len=32, chunked_prefill=True,
                          chunk=4, kv_dtype="int8"),
                     [(_prompt(np.random.default_rng(60), n), 6, {})
                      for n in (6, 11)]),
    # n_new > K: the reference fails a block in which a request both ends
    # its prompt and finishes (test_chunked_multi_finish_in_prefill_block
    # below holds the port there)
    "chunked_multi3": (dict(slots=3, max_len=48, chunked_prefill=True,
                            chunk=4, multi_step=3),
                       _staggered(61, 6, (2, 20), (4, 9))),
    "chunked_int8_multi2": (dict(slots=2, max_len=32, chunked_prefill=True,
                                 chunk=4, kv_dtype="int8", multi_step=2),
                            _staggered(62, 4, (3, 12), (3, 8))),
    "len_buckets_multi2_int8": (dict(slots=2, prompt_len=8, max_len=48,
                                     kv_dtype="int8", multi_step=2,
                                     len_buckets=(16, 48)),
                                _staggered(63, 4, (3, 9), (4, 30))),
    "len_buckets_chunked_multi2": (dict(slots=2, max_len=48,
                                        chunked_prefill=True, chunk=4,
                                        multi_step=2, len_buckets=(16, 48)),
                                   _staggered(64, 4, (3, 10), (4, 28))),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_decode_server_greedy_equals_jax(case):
    server_kw, reqs = GREEDY_CASES[case]
    (jo, _), (to, _) = _both(server_kw, reqs)
    assert to == jo
    assert [len(o) for o in to] == [n for _, n, _ in reqs]


# name -> (server kwargs, requests run one after another)
SEQUENTIAL_CASES = {
    "len_buckets_grow_shrink": (
        dict(slots=2, prompt_len=8, max_len=48, len_buckets=(16, 48)),
        [(p, n, {}) for p, n in zip(
            [_prompt(np.random.default_rng(70 + i), k)
             for i, k in enumerate((5, 6, 4, 4))], (6, 30, 5, 4))]),
    "len_buckets_chunked_int8": (
        dict(slots=2, max_len=48, kv_dtype="int8", chunked_prefill=True,
             chunk=4, len_buckets=(16, 48)),
        [(_prompt(np.random.default_rng(74 + i), k), 6, {})
         for i, k in enumerate((5, 9, 4))]),
}


def _prompt_cache_reqs(seed, n, n_new):
    p = _prompt(np.random.default_rng(seed), n)
    q = _prompt(np.random.default_rng(seed + 1), n)
    return [(p, n_new, {}), (p, n_new, {}), (q, n_new, {}), (p, n_new, {})]


def _shared_prefix_reqs(seed):
    rng = np.random.default_rng(seed)
    sys_prefix, a = _prompt(rng, 10), _prompt(rng, 3)
    p1 = np.concatenate([sys_prefix, a])
    p2 = np.concatenate([sys_prefix, (a + 1) % V])
    return [(p1, 5, {}), (p2, 5, {}), (p1, 4, {})]


SEQUENTIAL_CASES.update({
    "prompt_cache_exact": (dict(slots=2, prompt_len=8, max_len=24,
                                prompt_cache=8), _prompt_cache_reqs(80, 6, 5)),
    "prompt_cache_exact_int8": (dict(slots=2, prompt_len=8, max_len=24,
                                     kv_dtype="int8", prompt_cache=4),
                                _prompt_cache_reqs(82, 7, 6)),
    "prompt_cache_lru_1": (dict(slots=2, prompt_len=8, max_len=24,
                                prompt_cache=1), _prompt_cache_reqs(84, 5, 3)),
    "prompt_cache_multi2": (dict(slots=2, prompt_len=8, max_len=24,
                                 prompt_cache=4, multi_step=2),
                            _prompt_cache_reqs(86, 6, 5)),
    "prompt_cache_chunked_prefix": (dict(slots=2, max_len=32,
                                         chunked_prefill=True, chunk=4,
                                         prompt_cache=4),
                                    _shared_prefix_reqs(88)),
    "prompt_cache_chunked_multi2": (dict(slots=2, max_len=32,
                                         chunked_prefill=True, chunk=4,
                                         prompt_cache=4, multi_step=2),
                                    _shared_prefix_reqs(89)),
})

_STATS = ("requests", "tokens_out", "decode_steps", "prefix_hits",
          "prefix_tokens_saved", "cache_len", "cache_resizes")


@pytest.mark.parametrize("case", list(SEQUENTIAL_CASES))
def test_decode_server_sequential_equals_jax(case):
    """Requests one after another (so admission and the cache-length and
    prompt-cache decisions are deterministic): the same tokens and the
    same counters as the JAX server."""
    server_kw, reqs = SEQUENTIAL_CASES[case]
    (jo, js), (to, ts) = _both(server_kw, reqs, sequential=True)
    assert to == jo
    assert {k: ts[k] for k in _STATS if k in ts} == \
        {k: js[k] for k in _STATS if k in js}
    if "prompt_cache" in server_kw:
        assert ts["prefix_hits"] >= 1


@pytest.mark.parametrize("kind", ["eos", "stop_sequence", "multi_step4_eos",
                                  "chunked_multi2_eos"])
def test_decode_server_stop_conditions_equal_jax(kind):
    """eos and stop sequences end a request where JAX's ends it, also
    mid-block (multi_step)."""
    rng = np.random.default_rng(90)
    p = _prompt(rng, 5)
    server_kw = {"eos": dict(slots=1, prompt_len=8, max_len=24),
                 "stop_sequence": dict(slots=2, prompt_len=8, max_len=24),
                 "multi_step4_eos": dict(slots=2, prompt_len=8, max_len=24,
                                         kv_dtype="int8", multi_step=4),
                 "chunked_multi2_eos": dict(slots=2, max_len=32,
                                            chunked_prefill=True, chunk=4,
                                            multi_step=2)}[kind]
    (ref,), _ = _serve(False, server_kw, [(p, 10, {})])
    kw = ({"stop_sequences": [ref[:3]]} if kind == "stop_sequence"
          else {"eos_id": ref[4 if "multi" in kind else 2]})
    other = _prompt(rng, 4)
    reqs = [(p, 10, kw), (other, 6, kw)]
    (jo, _), (to, _) = _both(server_kw, reqs)
    assert to == jo
    assert len(to[0]) < 10


def test_decode_server_concurrent_clients_equal_jax():
    """Twelve client threads at once: every request gets JAX's tokens."""
    rng = np.random.default_rng(91)
    prompts = [_prompt(rng, int(rng.integers(2, 7))) for _ in range(12)]
    outs = {}
    for port in (False, True):
        srv = (DecodeServer(TINY, slots=4, prompt_len=6, max_len=20,
                            device="cpu") if port else
               JDecodeServer(J_TINY, slots=4, prompt_len=6, max_len=20))
        res = [None] * len(prompts)

        def client(i):
            res[i] = [int(t) for t in srv.generate(prompts[i], 4,
                                                   timeout=300)]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            srv.stop()
        assert not any(t.is_alive() for t in threads)
        outs[port] = res
        assert srv.stats()["requests"] == len(prompts)
    assert outs[True] == outs[False]


# --------------------------------------------------------------------------
# host-sampled single-step requests: numpy on both sides, token for token
# --------------------------------------------------------------------------
HOST_SAMPLING = {
    "temperature": dict(temperature=1.0, seed=7),
    "top_k": dict(temperature=0.8, top_k=20, seed=3),
    "top_k_oversized": dict(temperature=1.0, top_k=10 ** 6, seed=1),
    "top_p": dict(temperature=2.0, top_p=0.9, seed=5),
    "top_p_zero": dict(temperature=1.3, top_p=0.0, seed=2),
    "min_p": dict(temperature=1.0, min_p=0.05, seed=6),
    "logit_bias": dict(temperature=1.0, seed=3, logit_bias={0: -1e9,
                                                            7: 2.0}),
    "logit_bias_greedy": dict(logit_bias={7: 1e9}),
    "penalties_greedy": dict(frequency_penalty=1.5, presence_penalty=2.0),
    "penalties_sampled": dict(temperature=1.2, frequency_penalty=0.5,
                              presence_penalty=0.3, seed=9),
}


@pytest.mark.parametrize("case", list(HOST_SAMPLING))
def test_host_sampled_requests_equal_jax(case):
    """One sampled request beside a greedy one, in a single-step server:
    both equal JAX's, token for token."""
    rng = np.random.default_rng(92)
    reqs = [(_prompt(rng, 5), 8, HOST_SAMPLING[case]), (_prompt(rng, 6), 8,
                                                         {})]
    (jo, _), (to, _) = _both(dict(slots=2, prompt_len=8, max_len=24), reqs)
    assert to == jo


def test_chunked_multi_finish_in_prefill_block():
    """A request that consumes the end of its prompt and reaches max_new in
    the same K-step block. The reference's bookkeeping slices the cleared
    slot's pending prompt (None) there and fails the whole block
    (onnx_rusty_inference_engine_tpu/serving/decode_multi.py:198); the
    port finishes it, with the tokens of JAX's single-step chunked
    server."""
    reqs = _staggered(65, 5, (2, 14), (1, 3))
    chunked = dict(slots=3, max_len=40, chunked_prefill=True, chunk=4)
    (want, _), = [_serve(False, chunked, reqs)]
    got, _ = _serve(True, dict(chunked, multi_step=3), reqs)
    assert got == want


def test_chunked_host_sampling_equals_jax():
    rng = np.random.default_rng(93)
    reqs = [(_prompt(rng, 9), 6, dict(temperature=1.0, seed=4)),
            (_prompt(rng, 3), 6, dict(temperature=0.7, top_k=5, seed=8))]
    (jo, _), (to, _) = _both(dict(slots=2, max_len=32, chunked_prefill=True,
                                  chunk=4), reqs)
    assert to == jo


# --------------------------------------------------------------------------
# the multi_step device sampler, held within the port
# --------------------------------------------------------------------------
def _port(server_kw, reqs, sequential=True):
    return _serve(True, server_kw, reqs, sequential)[0]


@pytest.mark.parametrize("chunked", [False, True])
def test_device_sampler_stream_is_the_same_for_any_k(chunked):
    """Draws are keyed on (seed, cache position): the same stream for
    K = 1, 2, 4."""
    p = _prompt(np.random.default_rng(94), 5)
    kw = dict(temperature=0.9, top_p=0.9, seed=11)
    base = (dict(slots=2, max_len=32, chunked_prefill=True, chunk=4)
            if chunked else dict(slots=2, prompt_len=8, max_len=32))
    streams = [_port(dict(base, multi_step=K), [(p, 8, kw)])[0]
               for K in (1, 2, 4)]
    assert streams[0] == streams[1] == streams[2]
    assert len(streams[0]) == 8 and max(streams[0]) < V


def test_device_sampler_stream_ignores_co_resident_requests():
    rng = np.random.default_rng(95)
    p = _prompt(rng, 5)
    kw = dict(temperature=1.1, top_k=20, seed=5)
    srv = DecodeServer(TINY, slots=2, prompt_len=8, max_len=32,
                       multi_step=2, device="cpu")
    try:
        alone = srv.submit(p, 8, **kw).result(timeout=300)
        busy = srv.submit(_prompt(rng, 7), 8, temperature=2.0, seed=99)
        again = srv.submit(p, 8, **kw).result(timeout=300)
        busy.result(timeout=300)
    finally:
        srv.stop()
    assert alone == again


@pytest.mark.parametrize("kw", [
    dict(temperature=1.7, top_k=1, seed=3),
    dict(logit_bias={7: 1000.0}),
    dict(frequency_penalty=1.5, presence_penalty=2.0),
    dict(temperature=1.3, top_p=0.0),
    dict(temperature=1.3, min_p=1.0, seed=4),
], ids=["top_k1", "logit_bias", "penalties", "top_p0", "min_p1"])
def test_device_sampler_deterministic_choices_equal_host_and_jax(kw):
    """Where a request's choice is deterministic, the device block gives
    the host sampler's tokens, and JAX's."""
    p = _prompt(np.random.default_rng(96), 5)
    cfg = dict(slots=2, prompt_len=8, max_len=32)
    dev = _port(dict(cfg, multi_step=2), [(p, 10, kw)])
    host = _port(cfg, [(p, 10, kw)])
    (jax_host,), _ = _serve(False, cfg, [(p, 10, kw)])
    assert dev == host == [jax_host]


def test_device_select_neutral_rows_are_argmax_and_filters_hold():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((4, 64), generator=g) * 3
    B = logits.shape[0]
    seeds = torch.arange(B, dtype=torch.int64) * 977 + (1 << 40)
    pos = torch.tensor([0, 5, 17, 63])
    ones, zeros = torch.ones(B), torch.zeros(B)
    full = torch.full((B,), 64, dtype=torch.int64)
    greedy = _device_select(logits, seeds, pos, zeros, full, ones, zeros)
    assert torch.equal(greedy, logits.argmax(-1))
    top1 = _device_select(logits, seeds, pos, ones * 2, torch.ones_like(full),
                          ones, zeros)
    assert torch.equal(top1, logits.argmax(-1))
    for s in range(20):
        tok = _device_select(logits, seeds + s, pos, ones, full * 0 + 5,
                             ones, zeros)
        top5 = logits.topk(5, dim=-1).indices
        assert (tok[:, None] == top5).any(-1).all()


def test_uniform_stream_is_keyed_and_unbiased():
    """The counter-based uniforms: in (0, 1), a function of (seed,
    position, index) only, and their categorical draws follow the
    distribution (Gumbel-max over 4,000 keys, within 4 sigma)."""
    seeds = torch.tensor([1, 2, 1], dtype=torch.int64)
    pos = torch.tensor([3, 3, 4])
    u = _uniform(seeds, pos, 1000)
    assert u.dtype == torch.float32 and u.min() > 0 and u.max() < 1
    assert torch.equal(u, _uniform(seeds, pos, 1000))
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert abs(float(u.mean()) - 0.5) < 0.02
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    n = 4000
    draws = _device_select(
        probs.log().expand(n, 4).contiguous(),
        torch.arange(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64),
        torch.ones(n), torch.full((n,), 4, dtype=torch.int64), torch.ones(n),
        torch.zeros(n))
    freq = torch.bincount(draws, minlength=4).double() / n
    sigma = (probs.double() * (1 - probs.double()) / n).sqrt()
    assert ((freq - probs.double()).abs() <= 4 * sigma).all(), freq


# --------------------------------------------------------------------------
# InferenceServer on SqueezeNet 1.0 INT8
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def squeezenet_int8():
    m = build_squeezenet()
    jg, tg = j_import(m), to_port(m)
    x = np.random.default_rng(1).standard_normal((2, 3, 224, 224)).astype(
        np.float32)
    ranges = j_calibrate(jg, [{"data_0": x}])
    jq, tq = j_quantize(jg, ranges=ranges), t_quantize(tg, ranges=ranges)
    images = np.random.default_rng(2).standard_normal(
        (5, 1, 3, 224, 224)).astype(np.float32)
    return jq, tq, images


def _inference(server, images):
    try:
        futs = [server.submit(x) for x in images]
        outs = [f.result(timeout=300)["softmaxout_1"] for f in futs]
        summary = server.stats.summary()
    finally:
        server.stop()
    return outs, summary


def test_inference_server_equals_engine_on_its_bucket(squeezenet_int8):
    """Requests of 1 and 2 images packed into buckets (1, 2, 4): each
    result is the Engine's on the same padded bucket batch, bit for
    bit."""
    _, tq, images = squeezenet_int8
    eng = Engine(tq, device="cpu")
    reqs = [images[0], images[1:3, 0], images[3]]
    srv = InferenceServer(eng, batch_buckets=(1, 2, 4), max_delay_s=0.5,
                          autostart=False)
    futs = [srv.submit(x) for x in reqs]
    srv.start()
    try:
        outs = [f.result(timeout=300)["softmaxout_1"] for f in futs]
    finally:
        srv.stop()
    assert srv.stats.summary()["batches"] == 1      # 1 + 2 + 1 = bucket 4
    batch = np.concatenate([images[0], images[1:3, 0], images[3]])
    want = eng.run({"data_0": batch})["softmaxout_1"]
    np.testing.assert_array_equal(np.concatenate(outs), want)


def test_inference_server_matches_jax(squeezenet_int8):
    """The same requests through both packages' servers: softmax within
    1e-3 and the same top-1 (test_torch_port_squeezenet.py's INT8
    tolerance)."""
    jq, tq, images = squeezenet_int8
    kw = dict(batch_buckets=(1, 2), max_delay_s=0.05)
    got, t_sum = _inference(InferenceServer(Engine(tq, device="cpu"), **kw),
                            images[:3])
    want, _ = _inference(JInferenceServer(JEngine(jq), **kw), images[:3])
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 1000, 1, 1)
        assert np.abs(g - np.asarray(w)).max() <= 1e-3
        assert g.reshape(-1).argmax() == np.asarray(w).reshape(-1).argmax()
    assert t_sum["requests"] == 3


def test_inference_server_warmup_runs_every_bucket(squeezenet_int8):
    _, tq, _ = squeezenet_int8
    eng = Engine(tq, device="cpu")
    seen = []
    orig = eng.__class__.__call__

    class Counting(Engine):
        def __call__(self, inputs):
            seen.append(next(iter(inputs.values())).shape[0])
            return orig(self, inputs)

    eng.__class__ = Counting
    srv = InferenceServer(eng, batch_buckets=(1, 2), warmup=True,
                          example_shape=(3, 224, 224), autostart=False)
    srv.stop()
    assert seen == [1, 2]


def test_padding_overhead_counts_rows():
    """Three requests of 3 examples each, packed into one 16-row bucket:
    9 rows are real and 7 padding, so padding_overhead is 7/16 (rows
    against rows; the JAX package's ServerStats counts the 3 requests
    against the 16 rows), and `requests` stays 3."""
    x = np.zeros((1, 4), np.float32)
    model = make_model([node("Relu", ["x"], ["y"])], {"x": x}, ["y"])
    srv = InferenceServer(Engine(to_port(model), device="cpu"),
                          batch_buckets=(16,), max_delay_s=0.5,
                          autostart=False)
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((3, 4)).astype(np.float32)
            for _ in range(3)]
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    try:
        outs = [f.result(timeout=60)["y"] for f in futs]
    finally:
        srv.stop()
    summary = srv.stats.summary()
    assert summary["requests"] == 3 and summary["batches"] == 1
    assert summary["padding_overhead"] == 7 / 16
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, np.maximum(r, 0))


# --------------------------------------------------------------------------
# lifecycle (port twins of tests/test_server_lifecycle.py)
# --------------------------------------------------------------------------
def _srv(**kw):
    return DecodeServer(TINY, device="cpu", **kw)


def test_cancel_in_flight_request():
    rng = np.random.default_rng(41)
    srv = _srv(slots=2, prompt_len=4, max_len=128)
    try:
        fut = srv.submit(_prompt(rng, 4), 100)
        assert srv.cancel(fut)
        with pytest.raises(CancelledError):
            fut.result(timeout=300)
        out = srv.submit(_prompt(rng, 4), 3).result(timeout=300)
        assert len(out) == 3
    finally:
        srv.stop()
    assert not srv.cancel(fut)


def test_cancel_queued_request():
    rng = np.random.default_rng(42)
    srv = _srv(slots=1, prompt_len=4, max_len=64)
    try:
        f1 = srv.submit(_prompt(rng, 4), 40)
        f2 = srv.submit(_prompt(rng, 4), 5)
        assert srv.cancel(f2)
        with pytest.raises(CancelledError):
            f2.result(timeout=300)
        assert f1.result(timeout=300)
    finally:
        srv.stop()


def test_stop_fails_outstanding_futures():
    rng = np.random.default_rng(43)
    srv = _srv(slots=1, prompt_len=4, max_len=128)
    f1 = srv.submit(_prompt(rng, 4), 120)
    f2 = srv.submit(_prompt(rng, 4), 5)
    srv.stop()
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="server stopped"):
            f.result(timeout=30)


def test_stop_drain_finishes_everything():
    rng = np.random.default_rng(44)
    srv = _srv(slots=2, prompt_len=4, max_len=32, multi_step=3)
    futs = [srv.submit(_prompt(rng, 4), 6) for _ in range(5)]
    srv.stop(drain=True)
    for f in futs:
        assert len(f.result(timeout=5)) == 6
    assert srv.stats()["requests"] == 5


def test_submit_after_stop_raises():
    srv = _srv(slots=1, prompt_len=4, max_len=16)
    srv.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        srv.submit(np.arange(3), 2)


def test_stop_before_start_fails_queued_futures():
    srv = _srv(slots=1, prompt_len=4, max_len=16, autostart=False)
    fut = srv.submit(np.arange(3), 2)
    srv.stop()
    with pytest.raises(RuntimeError, match="server stopped"):
        fut.result(timeout=30)


def test_failed_chunked_admission_frees_slot():
    rng = np.random.default_rng(45)
    srv = _srv(slots=1, prompt_len=4, max_len=32, chunked_prefill=True,
               chunk=4)
    try:
        orig = srv._pcache_prefix

        def bad(prompt, adapter):
            raise RuntimeError("cache lookup exploded")

        srv._pcache_prefix = bad
        fut = srv.submit(_prompt(rng, 4), 3)
        with pytest.raises(RuntimeError, match="cache lookup exploded"):
            fut.result(timeout=300)
        srv._pcache_prefix = orig
        assert len(srv.submit(_prompt(rng, 4), 3).result(timeout=300)) == 3
    finally:
        srv.stop()


def test_multi_step_logit_bias_bans_a_token():
    rng = np.random.default_rng(46)
    srv = _srv(slots=2, prompt_len=4, max_len=16, multi_step=2)
    try:
        p = _prompt(rng, 4)
        base = srv.submit(p, 4).result(timeout=300)
        out = srv.submit(p, 4, logit_bias={base[0]: -1e9}).result(
            timeout=300)
        assert base[0] not in out
    finally:
        srv.stop()


# --------------------------------------------------------------------------
# the two repaired faults of the reference
# --------------------------------------------------------------------------
def test_finish_and_fail_race_resolves_each_future_once():
    """The dispatcher's _finish and the watchdog's _fail on the same
    requests from two threads, switching every microsecond: no
    InvalidStateError, every future resolved exactly once, and the count
    of finished requests is the count of results."""
    srv = _srv(slots=1, prompt_len=4, max_len=16, autostart=False)
    reqs = [_Request(np.arange(3), 2) for _ in range(3000)]
    for r in reqs:
        srv._by_future[r.future] = r
    errors = []

    def run(fn):
        try:
            for r in reqs:
                fn(r)
        except Exception as e:  # what the race used to raise
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=run, args=(lambda r: srv._finish(None,
                                                                      r),)),
            threading.Thread(target=run, args=(
                lambda r: srv._fail(None, r, RuntimeError("watchdog")),))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert all(r.future.done() for r in reqs)
    n_results = sum(r.future.exception() is None for r in reqs)
    assert srv.requests_done == n_results
    assert len(srv._latencies) == n_results
    assert srv._by_future == {}


def _slow_new_graphs(srv, seconds):
    """Make every step that runs a graph for the first time take
    `seconds` longer, as a capture does on the card."""
    orig = srv._new_graph

    def slow(key):
        new = key not in srv._graphs_run
        orig(key)
        if new:
            time.sleep(seconds)

    srv._new_graph = slow


def test_watchdog_exempts_every_new_graph():
    """A server whose cache grows (len_buckets) runs a second decode graph
    mid-serve: its slow first step does not trip step_timeout, nor does
    the very first one."""
    rng = np.random.default_rng(47)
    srv = _srv(slots=2, prompt_len=8, max_len=48, len_buckets=(16, 48),
               multi_step=2, autostart=False)
    srv.step_timeout = 0.3
    _slow_new_graphs(srv, 1.0)
    srv.start()
    try:
        short = srv.submit(_prompt(rng, 5), 6).result(timeout=300)
        long = srv.submit(_prompt(rng, 6), 30).result(timeout=300)
    finally:
        srv.stop()
    assert len(short) == 6 and len(long) == 30
    assert {k[1] for k in srv._graphs_run} == {16, 48}
    assert not srv._watchdog_fired


def test_watchdog_still_fires_on_a_stuck_known_graph():
    rng = np.random.default_rng(48)
    srv = _srv(slots=1, prompt_len=8, max_len=48, autostart=False)
    srv.step_timeout = 0.3
    calls = []
    real_step = srv._step

    def step():
        calls.append(1)
        if len(calls) == 3:            # a graph run twice already
            time.sleep(1.5)
        real_step()

    srv._step = step
    srv.start()
    fut = srv.submit(_prompt(rng, 5), 10)
    with pytest.raises(RuntimeError, match="step_timeout"):
        fut.result(timeout=60)
    srv.stop()
    assert srv._watchdog_fired


# --------------------------------------------------------------------------
# options not ported yet, and the package's imports
# --------------------------------------------------------------------------
# the mesh options raise, naming their ROADMAP item; the LoRA bank and
# the moe family (item None) raised until they were ported, and now serve
# the JAX server's greedy tokens (an empty bank is refused, as in JAX)
@pytest.mark.parametrize("kw,item", [
    ({"lora_bank": {}}, None),
    ({"mesh": object()}, "1.12"),
    ({"param_sharding_fn": lambda n, a: None}, "1.12"),
    ({"kv_dtype": "int4", "family": "moe"}, None),
    ({"family": "moe"}, None),
], ids=["lora_bank", "mesh", "param_sharding_fn", "int4_kv_moe", "moe"])
def test_unported_server_options_raise(kw, item):
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            DecodeServer(TINY, slots=1, max_len=16, device="cpu",
                         autostart=False, **kw)
        return
    if "lora_bank" in kw:
        with pytest.raises(ValueError, match="empty adapter bank"):
            DecodeServer(TINY, slots=1, max_len=16, device="cpu",
                         autostart=False, **kw)
        return
    from onnx_rusty_inference_engine_tpu.models.moe import TINY as J_MOE
    from onnx_rusty_inference_engine_tpu_torch.models.moe import (
        TINY as MOE)

    reqs = _staggered(63, 3, (2, 7), (3, 6))
    outs = []
    for srv in (JDecodeServer(J_MOE, slots=2, prompt_len=6, max_len=24,
                              **kw),
                DecodeServer(MOE, slots=2, prompt_len=6, max_len=24,
                             device="cpu", **kw)):
        try:
            outs.append([[int(t) for t in f.result(timeout=300)] for f in
                         [srv.submit(p, n) for p, n, _ in reqs]])
        finally:
            srv.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("prefill_dtype", ["w8a8", "bfloat16"],
                         ids=["w8a8", "bf16_prefill"])
def test_server_prefill_dtype_with_int8_kv_matches_jax(prefill_dtype):
    """The bucketed prefill Engines in bf16 or W8A8 (ported since these
    options raised): with an INT8 KV cache, whose per-head scales come from
    the bf16 prefill's presents, the served greedy tokens equal JAX's."""
    (j, _), (t, _) = _both(
        dict(slots=2, prompt_len=8, max_len=24, kv_dtype="int8",
             prompt_buckets=(4, 8), prefill_dtype=prefill_dtype),
        _staggered(57, 4, (2, 9), (2, 6)))
    assert t == j


def test_unported_adapter_and_chunked_prefill_dtype():
    # an adapter is served once a bank is attached; without one it is
    # refused, as in JAX (test_torch_port_lora.py serves mixed adapters)
    srv = _srv(slots=1, max_len=16, autostart=False)
    with pytest.raises(ValueError, match="lora_bank"):
        srv.submit(np.arange(3), 2, adapter=1)
    srv.stop()
    # as in JAX: chunked prefill has no prefill engines to take the knob
    with pytest.raises(ValueError, match="prefill_dtype"):
        DecodeServer(TINY, slots=2, max_len=24, chunked_prefill=True,
                     chunk=4, prefill_dtype="w8a8", autostart=False,
                     device="cpu")


def test_servers_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(TINY, slots=1, max_len=16, autostart=False)


def test_serving_imports_no_jax():
    code = (
        "import sys\n"
        "import onnx_rusty_inference_engine_tpu_torch.serve\n"
        "import onnx_rusty_inference_engine_tpu_torch.serve_llm\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',\n"
        "                                   'onnx_rusty_inference_engine_tpu'))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
