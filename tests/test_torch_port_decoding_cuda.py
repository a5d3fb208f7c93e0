"""Beam search, speculative serving and Seq2SeqServer on the card (marker
`cuda`; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_decoding_cuda.py -q

- BeamGenerator(device_loop=True): every beam step after the first as one
  captured graph; its first call (eager, then the capture) and a replay
  give the card's host loop's beams, scores within 1e-5 relative, and the
  CPU's tokens; with int4 weights the int4 kernel launches once per
  MatMulNBits node of the prefill and of each step, on the host loop and
  on the replayed block alike.
- Seq2SeqBeamGenerator's block equals its host loop on t5 and asr.
- SpeculativeServer(multi_step=R): R rounds as one captured graph give
  the tokens of R host rounds (draft model and prompt lookup), and a lane
  parked through the blocks keeps a finite cache.
- Seq2SeqServer(multi_step=K): the captured K-step block gives the
  single-step server's tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.generate import (
    BeamGenerator, Seq2SeqBeamGenerator)
from onnx_rusty_inference_engine_tpu_torch.models import asr, gpt2, t5
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import counters
from onnx_rusty_inference_engine_tpu_torch.serving import (
    Seq2SeqServer, SpeculativeServer)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int64)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _launches() -> int:
    torch.cuda.synchronize()
    return counters.wrappers()["qmatmul_int4_planar"].launches


@pytest.mark.parametrize("int4", [False, True])
def test_captured_beam_block_equals_host_loop(cuda, int4):
    ids = _ids(1, (2, 8), gpt2.TINY.vocab_size)
    kw = dict(batch=2, beam=3, prompt_len=8, max_len=24,
              int4_weights=int4)
    host = BeamGenerator(gpt2.TINY, device=cuda, **kw)
    dev = BeamGenerator(gpt2.TINY, device=cuda, device_loop=True, **kw)
    cpu = BeamGenerator(gpt2.TINY, device="cpu", **kw)
    n_pre = sum(n.op_type == "MatMulNBits" for n in host.prefill.graph.nodes)
    n_step = sum(n.op_type == "MatMulNBits" for n in host.decode.graph.nodes)
    assert (n_step > 0) == int4
    for eos in (None, 7):
        want_t, want_s = cpu.generate(ids, 10, eos_id=eos)
        c0 = _launches()
        ht, hs = host.generate(ids, 10, eos_id=eos)
        host_launches = _launches() - c0
        np.testing.assert_array_equal(ht, want_t)
        for _ in range(2):              # the capture, then a replay
            c0 = _launches()
            dt, ds = dev.generate(ids, 10, eos_id=eos)
            dev_launches = _launches() - c0
            np.testing.assert_array_equal(dt, ht)
            assert _rel(ds, hs) <= 1e-5
        if eos is None and int4:
            # every row stays live: 9 steps after the prefill
            assert host_launches == dev_launches == n_pre + 9 * n_step
    assert len(dev.steps._graphs) == 2     # one block per (n_new, eos_id)


@pytest.mark.parametrize("fam", ["t5", "asr"])
def test_captured_seq2seq_beam_block_equals_host_loop(cuda, fam):
    cfg, S = (t5.TINY, 8) if fam == "t5" else (asr.TINY, 512)
    if fam == "t5":
        src = _ids(2, (2, S), cfg.vocab_size)
    else:
        src = np.random.default_rng(2).standard_normal((2, S)).astype(
            np.float32)
    kw = dict(batch=2, beam=3, src_len=S, max_len=16, family=fam)
    ht, hs = Seq2SeqBeamGenerator(cfg, device=cuda, **kw).generate(src, 8)
    dev = Seq2SeqBeamGenerator(cfg, device=cuda, device_loop=True, **kw)
    for _ in range(2):
        dt, ds = dev.generate(src, 8)
        np.testing.assert_array_equal(dt, ht)
        assert _rel(ds, hs) <= 1e-5


def _serve(srv, reqs):
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        return [f.result(timeout=600) for f in futs]
    finally:
        srv.stop()


@pytest.mark.parametrize("ngram", [0, 2])
def test_captured_spec_rounds_equal_host_rounds(cuda, ngram):
    rng = np.random.default_rng(3)
    reqs = [(np.tile(rng.integers(0, 256, (3,)), 3)[:int(rng.integers(4, 9))]
             .astype(np.int64), int(rng.integers(6, 14))) for _ in range(6)]
    draft = None if ngram else dataclasses.replace(gpt2.TINY, n_layer=1)
    kw = dict(slots=3, prompt_len=8, max_len=64, k=4, ngram=ngram,
              device=cuda)
    host = _serve(SpeculativeServer(gpt2.TINY, draft, **kw), reqs)
    srv = SpeculativeServer(gpt2.TINY, draft, multi_step=3, **kw)
    try:
        dev = [f.result(timeout=600)
               for f in [srv.submit(p, n) for p, n in reqs]]
        caches = list(srv._t_cache.values()) + list(srv._d_cache.values())
        assert all(torch.isfinite(c).all() for c in caches)
        assert len(srv._graphs) == 1          # one block, replayed
    finally:
        srv.stop()
    assert dev == host


def test_captured_seq2seq_server_block_equals_single_steps(cuda):
    rng = np.random.default_rng(4)
    srcs = [rng.integers(0, t5.TINY.vocab_size, (int(rng.integers(2, 9)),)
                         ).astype(np.int64) for _ in range(6)]
    outs = []
    for K in (0, 4):
        srv = Seq2SeqServer(t5.TINY, slots=3, src_len=8, max_len=16,
                            multi_step=K, device=cuda)
        outs.append(_serve(srv, [(s, 10) for s in srcs]))
    assert outs[0] == outs[1]
