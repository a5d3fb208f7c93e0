"""The port's Generator(device_loop=K) on the CPU: K decode steps a block,
the counterpart of the JAX Generator's lax.scan over time. A block must be
lossless against the port's own host loop, bit for bit, in every mode
(greedy, INT8 KV, fused attention, the eos freeze, the repetition penalty,
and seeded sampling: the block draws from the same torch.Generator in the
same order), for K in {1, 4, 8} and n_new not a multiple of K; greedy
blocks also give the JAX device loop's tokens. On the card the block is
one replayed CUDA graph (tests/test_torch_port_cuda.py); here it is the
same body as a Python loop, which reads nothing back inside a block."""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as J_TINY
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY

BASE = dict(batch=2, prompt_len=4, max_len=32, device="cpu")


def _ids(seed=5):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, (2, 4)).astype(np.int64)


def _pair(K, **kw):
    return (Generator(TINY, **BASE, **kw),
            Generator(TINY, device_loop=K, **BASE, **kw))


# (Generator kwargs, generate kwargs)
MODES = {
    "greedy": ({}, {}),
    "int8_kv": ({"kv_dtype": "int8"}, {}),
    "int8_fused": ({"kv_dtype": "int8", "fused_attention": True}, {}),
    "repetition_penalty": ({}, {"repetition_penalty": 1.4}),
    "sampled_top_k": ({}, {"temperature": 0.8, "top_k": 20,
                           "sample_seed": 7}),
    "sampled_top_p_min_p": ({"kv_dtype": "int8"},
                            {"temperature": 1.0, "top_p": 0.9,
                             "min_p": 0.05, "sample_seed": 5}),
    "sampled_penalty": ({}, {"temperature": 1.3, "repetition_penalty": 1.2,
                             "sample_seed": 11}),
}


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_block_equals_host_loop(mode, K):
    """11 new tokens: 10 steps after the prefill's, not a multiple of 4 or
    8 (the last block runs over and its extra tokens are dropped)."""
    gkw, kw = MODES[mode]
    host, dev = _pair(K, **gkw)
    ref, _ = host.generate(_ids(), 11, **kw)
    got, _ = dev.generate(_ids(), 11, **kw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("K", [1, 4, 8])
def test_eos_freeze_equals_host_loop(K):
    host, dev = _pair(K)
    ref, _ = host.generate(_ids(), 12)
    eos = int(ref[0, 2])                  # row 0 stops early
    r_eos, _ = host.generate(_ids(), 12, eos_id=eos)
    g_eos, _ = dev.generate(_ids(), 12, eos_id=eos)
    np.testing.assert_array_equal(g_eos, r_eos)
    first = int(np.argmax(g_eos[0] == eos))
    assert (g_eos[0, first:] == eos).all()


def test_all_rows_frozen_ends_between_blocks():
    """Both rows emit eos at once: the loop stops at the next block
    boundary and pads with eos, as the host loop does."""
    host, dev = _pair(4)
    ref, _ = host.generate(_ids(), 10)
    eos = int(ref[0, 0])
    ids = np.stack([_ids()[0], _ids()[0]])
    r_eos, _ = host.generate(ids, 10, eos_id=eos)
    g_eos, _ = dev.generate(ids, 10, eos_id=eos)
    np.testing.assert_array_equal(g_eos, r_eos)
    assert (g_eos == eos).all()


def test_return_logits_runs_the_host_loop():
    """As in JAX (tests/test_device_loop.py): return_logits runs the host
    loop, which has a logits array per step."""
    host, dev = _pair(4)
    toks, logits = dev.generate(_ids(), 5, return_logits=True)
    ref, ref_logits = host.generate(_ids(), 5, return_logits=True)
    assert len(logits) == 5 and toks.shape == (2, 5)
    np.testing.assert_array_equal(toks, ref)
    for a, b in zip(logits, ref_logits):
        np.testing.assert_array_equal(a, b)


def test_repeated_calls_and_other_configs_reuse_nothing_stale():
    """A Generator keeps one block per sampling configuration; calls with
    another prompt, another seed or another configuration in between give
    what a fresh Generator gives."""
    host, dev = _pair(4)
    kw = dict(temperature=0.9, top_k=30, sample_seed=3)
    for ids in (_ids(1), _ids(2)):
        for k in (kw, {}, dict(kw, sample_seed=4)):
            ref, _ = host.generate(ids, 9, **k)
            got, _ = dev.generate(ids, 9, **k)
            np.testing.assert_array_equal(got, ref)


def test_one_read_per_block(monkeypatch):
    """Nothing inside a block reads the device: the host reads the first
    token and then each block's [B, K] tokens once."""
    _, dev = _pair(4)
    reads = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    dev.generate(_ids(), 9)            # 8 steps after the first: 2 blocks
    assert reads == [(2,), (2, 4), (2, 4)]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_greedy_block_equals_jax_device_loop(kv):
    """Greedy tokens equal the JAX Generator(device_loop=4)'s."""
    ids = _ids()
    want, _ = JGenerator(J_TINY, batch=2, prompt_len=4, max_len=32,
                         kv_dtype=kv, device_loop=4).generate(ids, 11)
    got, _ = Generator(TINY, kv_dtype=kv, device_loop=4,
                       **BASE).generate(ids, 11)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_copy_to_another_device_has_its_own_blocks():
    _, dev = _pair(4)
    a, _ = dev.generate(_ids(), 9)
    other = dev.to("cpu")
    assert other._blocks == {} and other._gen is None
    b, _ = other.generate(_ids(), 9)
    np.testing.assert_array_equal(a, b)
