"""generate.SpeculativeGenerator through the port on the CPU, against the
JAX package's and against the target's own greedy Generator.

- Greedy verification is lossless: with the draft equal to the target,
  with a 1-layer draft of other weights, and on GQA llama, the tokens are
  the port target's greedy Generator's and the JAX SpeculativeGenerator's,
  and the acceptance rate is JAX's.
- Rejection sampling runs on the host from np.random.default_rng(
  sample_seed), the JAX package's numpy stream: at the same seed the
  sampled tokens and the acceptance rate equal JAX's (draft equal to the
  target, and a mismatched draft); the same seed reproduces, another seed
  differs.

Each JAX run happens once, in a module fixture.
"""

import dataclasses

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import generate as jgen
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models import llama as j_llama
from onnx_rusty_inference_engine_tpu_torch.generate import (
    Generator, SpeculativeGenerator)
from onnx_rusty_inference_engine_tpu_torch.models import gpt2, llama

# case -> (family, JAX target, port target, draft layers (None: the
# target's config), generator kwargs, generate kwargs, n_new)
CASES = {
    "same_draft": ("gpt2", j_gpt2.TINY, gpt2.TINY, None,
                   dict(k=4, draft_seed=0), {}, 10),
    "small_draft": ("gpt2", j_gpt2.TINY, gpt2.TINY, 1,
                    dict(k=4, draft_seed=9), {}, 10),
    "llama": ("llama", j_llama.TINY, llama.TINY, None,
              dict(k=3, draft_seed=0), {}, 8),
    "sampled_same_draft": ("gpt2", j_gpt2.TINY, gpt2.TINY, None,
                           dict(k=4, draft_seed=0),
                           dict(temperature=0.8, sample_seed=3), 10),
    "sampled_small_draft": ("gpt2", j_gpt2.TINY, gpt2.TINY, 1,
                            dict(k=4, draft_seed=7),
                            dict(temperature=1.0, sample_seed=1), 12),
}
B, P, MAX_LEN = 2, 4, 40


def _ids(cfg):
    return np.random.default_rng(23).integers(0, cfg.vocab_size, (B, P))


def _make(cls, fam, cfg, layers, gkw, **extra):
    draft = None if layers is None else dataclasses.replace(cfg,
                                                            n_layer=layers)
    return cls(cfg, draft, batch=B, prompt_len=P, max_len=MAX_LEN,
               family=fam, **gkw, **extra)


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX (tokens, acceptance rate), computed once."""
    out = {}
    for name, (fam, jcfg, _, layers, gkw, kw, n_new) in CASES.items():
        sg = _make(jgen.SpeculativeGenerator, fam, jcfg, layers, gkw)
        toks, _ = sg.generate(_ids(jcfg), n_new, **kw)
        out[name] = (np.asarray(toks), sg.acceptance_rate)
    return out


def _port(case):
    fam, _, cfg, layers, gkw, kw, n_new = CASES[case]
    sg = _make(SpeculativeGenerator, fam, cfg, layers, gkw, device="cpu")
    toks, _ = sg.generate(_ids(cfg), n_new, **kw)
    return toks, sg.acceptance_rate


@pytest.mark.parametrize("case", ["same_draft", "small_draft", "llama"])
def test_greedy_equals_jax_and_the_targets_greedy(case, jax_runs):
    fam, _, cfg, _, _, _, n_new = CASES[case]
    toks, acc = _port(case)
    want, _ = Generator(cfg, batch=B, prompt_len=P, max_len=MAX_LEN,
                        family=fam, device="cpu").generate(_ids(cfg), n_new)
    np.testing.assert_array_equal(toks, want)
    np.testing.assert_array_equal(toks, jax_runs[case][0])
    assert acc == jax_runs[case][1]
    if case != "small_draft":      # the draft is the target
        assert acc > 0.5


@pytest.mark.parametrize("case", ["sampled_same_draft",
                                  "sampled_small_draft"])
def test_host_sampling_equals_jax_at_the_same_seed(case, jax_runs):
    toks, acc = _port(case)
    np.testing.assert_array_equal(toks, jax_runs[case][0])
    assert acc == jax_runs[case][1]
    assert 0.0 <= acc <= 1.0
    if case == "sampled_same_draft":
        # q == p up to the chunk graph's rounding: nearly every proposal
        # accepted
        assert acc >= 0.9


def test_sampling_reproduces_per_seed():
    fam, _, cfg, layers, gkw, kw, n_new = CASES["sampled_same_draft"]
    gen = _make(SpeculativeGenerator, fam, cfg, layers, gkw, device="cpu")
    a, _ = gen.generate(_ids(cfg), n_new, temperature=0.8, sample_seed=3)
    b, _ = gen.generate(_ids(cfg), n_new, temperature=0.8, sample_seed=3)
    c, _ = gen.generate(_ids(cfg), n_new, temperature=0.8, sample_seed=9)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (B, n_new)
    assert a.min() >= 0 and a.max() < cfg.vocab_size


def test_speculative_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeculativeGenerator(gpt2.TINY)
