"""The port's contrib (com.microsoft) and core (opset 23) attention ops
against the JAX package's emitters on the CPU, one node at a time, on
inputs from a seeded numpy generator: tests/torch_port_oplib.py's
ATTENTION_CASES, the cases of tests/test_contrib_transformers.py and
tests/test_core_attention.py (BiasGelu, FastGelu, SkipLayerNormalization
with every output slot, EmbedLayerNormalization with and without its
mask, Attention with length and key masks, a relative bias, causal and
uneven QKV widths, MultiHeadAttention self and cross, RotaryEmbedding in
both layouts with offsets, GroupQueryAttention with its fused rotary and
seqlens_k, FusedMatMul; the core Attention in 3-D GQA and 4-D with
causal, boolean and additive masks, softcap, every qk_matmul_output_mode
and past / present KV; the core RotaryEmbedding with position_ids, a
partial rotary dim and per-position caches; the bare nodes that dispatch
to the contrib forms).

Tolerance: elementwise ops rtol 1e-5, atol 1e-6; anything through a
softmax or a LayerNorm rtol = atol = 1e-5 (the same float32 arithmetic in
another summation order).
"""

import numpy as np
import pytest

import torch_port_oplib as lib
from test_torch_port_op_library import assert_close, run_jax, run_port

CASES = lib.ATTENTION_CASES


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_attention_op_matches_jax(c):
    want, got = run_jax(c), run_port(c)
    assert len(got) == len(want) == c.n_out
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, c.tol, f"{c.id} out{i}")


def test_gqa_masked_keys_do_not_leak():
    """A key past a row's seqlens_k changes nothing in that row."""
    c = next(c for c in CASES if c.id == "GroupQueryAttention_rope_i0")
    (a,) = run_port(c)
    feeds = {k: v.copy() for k, v in c.feeds.items()}
    feeds["k"][1, 3:] += 5.0
    feeds["v"][1, 3:] -= 5.0
    (b,) = run_port(c._replace(feeds=feeds))
    np.testing.assert_array_equal(a[1, :3], b[1, :3])
    np.testing.assert_array_equal(a[0], b[0])
