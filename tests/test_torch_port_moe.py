"""The MoE decoder family (onnx_rusty_inference_engine_tpu_torch/models/
moe.py) through the port on the CPU, against the JAX package.

- build_moe and build_moe_decode give the JAX builders' ONNX bytes for
  float32, int8 and int4 KV, at chunk 1 and 3 (and at full width).
- Prefill logits and every layer's router probabilities against the JAX
  Engine (rtol 1e-5, atol 1e-5), with the routed experts equal; the
  cached decode reproduces the prefill (rtol 1e-4, as tests/test_moe.py).
- Generator greedy tokens equal JAX's for fp32, int8 and int4 KV and with
  int4 weights; device_loop equals the host loop; the server equals the
  isolated runs (int4 KV too) and JAX's server; tests/goldens/moe.pb at
  rtol = atol = 1e-3.
"""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import moe as j_moe
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch import onnx_io as t_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import (
    decoder_family, moe)
from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

import test_regression_goldens as goldens

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
TINY, J_TINY = moe.TINY, j_moe.TINY
FULL = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_head=12,
            n_expert=8, d_ff=3072, n_layer=1)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, shape).astype(np.int64)


@pytest.mark.parametrize("kv_dtype,chunk", [
    ("float32", 1), ("float32", 3), ("int8", 1), ("int8", 3), ("int4", 1),
    ("int4", 3)])
def test_decode_builder_gives_the_jax_bytes(kv_dtype, chunk):
    ours = moe.build_moe_decode(TINY, batch=2, max_len=16, seed=3,
                                kv_dtype=kv_dtype, chunk=chunk)
    theirs = j_moe.build_moe_decode(J_TINY, batch=2, max_len=16, seed=3,
                                    kv_dtype=kv_dtype, chunk=chunk)
    assert t_io.serialize_model(ours) == j_io.serialize_model(theirs)


@pytest.mark.parametrize("presents", [False, True],
                         ids=["logits", "with_presents"])
def test_prefill_builder_gives_the_jax_bytes(presents):
    ours = moe.build_moe(TINY, batch=2, seq_len=8, with_presents=presents)
    theirs = j_moe.build_moe(J_TINY, batch=2, seq_len=8,
                             with_presents=presents)
    assert t_io.serialize_model(ours) == j_io.serialize_model(theirs)


def test_full_width_layer_gives_the_jax_bytes():
    """One layer at the smoke's widths (GPT-2 small with Switch-base-8's
    experts): the builder's bytes, inside and outside host_memo."""
    ours = moe.build_moe_decode(moe.MoEConfig(**FULL), batch=1, max_len=8)
    theirs = j_moe.build_moe_decode(j_moe.MoEConfig(**FULL), batch=1,
                                    max_len=8)
    assert t_io.serialize_model(ours) == j_io.serialize_model(theirs)
    from onnx_rusty_inference_engine_tpu_torch.models import host_memo

    with host_memo():
        first = moe.build_moe(moe.MoEConfig(**FULL), batch=1, seq_len=4)
        again = moe.build_moe(moe.MoEConfig(**FULL), batch=1, seq_len=4)
    assert t_io.serialize_model(first) == t_io.serialize_model(again) \
        == j_io.serialize_model(j_moe.build_moe(
            j_moe.MoEConfig(**FULL), batch=1, seq_len=4))


def test_prefill_and_routing_match_jax():
    m = j_moe.build_moe(J_TINY, batch=2, seq_len=8)
    ids = _ids(37, (2, 8))
    got = Engine(import_model(moe.build_moe(TINY, batch=2, seq_len=8)),
                 device="cpu").run({"input_ids": ids}).outputs
    want = JEngine(j_import(m)).run({"input_ids": ids}).outputs
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)
    for i in range(TINY.n_layer):
        rp, jrp = got[f"router_probs_{i}"], np.asarray(
            want[f"router_probs_{i}"])
        np.testing.assert_allclose(rp, jrp, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rp.argmax(-1), jrp.argmax(-1))
        np.testing.assert_allclose(rp.sum(-1), 1.0, atol=1e-5)


def test_decode_matches_prefill():
    P = 4
    ids = _ids(38, (1, P))
    pre = Engine(import_model(moe.build_moe(TINY, batch=1, seq_len=P)),
                 device="cpu")
    dec = Engine(import_model(moe.build_moe_decode(TINY, batch=1,
                                                   max_len=16)),
                 device="cpu")
    full = pre.run({"input_ids": ids}).outputs["logits"]
    cache = {f"past_{k}_{i}": np.zeros((1, TINY.n_head, 16, TINY.head_dim),
                                       np.float32)
             for i in range(TINY.n_layer) for k in ("key", "value")}
    inc = []
    for t in range(P):
        o = dec.run({"input_ids": ids[:, t:t + 1],
                     "pos": np.array([t], np.int64), **cache}).outputs
        inc.append(o["logits"])
        cache = {k: o[k.replace("past_", "present_")] for k in cache}
    np.testing.assert_allclose(np.concatenate(inc, axis=1), full,
                               rtol=1e-4, atol=1e-4)


def test_decoder_family_is_moe():
    assert decoder_family("moe") == (moe.build_moe, moe.build_moe_decode,
                                     True)


@pytest.mark.parametrize("kw", [
    {}, {"kv_dtype": "int8"}, {"kv_dtype": "int4"}, {"int4_weights": True},
    {"int4_weights": True, "kv_dtype": "int8"}],
    ids=["fp32", "int8_kv", "int4_kv", "int4_weights", "int4_int8kv"])
def test_generator_tokens_equal_jax(kw):
    ids = _ids(3, (2, 4))
    base = dict(batch=2, prompt_len=4, max_len=24, family="moe", **kw)
    want, _ = JGenerator(J_TINY, **base).generate(ids, 8)
    got, _ = Generator(TINY, device="cpu", **base).generate(ids, 8)
    np.testing.assert_array_equal(got, want)


def test_device_loop_parity():
    ids = _ids(4, (2, 4))
    base = dict(batch=2, prompt_len=4, max_len=24, family="moe",
                device="cpu")
    ref, _ = Generator(TINY, **base).generate(ids, 7)
    got, _ = Generator(TINY, device_loop=3, **base).generate(ids, 7)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int4"},
                                {"multi_step": 3, "kv_dtype": "int8"}],
                         ids=["fp32", "int4_kv", "multi_step3_int8"])
def test_server_matches_isolated_and_jax(kw):
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(4):
        plen = int(rng.integers(2, 7))
        n_new = int(rng.integers(2, 6))
        reqs.append((rng.integers(0, TINY.vocab_size, (plen,)).astype(
            np.int64), n_new))
    skw = dict(slots=2, prompt_len=6, max_len=24, family="moe", **kw)
    srv = DecodeServer(TINY, device="cpu", **skw)
    try:
        outs = [f.result(timeout=300) for f in
                [srv.submit(p, n) for p, n in reqs]]
    finally:
        srv.stop()
    jsrv = JDecodeServer(J_TINY, **skw)
    try:
        jouts = [f.result(timeout=300) for f in
                 [jsrv.submit(p, n) for p, n in reqs]]
    finally:
        jsrv.stop()
    assert [list(map(int, o)) for o in outs] == \
        [list(map(int, o)) for o in jouts]
    if "kv_dtype" not in kw:
        for (p, n), got in zip(reqs, outs):
            want, _ = Generator(TINY, batch=1, prompt_len=p.size,
                                max_len=24, family="moe",
                                device="cpu").generate(p[None], n)
            assert list(got) == list(want[0]), (p, got, list(want[0]))


def test_moe_golden():
    (_, build, feed, out_name), = [c for c in goldens._cases()
                                   if c[0] == "moe"]
    got = Engine(import_model(moe.build_moe(TINY, batch=1, seq_len=8)),
                 device="cpu").run(feed).outputs[out_name]
    golden = j_io.read_tensor_file(os.path.join(GOLDEN_DIR, "moe.pb")).array
    assert got.shape == golden.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)
