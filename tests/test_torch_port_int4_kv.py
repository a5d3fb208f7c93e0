"""The port's INT4 nibble-packed KV cache held against the JAX package on
the CPU (the twins of tests/test_int4_kv.py): quant.pack_int4_kv bit-equal,
tests/goldens/gpt2_int4kv_step.pb through the port, one decode step of the
gpt2 and llama (GQA) int4 graphs equal to JAX's (presents bit for bit), the
pack/unpack machinery exact on a cache on the int4 grid, chunk = k equal to
k single steps, and Generator / DecodeServer with kv_dtype="int4" (host
loop, device loop, bucketed and chunked prefill, chunked multi_step) giving
JAX's greedy tokens. Every input comes from numpy with a seed."""

import os

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models import llama as j_llama
from onnx_rusty_inference_engine_tpu.quant import (
    pack_int4_kv as j_pack_int4_kv)
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import (
    build_gpt2_decode, build_llama_decode)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY as G_TINY
from onnx_rusty_inference_engine_tpu_torch.models.llama import TINY as L_TINY
from onnx_rusty_inference_engine_tpu_torch.quant import pack_int4_kv
from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer
from torch_port_util import to_port

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "gpt2_int4kv_step.pb")
FAMILIES = {"gpt2": (G_TINY, j_gpt2, build_gpt2_decode),
            "llama": (L_TINY, j_llama, build_llama_decode)}


def _jcfg(family):
    """The JAX package's TINY of the family (the port's has its values)."""
    return FAMILIES[family][1].TINY


def _heads(cfg):
    return getattr(cfg, "n_kv_head", cfg.n_head)


def _unpack(p):
    """The graphs' unpack, in numpy: int8 [..., hd/2] -> q [..., hd]."""
    q1 = np.floor((p.astype(np.float64) + 128) / 16) - 8
    q0 = p - 16 * q1 - 8
    out = np.empty(p.shape[:-1] + (p.shape[-1] * 2,))
    out[..., 0::2] = q0
    out[..., 1::2] = q1
    return out


# --------------------------------------------------------------------------
# the host-side packing and the golden
# --------------------------------------------------------------------------
def test_pack_int4_kv_bit_equal_to_jax():
    """Random K/V with per-head scales (values past the int4 range clip,
    .5 ties round to even)."""
    rng = np.random.default_rng(41)
    kv = (rng.standard_normal((2, 3, 9, 16)) * 0.3).astype(np.float32)
    s = (rng.random(3) * 0.05 + 0.01).astype(np.float32).reshape(1, 3, 1, 1)
    kv[0, 0, 0, :4] = np.array([0.5, 1.5, -2.5, 100.0], np.float32) * s[
        0, 0, 0, 0]
    want = j_pack_int4_kv(kv, s)
    got = pack_int4_kv(torch.from_numpy(kv), torch.from_numpy(s)).numpy()
    assert got.dtype == want.dtype == np.int8 and got.shape == (2, 3, 9, 8)
    np.testing.assert_array_equal(got, want)
    # the graphs' unpack inverts it on the int4 grid
    np.testing.assert_array_equal(
        _unpack(got), np.clip(np.round(kv / s), -8, 7))


def _golden_feed(cfg):
    """tests/test_regression_goldens.py::_int4_feed."""
    r = np.random.default_rng(7)
    feed = {"input_ids": r.integers(0, cfg.vocab_size,
                                    (1, 1)).astype(np.int64),
            "pos": np.array([5], np.int64)}
    for i in range(cfg.n_layer):
        for kind in ("key", "value"):
            feed[f"past_{kind}_{i}"] = r.integers(
                -128, 128,
                (1, cfg.n_head, 16, cfg.head_dim // 2)).astype(np.int8)
            feed[f"kv_scale_{kind}_{i}"] = np.full(
                (cfg.n_head,), 0.05, np.float32)
    return feed


def test_gpt2_int4kv_step_golden():
    golden = j_io.read_tensor_file(GOLDEN).array
    eng = Engine(import_model(build_gpt2_decode(
        G_TINY, batch=1, max_len=16, kv_dtype="int4")), device="cpu")
    got = eng.run(_golden_feed(G_TINY))["logits"]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# the decode graphs
# --------------------------------------------------------------------------
def _packed_feed(cfg, B, L, T, seed, scale=None):
    rng = np.random.default_rng(seed)
    H, hd = _heads(cfg), cfg.head_dim
    feed = {"input_ids": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                np.int64),
            "pos": np.array([2, 5], np.int64)[:B]}
    for i in range(cfg.n_layer):
        for kind in ("key", "value"):
            feed[f"past_{kind}_{i}"] = rng.integers(
                -128, 128, (B, H, L, hd // 2)).astype(np.int8)
            feed[f"kv_scale_{kind}_{i}"] = (
                np.full((H,), scale, np.float32) if scale else
                (rng.random(H) * 0.05 + 0.02).astype(np.float32))
    return feed


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_equals_jax(family, T):
    """One int4 decode call (chunk T) on a random packed cache: logits
    within rtol 1e-4 / atol 1e-5, the packed presents bit-equal."""
    cfg, jmod, _ = FAMILIES[family]
    jbuild = getattr(jmod, f"build_{family}_decode")
    model = jbuild(_jcfg(family), batch=2, max_len=16, kv_dtype="int4",
                   chunk=T)
    feed = _packed_feed(cfg, 2, 16, T, seed=43)
    want = JEngine(j_import(model)).run(feed)
    got = Engine(to_port(model), device="cpu").run(feed)
    np.testing.assert_allclose(got["logits"], np.asarray(want["logits"]),
                               rtol=1e-4, atol=1e-5)
    for i in range(cfg.n_layer):
        for kind in ("key", "value"):
            p = got[f"present_{kind}_{i}"]
            assert p.dtype == np.int8
            np.testing.assert_array_equal(
                p, np.asarray(want[f"present_{kind}_{i}"]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_matches_fp32_on_grid_cache(family):
    """With the past cache on the int4 grid (exact) and per-head scales
    amax / 7 of the new token's fp32 k/v, the int4 graph's layer-0
    presents equal numpy's quantization of the fp32 graph's presents (one
    rounding step where f32 and f64 part on a tie), and the logits agree
    to quantization noise (test_int4_kv.py's bounds)."""
    cfg, _, build = FAMILIES[family]
    H, hd, NL = _heads(cfg), cfg.head_dim, cfg.n_layer
    B, L = 2, 12
    e4 = Engine(import_model(build(cfg, batch=B, max_len=L,
                                   kv_dtype="int4")), device="cpu")
    ef = Engine(import_model(build(cfg, batch=B, max_len=L)), device="cpu")
    rng = np.random.default_rng(47)
    ids = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int64)
    pos = np.array([3, 5], np.int64)
    probe = {"input_ids": ids, "pos": pos}
    for i in range(NL):
        for kind in ("key", "value"):
            probe[f"past_{kind}_{i}"] = np.zeros((B, H, L, hd), np.float32)
    pout = ef.run(probe)
    feed4, feedf = dict(probe), {"input_ids": ids, "pos": pos}
    scales = {}
    for i in range(NL):
        for kind in ("key", "value"):
            kv = pout[f"present_{kind}_{i}"]
            sh = (np.maximum(np.abs(kv).max(axis=(0, 2, 3)), 1e-6)
                  / 7.0).astype(np.float32)
            scales[f"{kind}_{i}"] = sh
            q = rng.integers(-8, 8, (B, H, L, hd)).astype(np.float32)
            feed4[f"past_{kind}_{i}"] = pack_int4_kv(
                torch.from_numpy(q), torch.tensor(1.0)).numpy()
            feed4[f"kv_scale_{kind}_{i}"] = sh
            feedf[f"past_{kind}_{i}"] = q * sh[None, :, None, None]
    o4, of = e4.run(feed4), ef.run(feedf)
    np.testing.assert_allclose(o4["logits"], of["logits"],
                               atol=0.08 if family == "llama" else 0.05)
    for kind in ("key", "value"):
        p4 = o4[f"present_{kind}_0"]
        assert p4.dtype == np.int8 and p4.shape == (B, H, L, hd // 2)
        sh = scales[f"{kind}_0"][None, :, None, None]
        want = np.clip(np.round(of[f"present_{kind}_0"] / sh), -8, 7)
        diff = np.abs(_unpack(p4) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunk_equals_sequential_steps(family):
    """chunk = k int4 decode == k single int4 steps, presents bit for bit
    (the same quantization per token, packed-domain scatter)."""
    cfg, _, build = FAMILIES[family]
    B, L, k = 2, 16, 3
    e1 = Engine(import_model(build(cfg, batch=B, max_len=L,
                                   kv_dtype="int4")), device="cpu")
    ek = Engine(import_model(build(cfg, batch=B, max_len=L, kv_dtype="int4",
                                   chunk=k)), device="cpu")
    feed = _packed_feed(cfg, B, L, k, seed=49, scale=0.05)
    ids, pos0 = feed.pop("input_ids"), feed.pop("pos")
    ok = ek.run({"input_ids": ids, "pos": pos0, **feed})
    c1 = dict(feed)
    for j in range(k):
        o1 = e1.run({"input_ids": ids[:, j:j + 1], "pos": pos0 + j, **c1})
        for name in list(c1):
            if name.startswith("past_"):
                c1[name] = o1[name.replace("past_", "present_", 1)]
    np.testing.assert_allclose(ok["logits"][:, -1], o1["logits"][:, -1],
                               rtol=1e-4, atol=1e-4)
    for name in c1:
        if name.startswith("past_"):
            np.testing.assert_array_equal(
                ok[name.replace("past_", "present_", 1)], c1[name])


# --------------------------------------------------------------------------
# the drivers
# --------------------------------------------------------------------------
def _ids(cfg, B, P, seed=51):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_int4_kv_equals_jax(family):
    """Greedy tokens equal JAX's, logits within 1e-4; the first token (the
    prefill, no KV quantization) equals fp32's; repeated calls agree."""
    cfg = FAMILIES[family][0]
    kw = dict(batch=2, prompt_len=4, max_len=16, family=family)
    ids = _ids(cfg, 2, 4)
    jt, jl = JGenerator(_jcfg(family), kv_dtype="int4", **kw).generate(
        ids, 6, return_logits=True)
    g = Generator(cfg, kv_dtype="int4", device="cpu", **kw)
    tt, tl = g.generate(ids, 6, return_logits=True)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(g.generate(ids, 6)[0], tt)
    tf, _ = Generator(cfg, device="cpu", **kw).generate(ids, 6)
    np.testing.assert_array_equal(tt[:, 0], tf[:, 0])
    name = "past_key_0"
    _, cache = g.start(torch.from_numpy(ids))
    assert cache[name].dtype == torch.int8
    assert cache[name].shape[-1] == cfg.head_dim // 2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_int4_kv_device_loop_equals_host_loop(family):
    cfg = FAMILIES[family][0]
    kw = dict(batch=2, prompt_len=4, max_len=20, kv_dtype="int4",
              family=family, device="cpu")
    ids = _ids(cfg, 2, 4, seed=53)
    want, _ = Generator(cfg, **kw).generate(ids, 8)
    got, _ = Generator(cfg, device_loop=3, **kw).generate(ids, 8)
    np.testing.assert_array_equal(got, want)


def _serve(port, family, server_kw, reqs):
    cfg = FAMILIES[family][0]
    if port:
        srv = DecodeServer(cfg, family=family, device="cpu", **server_kw)
    else:
        srv = JDecodeServer(_jcfg(family), family=family, **server_kw)
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        outs = [[int(t) for t in f.result(timeout=300)] for f in futs]
        again = [int(t) for t in srv.submit(*reqs[0]).result(timeout=300)]
        cache = {k: (v.dtype, tuple(v.shape)) for k, v in srv._cache.items()}
    finally:
        srv.stop()
    return outs, again, cache


SERVER_CASES = {
    "buckets": dict(slots=2, prompt_len=8, max_len=24,
                    prompt_buckets=(4, 8)),
    "multi_step3": dict(slots=2, prompt_len=8, max_len=24, multi_step=3),
    "chunked": dict(slots=2, max_len=32, chunked_prefill=True, chunk=4),
    "chunked_multi3": dict(slots=2, max_len=32, chunked_prefill=True,
                           chunk=4, multi_step=3),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_server_int4_kv_equals_jax(family, case):
    """Served greedy tokens equal the JAX server's, also for a request
    sent again into a reused slot, and the cache ends packed (hd/2, int8).
    In the chunked modes the first requests start in the fp32
    shadow-calibration phase, so the request sent again (all int4) may
    differ from its first run; with bucketed prefill it repeats it."""
    cfg = FAMILIES[family][0]
    kw = dict(SERVER_CASES[case], kv_dtype="int4")
    rng = np.random.default_rng(55)
    plen = (2, 12) if kw.get("chunked_prefill") else (2, 9)
    reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(*plen)),)
                          ).astype(np.int64), int(rng.integers(4, 9)))
            for _ in range(3)]
    want, want_again, _ = _serve(False, family, kw, reqs)
    got, again, cache = _serve(True, family, kw, reqs)
    assert got == want and again == want_again
    if not kw.get("chunked_prefill"):
        assert again == got[0]
    for dtype, shape in cache.values():
        assert dtype == torch.int8 and shape[-1] == cfg.head_dim // 2
        assert shape[1] == _heads(cfg)


def test_int4_kv_refused_where_no_graph_packs():
    """Only the gpt2 and llama decode graphs pack the cache; fused attention
    reads an int8 cache only."""
    from onnx_rusty_inference_engine_tpu_torch.models import (
        register_decoder_family)

    register_decoder_family("int4-kv-less", lambda *a, **k: None,
                            lambda *a, **k: None, int8_kv_ok=True)
    with pytest.raises(NotImplementedError, match="gpt2 and llama"):
        Generator(G_TINY, kv_dtype="int4", family="int4-kv-less",
                  device="cpu")
    with pytest.raises(NotImplementedError, match="gpt2 and llama"):
        DecodeServer(G_TINY, kv_dtype="int4", family="int4-kv-less",
                     device="cpu", autostart=False)
    with pytest.raises(ValueError, match="int4 KV"):
        Generator(L_TINY, family="llama", kv_dtype="int4",
                  fused_attention=True, device="cpu")
