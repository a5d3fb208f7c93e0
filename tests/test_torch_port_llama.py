"""The PyTorch port's Llama slice held against the JAX package on the CPU:
the emitters the Llama graphs and the int4 KV cache add, the builders
(graphs equal node for node and constant for constant, also after the int4
quantizer), the llama golden, prefill and decode logits, Generator greedy
tokens (fp32 KV, INT8 KV, INT8 + fused attention, INT4 weights), the K-step
device loop and DecodeServer(family="llama"). Every input comes from numpy
with a seed and goes to both packages."""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import llama as j_llama
from onnx_rusty_inference_engine_tpu.quant import (
    quantize_weights_int4 as j_quantize_int4)
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch import quant as t_quant
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import (
    build_llama, build_llama_decode, decoder_family, host_memo)
from onnx_rusty_inference_engine_tpu_torch.models.llama import (
    TINY, LlamaConfig)
from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer
from torch_port_util import assert_graphs_equal, run_op_port, to_port
from util import make_model, node, run_op

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "llama.pb")
# GQA at 4 query heads per KV head and head_dim 128, as LlamaConfig()'s
# defaults group them; dim 512 makes every matmul an int4 one
GQA = LlamaConfig(vocab_size=256, max_positions=64, dim=512, n_layer=2,
                  n_head=4, n_kv_head=1, ffn_mult=2)
CONFIGS = {"tiny": TINY, "gqa_rep4_hd128": GQA}


def _jcfg(cfg):
    return j_llama.LlamaConfig(**{k: getattr(cfg, k) for k in (
        "vocab_size", "max_positions", "dim", "n_layer", "n_head",
        "n_kv_head", "ffn_mult", "rope_theta")})


def _same(got, want, rtol=1e-5, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# emitters, each against the JAX emitter
# --------------------------------------------------------------------------
_RNG = np.random.default_rng(31)
_X = (_RNG.standard_normal((2, 3, 8)) * 3).astype(np.float32)
# .5 ties on both sides of zero: Round goes to the even neighbour
_TIES = np.array([[-3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5],
                  [-1e-8, 0.49999997, 0.50000006, -0.50000006, 7.5, -7.5,
                   8.5, -8.5]], np.float32)
_LO, _HI = np.float32(-1.25), np.float32(2.0)

# (op, inputs, initializers, opset, attrs)
EMITTER_CASES = {
    "sigmoid": ("Sigmoid", {"x": _X}, None, 13, {}),
    "neg": ("Neg", {"x": _X}, None, 13, {}),
    "neg_int64": ("Neg", {"x": _RNG.integers(-9, 9, (3, 4))}, None, 13, {}),
    "floor": ("Floor", {"x": _X}, None, 13, {}),
    "floor_ties": ("Floor", {"x": _TIES}, None, 13, {}),
    "round": ("Round", {"x": _X}, None, 13, {}),
    "round_half_to_even": ("Round", {"x": _TIES}, None, 13, {}),
    "clip_attrs": ("Clip", {"x": _X}, None, 6, dict(min=-1.0, max=0.5)),
    "clip_min_attr_only": ("Clip", {"x": _X}, None, 6, dict(min=-0.25)),
    "clip_no_bounds": ("Clip", {"x": _X}, None, 13, {}),
    "clip_inputs": ("Clip", {"x": _X}, {"lo": _LO, "hi": _HI}, 13, {}),
    "clip_min_input_only": ("Clip", {"x": _X}, {"lo": _LO}, 13, {}),
    "unsqueeze_attr": ("Unsqueeze", {"x": _X}, None, 11, dict(axes=[0, 3])),
    "unsqueeze_input": ("Unsqueeze", {"x": _X},
                        {"ax": np.array([2], np.int64)}, 13, {}),
    "unsqueeze_negative": ("Unsqueeze", {"x": _X},
                           {"ax": np.array([-1, 1], np.int64)}, 13, {}),
    "expand_insert_dims": ("Expand", {"x": _X[:, :1]},
                           {"s": np.array([4, 2, 3, 8], np.int64)}, 13, {}),
    "expand_ones_keep": ("Expand", {"x": _X[:1]},
                         {"s": np.array([3, 1, 1], np.int64)}, 13, {}),
    "simplified_layer_norm": ("SimplifiedLayerNormalization", {"x": _X},
                              {"g": _RNG.standard_normal(8).astype(
                                  np.float32)}, 17,
                              dict(axis=-1, epsilon=1e-5)),
    "rms_norm_two_axes": ("RMSNormalization", {"x": _X},
                          {"g": _RNG.standard_normal((3, 8)).astype(
                              np.float32)}, 17, dict(axis=1, epsilon=1e-3)),
}


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    op, inputs, inits, opset, attrs = EMITTER_CASES[case]
    (want,) = run_op(op, inputs, inits, opset=opset, **attrs)
    (got,) = run_op_port(op, inputs, inits, opset=opset, **attrs)
    _same(got, want)
    if op in ("Round", "Floor", "Neg", "Clip"):  # exact operations
        np.testing.assert_array_equal(got, np.asarray(want))


def test_round_ties_go_to_even():
    (got,) = run_op_port("Round", {"x": _TIES[:1]})
    np.testing.assert_array_equal(
        got, np.array([[-4, -2, -2, -0, 0, 2, 2, 4]], np.float32))


def _run_both(model, feed):
    want = JEngine(j_import(model)).run(feed)
    got = Engine(to_port(model), device="cpu").run(feed)
    return got, want


def test_clip_max_input_only_matches_jax():
    """Clip with its min input omitted (an empty name) and max given."""
    m = make_model([node("Clip", ["x", "", "hi"], ["y"])], {"x": _X}, ["y"],
                   {"hi": _HI}, opset=13)
    got, want = _run_both(m, {"x": _X})
    np.testing.assert_array_equal(got["y"], np.asarray(want["y"]))
    assert got["y"].max() == _HI and got["y"].min() == _X.min()


@pytest.mark.parametrize("run_batch", [2, 5])
def test_expand_follows_the_runtime_batch_like_jax(run_batch):
    """An Expand target with the batch baked in: at the declared batch it
    is taken as it is; run at another batch, the leading dim follows the
    input (batch polymorphism), as in the JAX emitter."""
    x = _RNG.standard_normal((2, 1, 8)).astype(np.float32)
    m = make_model([node("Expand", ["x", "s"], ["y"])], {"x": x}, ["y"],
                   {"s": np.array([2, 3, 8], np.int64)}, opset=13)
    feed = {"x": _RNG.standard_normal((run_batch, 1, 8)).astype(np.float32)}
    got, want = _run_both(m, feed)
    assert got["y"].shape == (run_batch, 3, 8)
    np.testing.assert_array_equal(got["y"], np.asarray(want["y"]))


# --------------------------------------------------------------------------
# builders: graphs equal node for node, also after the int4 quantizer
# --------------------------------------------------------------------------
DECODE_VARIANTS = {
    "fp32": {},
    "int8": {"kv_dtype": "int8"},
    "int8_fused": {"kv_dtype": "int8", "fused_attention": True},
    "int4_kv": {"kv_dtype": "int4"},
    "chunk4": {"chunk": 4},
    "int4_kv_chunk4": {"kv_dtype": "int4", "chunk": 4},
}


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_prefill_graph_equals_jax(cfg):
    c = CONFIGS[cfg]
    jg = j_import(j_llama.build_llama(_jcfg(c), batch=2, seq_len=8))
    tg = import_model(build_llama(c, batch=2, seq_len=8))
    assert_graphs_equal(jg, tg)
    assert_graphs_equal(j_quantize_int4(jg), t_quant.quantize_weights_int4(tg))


@pytest.mark.parametrize("variant", list(DECODE_VARIANTS))
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_decode_graph_equals_jax(cfg, variant):
    c, kw = CONFIGS[cfg], DECODE_VARIANTS[variant]
    jg = j_import(j_llama.build_llama_decode(_jcfg(c), batch=2, max_len=16,
                                             **kw))
    tg = import_model(build_llama_decode(c, batch=2, max_len=16, **kw))
    assert_graphs_equal(jg, tg)
    jq, tq = j_quantize_int4(jg), t_quant.quantize_weights_int4(tg)
    assert_graphs_equal(jq, tq)  # packed bytes and scales bit-equal
    if cfg == "gqa_rep4_hd128":  # 7 MatMuls a layer and the lm_head
        assert sum(n.op_type == "MatMulNBits" for n in tq.nodes) == 7 * 2 + 1


def test_host_memo_shares_weights_and_packings():
    """Inside host_memo a second build of the same config and seed reuses
    the first one's arrays (and packings); the graphs equal a plain build."""
    plain = t_quant.quantize_weights_int4(import_model(
        build_llama_decode(GQA, batch=2, max_len=16)))
    with host_memo():
        a = import_model(build_llama(GQA, batch=1, seq_len=8))
        b = import_model(build_llama_decode(GQA, batch=2, max_len=16))
        qa = t_quant.quantize_weights_int4(a)
        qb = t_quant.quantize_weights_int4(b)
        other = import_model(build_llama(GQA, batch=1, seq_len=8, seed=1))
    assert b.constants["l0_wq_w"] is a.constants["l0_wq_w"]
    assert qb.constants["lm_head__w4"] is qa.constants["lm_head__w4"]
    assert not np.array_equal(other.constants["l0_wq_w"],
                              a.constants["l0_wq_w"])
    assert_graphs_equal(plain, qb)


def test_unported_and_invalid_options_raise():
    with pytest.raises(ValueError, match="int4 KV"):
        build_llama_decode(TINY, kv_dtype="int4", fused_attention=True)
    with pytest.raises(ValueError, match="fused_attention"):
        build_llama_decode(TINY, fused_attention=True)
    # the moe family is ported (test_torch_port_moe.py)
    assert decoder_family("moe")[2] is True
    # scan_layers takes neither fused attention, nor chunks, nor int4 KV
    for kw, match in (({"kv_dtype": "int8", "fused_attention": True},
                       "incompatible with fused_attention/chunk"),
                      ({"chunk": 2}, "incompatible with fused_attention/chunk"),
                      ({"kv_dtype": "int4"}, "int4 KV")):
        with pytest.raises(ValueError, match=match):
            build_llama_decode(TINY, scan_layers=True, **kw)


# --------------------------------------------------------------------------
# logits: the golden, prefill and decode steps against JAX
# --------------------------------------------------------------------------
def _golden_ids() -> np.ndarray:
    """The input test_regression_goldens.py::_cases draws for llama: its
    third draw of default_rng(123)."""
    rng = np.random.default_rng(123)
    rng.standard_normal((1, 3, 64, 64))
    rng.standard_normal((1, 3, 96, 96))
    return rng.integers(0, 128, (1, 8)).astype(np.int64) % TINY.vocab_size


def test_llama_golden():
    golden = j_io.read_tensor_file(GOLDEN).array
    got = Engine(import_model(build_llama(TINY, batch=1, seq_len=8,
                                          with_presents=False)),
                 device="cpu").run({"input_ids": _golden_ids()})["logits"]
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_prefill_logits_and_presents_match_jax(cfg):
    c = CONFIGS[cfg]
    feed = {"input_ids": np.random.default_rng(3).integers(
        0, c.vocab_size, (2, 8)).astype(np.int64)}
    model = j_llama.build_llama(_jcfg(c), batch=2, seq_len=8)
    got, want = _run_both(model, feed)
    for name, v in want.outputs.items():
        _same(got[name], v, rtol=1e-4, atol=1e-5)


def _decode_feed(c, kv, B=2, L=16, T=1, seed=4):
    rng = np.random.default_rng(seed)
    hkv, hd = c.n_kv_head, c.head_dim
    feed = {"input_ids": rng.integers(0, c.vocab_size, (B, T)).astype(
                np.int64),
            "pos": np.array([3, 9], np.int64)[:B]}
    for i in range(c.n_layer):
        for kind in ("key", "value"):
            if kv == "float32":
                feed[f"past_{kind}_{i}"] = rng.standard_normal(
                    (B, hkv, L, hd)).astype(np.float32)
                continue
            width = hd // 2 if kv == "int4" else hd
            lo = -128 if kv == "int4" else -127
            feed[f"past_{kind}_{i}"] = rng.integers(
                lo, 128, (B, hkv, L, width)).astype(np.int8)
            feed[f"kv_scale_{kind}_{i}"] = (
                rng.random(hkv) * 0.05 + 0.02).astype(np.float32)
    return feed


@pytest.mark.parametrize("variant", ["fp32", "int8", "int4_kv", "chunk4",
                                     "int4_kv_chunk4"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_decode_logits_and_presents_match_jax(cfg, variant):
    """One decode call on a random cache: logits within rtol 1e-4 / atol
    1e-5, and the updated quantized caches bit-equal."""
    c, kw = CONFIGS[cfg], DECODE_VARIANTS[variant]
    kv = kw.get("kv_dtype", "float32")
    model = j_llama.build_llama_decode(_jcfg(c), batch=2, max_len=16, **kw)
    got, want = _run_both(model, _decode_feed(c, kv, T=kw.get("chunk", 1)))
    _same(got["logits"], want["logits"], rtol=1e-4, atol=1e-5)
    for name, v in want.outputs.items():
        if name.startswith("present_") and kv != "float32":
            np.testing.assert_array_equal(got[name], np.asarray(v))
        else:
            _same(got[name], v, rtol=1e-4, atol=1e-5)


def test_fused_decode_matches_jax_fallback():
    """The fused GQA attention at rep 4, hd 128 against the JAX CPU path
    (its fp32 fallback scales K and V instead of q: 1e-4, rounding
    order)."""
    model = j_llama.build_llama_decode(_jcfg(GQA), batch=2, max_len=16,
                                       kv_dtype="int8", fused_attention=True)
    got, want = _run_both(model, _decode_feed(GQA, "int8"))
    _same(got["logits"], want["logits"], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# Generator and DecodeServer against JAX's
# --------------------------------------------------------------------------
def _prompts(c, B, P, seed=0):
    return np.random.default_rng(seed).integers(0, c.vocab_size, (B, P))


def _both_generate(c, B, P, n_new, max_len, **kw):
    """(JAX tokens, port tokens, max |logit difference|, max |logit|)."""
    ids = _prompts(c, B, P)
    jt, jl = JGenerator(_jcfg(c), batch=B, prompt_len=P, max_len=max_len,
                        family="llama", **kw).generate(
        ids, n_new, return_logits=True)
    tt, tl = Generator(c, batch=B, prompt_len=P, max_len=max_len,
                       family="llama", device="cpu", **kw).generate(
        ids, n_new, return_logits=True)
    err = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(jl, tl))
    return np.asarray(jt), tt, err, max(float(np.abs(b).max()) for b in tl)


# name -> (config, Generator kwargs, logit tolerance). Fused attention
# folds the scales into q where the JAX CPU fallback scales K and V: a
# 1e-6 difference that moves a later layer's int8 K/V by one step now and
# then, so its logits are held to 1e-3 (measured: 5.6e-4 on values up to
# 1.9), as tests/test_torch_port_gpt2.py holds its fused path
GENERATE_CASES = {
    "fp32_kv": (TINY, {}, 1e-4),
    "int8_kv": (TINY, {"kv_dtype": "int8"}, 1e-4),
    "int8_kv_fused": (TINY, {"kv_dtype": "int8", "fused_attention": True},
                      1e-3),
    "gqa_int8_kv_fused": (GQA, {"kv_dtype": "int8",
                                "fused_attention": True}, 1e-3),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generator_greedy_equals_jax(case):
    c, kw, tol = GENERATE_CASES[case]
    jt, tt, err, _ = _both_generate(c, 2, 8, 6, 32, **kw)
    np.testing.assert_array_equal(tt, jt)
    assert err <= tol


@pytest.mark.parametrize("fused", [False, True])
def test_generator_int4_weights_equals_jax_kernel_form(monkeypatch, fused):
    """INT4 planar weights + INT8 KV at the GQA config: the JAX side runs
    its Pallas int4 kernel in interpret mode (ORIET_KERNELS=pallas), the
    form the port implements. Both round A to bf16, so a 1e-7 difference
    upstream (RMSNorm's rsqrt, RoPE) moves an element of A by one bf16 step
    now and then: greedy tokens equal, logits within 1e-2 x max|logit|, the
    bound chip_smoke.py holds the card to (measured: 5.2e-3 on values up to
    1.8)."""
    monkeypatch.setenv("ORIET_KERNELS", "pallas")
    jt, tt, err, top = _both_generate(GQA, 2, 8, 4, 32, kv_dtype="int8",
                                      int4_weights=True,
                                      fused_attention=fused)
    np.testing.assert_array_equal(tt, jt)
    assert err <= 1e-2 * top


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "int8",
                                     "fused_attention": True}],
                         ids=["fp32_kv", "int8_kv_fused"])
def test_device_loop_equals_host_loop(kw):
    ids = _prompts(GQA, 2, 8)
    want, _ = Generator(GQA, batch=2, prompt_len=8, max_len=32,
                        family="llama", device="cpu", **kw).generate(ids, 9)
    got, _ = Generator(GQA, batch=2, prompt_len=8, max_len=32,
                       family="llama", device="cpu", device_loop=4,
                       **kw).generate(ids, 9)
    np.testing.assert_array_equal(got, want)


def _staggered(seed, n, plen, n_new):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, TINY.vocab_size, (int(rng.integers(*plen)),)
                          ).astype(np.int64), int(rng.integers(*n_new)))
            for _ in range(n)]


SERVER_CASES = {
    "staggered_fp32": (dict(slots=3, prompt_len=8, max_len=24),
                       _staggered(91, 5, (2, 9), (2, 7))),
    "int8_kv_buckets": (dict(slots=2, prompt_len=8, max_len=24,
                             kv_dtype="int8", prompt_buckets=(4, 8)),
                        _staggered(92, 4, (2, 9), (3, 7))),
    "multi_step3": (dict(slots=2, prompt_len=8, max_len=24, multi_step=3),
                    _staggered(93, 4, (2, 9), (2, 8))),
    "chunked_int8_multi2": (dict(slots=2, max_len=32, chunked_prefill=True,
                                 chunk=4, kv_dtype="int8", multi_step=2),
                            _staggered(94, 3, (3, 12), (3, 8))),
}


def _serve(port: bool, server_kw, reqs):
    if port:
        srv = DecodeServer(TINY, family="llama", device="cpu", **server_kw)
    else:
        srv = JDecodeServer(_jcfg(TINY), family="llama", **server_kw)
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        return [[int(t) for t in f.result(timeout=300)] for f in futs]
    finally:
        srv.stop()


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_decode_server_greedy_equals_jax(case):
    server_kw, reqs = SERVER_CASES[case]
    want = _serve(False, server_kw, reqs)
    got = _serve(True, server_kw, reqs)
    assert got == want
    assert [len(o) for o in got] == [n for _, n in reqs]
