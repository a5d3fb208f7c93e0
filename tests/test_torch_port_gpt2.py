"""The PyTorch port's GPT-2 decode slice held against the JAX package on the
CPU: each emitter the GPT-2 graphs added, the builders and the int4
quantizer (graphs equal node for node, packed bytes and scales bit-equal),
and the port's Generator against JAX's Generator in fp32 and in INT4
weights + INT8 KV + fused attention. Every input comes from numpy with a
seed and goes to both packages."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.quant import (
    pack_int4 as j_pack_int4, pack_int4_planar as j_pack_planar,
    quantize_weights_int4 as j_quantize_int4)
from onnx_rusty_inference_engine_tpu_torch import quant as t_quant
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import (
    build_gpt2, build_gpt2_decode, decoder_family, host_memo)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
    UnsupportedOpError)
from torch_port_util import assert_graphs_equal, run_op_port
from util import run_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                  n_head=4)
# the int4 slice config: n_embd 256 gives the planar kernel's bs = 128
NARROW = GPT2Config(vocab_size=512, n_positions=64, n_embd=256, n_layer=2,
                    n_head=4)


def _jcfg(cfg):
    return j_gpt2.GPT2Config(**{k: getattr(cfg, k) for k in (
        "vocab_size", "n_positions", "n_embd", "n_layer", "n_head")})


# --------------------------------------------------------------------------
# emitters, each against the JAX emitter (rtol = atol = 1e-5)
# --------------------------------------------------------------------------
_RNG = np.random.default_rng(23)
_A = _RNG.standard_normal((2, 3, 4)).astype(np.float32)
_B = _RNG.standard_normal((3, 4)).astype(np.float32)
_POS = (np.abs(_RNG.standard_normal((3, 4))) + 0.5).astype(np.float32)
_I = _RNG.integers(-4, 5, (2, 3, 4)).astype(np.int64)
_J = _RNG.integers(-4, 5, (3, 4)).astype(np.int64)
_P = _RNG.random((2, 3, 4)) > 0.5
_Q = _RNG.random((3, 4)) > 0.5
_I32 = _RNG.integers(0, 64, (2, 3, 4)).astype(np.int32)
_M = _RNG.standard_normal((2, 3, 4, 5)).astype(np.float32)
_W = _RNG.standard_normal((2, 3, 5, 6)).astype(np.float32)
_X = (_RNG.standard_normal((2, 5, 16)) * 2).astype(np.float32)
_TABLE = _RNG.standard_normal((7, 3)).astype(np.float32)
# negative indices wrap; out-of-range ones clamp to the edge row
_IDX = np.array([[0, 6, -1], [-7, 9, -20]], np.int64)
_PACKED, _SCALES = j_pack_planar(
    _RNG.standard_normal((256, 130)).astype(np.float32), 256)


def _binary(op, a, b):
    return (op, {"a": a, "b": b}, None, 13, {})


# (op, inputs, initializers, opset, attrs)
EMITTER_CASES = {
    "add": _binary("Add", _A, _B),
    "add_int64": _binary("Add", _I, _J),
    "sub": _binary("Sub", _A, _B),
    "mul": _binary("Mul", _A, _B),
    "div": _binary("Div", _A, _POS),
    "pow": _binary("Pow", np.abs(_A) + 0.1, _B),
    "equal": _binary("Equal", _I, _J),
    "greater": _binary("Greater", _I, _J),
    "greater_or_equal": _binary("GreaterOrEqual", _I, _J),
    "less": _binary("Less", _I, _J),
    "less_or_equal": _binary("LessOrEqual", _I, _J),
    "and": _binary("And", _P, _Q),
    "or": _binary("Or", _P, _Q),
    "xor": _binary("Xor", _P, _Q),
    "bitwise_and": _binary("BitwiseAnd", _I32, _I32[::-1].copy()),
    "bitwise_or": _binary("BitwiseOr", _I32, _I32[::-1].copy()),
    "matmul_2d_weight": ("MatMul", {"a": _A}, {"w": _RNG.standard_normal(
        (4, 5)).astype(np.float32)}, 13, {}),
    "matmul_batched": ("MatMul", {"a": _M, "b": _W}, None, 13, {}),
    "gelu_tanh": ("Gelu", {"x": _X}, None, 20, dict(approximate="tanh")),
    "gelu_erf": ("Gelu", {"x": _X}, None, 20, {}),
    "where": ("Where", {"c": _Q, "a": _A, "b": _B}, None, 13, {}),
    "cast_f32_to_int32": ("Cast", {"x": _X * 3}, None, 13, dict(to=6)),
    "cast_bool_to_f32": ("Cast", {"x": _P}, None, 13, dict(to=1)),
    "cast_int64_to_int8": ("Cast", {"x": _I}, None, 13, dict(to=3)),
    "reshape_zero_and_infer": ("Reshape", {"x": _M}, {"s": np.array(
        [0, -1, 5], np.int64)}, 13, {}),
    "transpose_perm": ("Transpose", {"x": _M}, None, 13,
                       dict(perm=[0, 2, 1, 3])),
    "transpose_default": ("Transpose", {"x": _M}, None, 13, {}),
    "identity": ("Identity", {"x": _A}, None, 13, {}),
    "gather_axis0_wrap_clamp": ("Gather", {"t": _TABLE, "i": _IDX}, None, 13,
                                dict(axis=0)),
    "gather_axis1": ("Gather", {"x": _M, "i": np.array([-1, 2, 7], np.int64)},
                     None, 13, dict(axis=1)),
    "layer_norm_last_axis": ("LayerNormalization", {"x": _X},
                             {"g": _RNG.standard_normal(16).astype(
                                 np.float32),
                              "b": _RNG.standard_normal(16).astype(
                                  np.float32)}, 17,
                             dict(axis=-1, epsilon=1e-5)),
    "layer_norm_two_axes_no_bias": ("LayerNormalization", {"x": _X},
                                    {"g": _RNG.standard_normal(
                                        (5, 16)).astype(np.float32)}, 17,
                                    dict(axis=1, epsilon=1e-3)),
}


def _same(got, want, rtol=1e-5, atol=1e-5):
    assert got.shape == want.shape
    # the JAX package runs without x64: its int64 results come back int32
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    op, inputs, inits, opset, attrs = EMITTER_CASES[case]
    (want,) = run_op(op, inputs, inits, opset=opset, **attrs)
    (got,) = run_op_port(op, inputs, inits, opset=opset, **attrs)
    _same(got, want)


@pytest.mark.parametrize("opset,attr_split", [(17, True), (13, False)])
def test_split_matches_jax(opset, attr_split):
    """Split reads its `split` attribute even at opset 17, as the GPT-2
    builder writes it; without one, sizes come from the input (or equal
    parts)."""
    kw = dict(axis=-1, split=[4, 4, 8]) if attr_split else dict(axis=-1)
    inits = None if attr_split else {"s": np.array([2, 14], np.int64)}
    n = 3 if attr_split else 2
    want = run_op("Split", {"x": _X}, inits, opset=opset, n_outputs=n, **kw)
    got = run_op_port("Split", {"x": _X}, inits, opset=opset, n_outputs=n,
                      **kw)
    for g, w in zip(got, want):
        _same(g, w)


def test_matmul_nbits_planar_matches_jax_kernel_form(monkeypatch):
    """Planar MatMulNBits: the port's plain int4 version against JAX's
    Pallas kernel in interpret mode (ORIET_KERNELS=pallas): the products
    are exact, only the f32 summation order differs."""
    monkeypatch.setenv("ORIET_KERNELS", "pallas")
    a = np.random.default_rng(1).standard_normal((2, 3, 256)).astype(
        np.float32)
    inits = {"p": np.pad(_PACKED, ((0, 126), (0, 0))),
             "s": np.pad(_SCALES, ((0, 0), (0, 126)))}
    attrs = dict(domain="com.microsoft", K=256, N=130, bits=4,
                 layout="planar", block_size=128)
    (want,) = run_op("MatMulNBits", {"a": a}, inits, **attrs)
    (got,) = run_op_port("MatMulNBits", {"a": a}, inits, **attrs)
    _same(got, want)


def test_matmul_nbits_interleaved_raises():
    """The interleaved (ORT) layout runs on qmatmul_int4_bf16 in
    quant.pack_int4's 2-D form (tests/test_torch_port_qmatmul.py); ORT's
    3-D [N, blocks, blob] form and quant blocks that split a nibble pair
    still raise, naming the case."""
    rng = np.random.default_rng(2)
    packed, scales = j_pack_int4(
        rng.standard_normal((64, 8)).astype(np.float32), 32)
    a = {"a": rng.standard_normal((2, 64)).astype(np.float32)}
    attrs = dict(domain="com.microsoft", K=64, N=8, bits=4, block_size=32)
    with pytest.raises(UnsupportedOpError, match="3-D"):
        run_op_port("MatMulNBits", a,
                    {"p": packed.reshape(8, 2, 16), "s": scales}, **attrs)
    with pytest.raises(UnsupportedOpError, match="not an interleaved"):
        run_op_port("MatMulNBits", a,
                    {"p": packed, "s": np.ones((8, 64), np.float32)}, **attrs)


def _attention_inputs(B=2, H=4, Hkv=2, L=24, hd=16, valid=13, seed=5):
    rng = np.random.default_rng(seed)
    bias = np.where(np.arange(L) < valid, 0.0, -1e9).astype(np.float32)
    return {
        "q": rng.standard_normal((B, H, 1, hd)).astype(np.float32),
        "k8": rng.integers(-127, 128, (B, Hkv, L, hd), dtype=np.int8),
        "v8": rng.integers(-127, 128, (B, Hkv, L, hd), dtype=np.int8),
        "sk": (rng.random(Hkv) * 0.02 + 0.005).astype(np.float32),
        "sv": (rng.random(Hkv) * 0.02 + 0.005).astype(np.float32),
        "bias": np.broadcast_to(bias, (B, 1, 1, L)).copy(),
    }


@pytest.mark.parametrize("Hkv", [4, 2])
def test_fused_decode_attention_matches_jax_fallback(Hkv):
    """FusedDecodeAttention: the port folds the scales into q and the
    output as the JAX emitter's kernel path does; the JAX CPU path is its
    fp32 fallback, which scales K and V instead (1e-4: rounding order)."""
    feed = _attention_inputs(Hkv=Hkv)
    kw = dict(domain="com.oriet", scale=0.25)
    (want,) = run_op("FusedDecodeAttention", feed, **kw)
    (got,) = run_op_port("FusedDecodeAttention", feed, **kw)
    _same(got, want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# builders and the int4 quantizer: graphs equal node for node
# --------------------------------------------------------------------------
DECODE_VARIANTS = {
    "fp32": {},
    "int8": {"kv_dtype": "int8"},
    "int8_fused": {"kv_dtype": "int8", "fused_attention": True},
    "chunk4": {"chunk": 4},
}


def test_prefill_graph_equals_jax_with_int4():
    jg = j_import(j_gpt2.build_gpt2(_jcfg(TINY), batch=2, seq_len=8))
    tg = import_model(build_gpt2(TINY, batch=2, seq_len=8))
    assert_graphs_equal(jg, tg)
    assert_graphs_equal(j_quantize_int4(jg), t_quant.quantize_weights_int4(tg))


@pytest.mark.parametrize("variant", list(DECODE_VARIANTS))
def test_decode_graph_equals_jax_with_int4(variant):
    kw = DECODE_VARIANTS[variant]
    jg = j_import(j_gpt2.build_gpt2_decode(_jcfg(TINY), batch=2, max_len=16,
                                           **kw))
    tg = import_model(build_gpt2_decode(TINY, batch=2, max_len=16, **kw))
    assert_graphs_equal(jg, tg)
    jq, tq = j_quantize_int4(jg), t_quant.quantize_weights_int4(tg)
    assert_graphs_equal(jq, tq)  # packed bytes and scales bit-equal
    assert sum(n.op_type == "MatMulNBits" for n in tq.nodes) == 4 * 2 + 1


def test_host_memo_shares_weights_and_packings():
    """Inside host_memo the decode graph reuses the prefill graph's weight
    arrays, the lm_head's transpose and their int4 packings; each graph
    still equals JAX's (built without a memo), and another seed draws
    other weights."""
    jd = j_quantize_int4(j_import(j_gpt2.build_gpt2_decode(
        _jcfg(TINY), batch=2, max_len=16, kv_dtype="int8",
        fused_attention=True)))
    with host_memo():
        a = import_model(build_gpt2(TINY, batch=1, seq_len=8))
        b = import_model(build_gpt2_decode(TINY, batch=2, max_len=16,
                                           kv_dtype="int8",
                                           fused_attention=True))
        qa = t_quant.quantize_weights_int4(a)
        qb = t_quant.quantize_weights_int4(b)
        other = import_model(build_gpt2(TINY, batch=1, seq_len=8, seed=1))
    for name in ("wte", "wte_T", "blk1_mlp_proj_w"):
        assert b.constants[name] is a.constants[name]
    assert qb.constants["wte_T__w4"] is qa.constants["wte_T__w4"]
    assert not np.array_equal(other.constants["blk0_attn_qkv_w"],
                              a.constants["blk0_attn_qkv_w"])
    assert_graphs_equal(jd, qb)
    assert_graphs_equal(j_quantize_int4(j_import(j_gpt2.build_gpt2(
        _jcfg(TINY), batch=1, seq_len=8))), qa)


@pytest.mark.parametrize("K,N,block", [(768, 300, 256), (3072, 64, 256),
                                       (42, 33, 256), (256, 130, 64)])
def test_int4_packing_bit_equal(K, N, block):
    w = np.random.default_rng(K + N).standard_normal((K, N)).astype(
        np.float32)
    for j, t in ((j_pack_planar, t_quant.pack_int4_planar),
                 (j_pack_int4, t_quant.pack_int4)):
        (jp, js), (tp, ts) = j(w, block), t(w, block)
        assert jp.dtype == tp.dtype and js.dtype == ts.dtype
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ts, js)


def test_unported_options_raise():
    # the int4 KV cache, the llama family and the Scan graph are ported
    # (tests/test_torch_port_int4_kv.py, test_torch_port_llama.py,
    # test_torch_port_scan_decode.py), and so are moe and the LoRA bank
    # (test_torch_port_moe.py, test_torch_port_lora.py); the mesh options
    # still raise
    from onnx_rusty_inference_engine_tpu_torch.models import moe

    assert decoder_family("moe")[:2] == (moe.build_moe, moe.build_moe_decode)
    # scan_layers takes neither fused attention, nor chunks, nor int4 KV
    for kw, match in (({"kv_dtype": "int8", "fused_attention": True},
                       "incompatible with fused_attention/chunk"),
                      ({"chunk": 2}, "incompatible with fused_attention/chunk"),
                      ({"kv_dtype": "int4"}, "int4 KV")):
        with pytest.raises(ValueError, match=match):
            build_gpt2_decode(TINY, scan_layers=True, **kw)
    for kw, item in (({"mesh": object()}, "1.12"),
                     ({"pipeline_axis": "pipe"}, "1.12")):
        with pytest.raises(NotImplementedError, match=item):
            Generator(TINY, device="cpu", **kw)
    # the int4 KV cache of the moe family runs; an empty bank is refused
    # by attach_lora, as in JAX
    gen4 = Generator(moe.TINY, device="cpu", kv_dtype="int4", family="moe")
    assert gen4.decode.graph.inputs[2].dtype == np.int8
    with pytest.raises(ValueError, match="empty adapter bank"):
        Generator(TINY, device="cpu", lora_bank={})
    # prefill_dtype is ported: a bf16 prefill Engine on the W8A8 graph,
    # whose first tokens are JAX's (tests/test_torch_port_precision.py
    # holds the rest)
    gen = Generator(TINY, device="cpu", prefill_dtype="w8a8")
    assert gen.prefill.dtype == torch.bfloat16
    assert "MatMulInteger" in {n.op_type for n in gen.prefill.graph.nodes}
    prompt = np.arange(8, dtype=np.int64)[None] % TINY.vocab_size
    want, _ = JGenerator(_jcfg(TINY), prefill_dtype="w8a8").generate(
        prompt, 3)
    assert np.array_equal(gen.generate(prompt, 3)[0], want)


def test_generator_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(TINY)


def test_generate_imports_no_jax():
    code = (
        "import sys\n"
        "import onnx_rusty_inference_engine_tpu_torch.generate\n"
        "import onnx_rusty_inference_engine_tpu_torch.custom_decoder\n"
        "import onnx_rusty_inference_engine_tpu_torch.models.llama\n"
        "import onnx_rusty_inference_engine_tpu_torch.models.q4\n"
        "import onnx_rusty_inference_engine_tpu_torch.ops.kernels.decode_attn\n"
        "import onnx_rusty_inference_engine_tpu_torch.ops.kernels.qmatmul_int4\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',\n"
        "                                   'onnx_rusty_inference_engine_tpu'))\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# the slice: port Generator against JAX Generator
# --------------------------------------------------------------------------
def _prompts(cfg, B, P, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P))


def _both(cfg, B, P, n_new, max_len, gen_kw=None, **kw):
    ids = _prompts(cfg, B, P)
    gen_kw = dict(return_logits=True, **(gen_kw or {}))
    jt, jl = JGenerator(_jcfg(cfg), batch=B, prompt_len=P, max_len=max_len,
                        **kw).generate(ids, n_new, **gen_kw)
    tt, tl = Generator(cfg, batch=B, prompt_len=P, max_len=max_len,
                       device="cpu", **kw).generate(ids, n_new, **gen_kw)
    return (np.asarray(jt), jl), (tt, tl)


def _max_err(a_list, b_list):
    assert len(a_list) == len(b_list)
    return max(float(np.abs(np.asarray(a) - b).max())
               for a, b in zip(a_list, b_list))


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_generator_tiny_matches_jax(kv):
    """fp32 weights at TINY, fp32 or INT8 (unfused QDQ) KV: greedy tokens
    equal, logits within 1e-4 (tests/test_gpt2.py's tolerance)."""
    (jt, jl), (tt, tl) = _both(TINY, 2, 8, 6, 32, kv_dtype=kv)
    np.testing.assert_array_equal(tt, jt)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_generator_int4_int8kv_matches_jax_kernel_form(monkeypatch, fused):
    """INT4 planar weights + INT8 KV (+ fused attention) at n_embd 256. The
    JAX side runs its Pallas int4 kernel in interpret mode
    (ORIET_KERNELS=pallas), the form the port implements; its attention
    runs the fp32 fallback the port's f32 kernel follows. Greedy tokens
    equal, logits within 1e-3 (measured: max 1.2e-7 on values up to 1.5)."""
    monkeypatch.setenv("ORIET_KERNELS", "pallas")
    (jt, jl), (tt, tl) = _both(NARROW, 2, 8, 4, 32, kv_dtype="int8",
                               int4_weights=True, fused_attention=fused)
    np.testing.assert_array_equal(tt, jt)
    assert _max_err(jl, tl) <= 1e-3


def test_generator_eos_and_repetition_penalty_match_jax():
    """Greedy with an eos id (rows freeze on it) and a CTRL repetition
    penalty: deterministic, so tokens equal JAX's."""
    pen = {"repetition_penalty": 1.3}
    (jt, _), (tt, _) = _both(TINY, 2, 8, 8, 32, gen_kw=pen)
    np.testing.assert_array_equal(tt, jt)
    eos = int(tt[0, 2])
    (jt, _), (tt, _) = _both(TINY, 2, 8, 8, 32, gen_kw=dict(eos_id=eos, **pen))
    np.testing.assert_array_equal(tt, jt)
    first = int(np.argmax(tt[0] == eos))
    assert first <= 2 and (tt[0, first:] == eos).all()


def test_sampling_is_seeded_and_filters_collapse_to_greedy():
    """temperature > 0 samples from a torch.Generator seeded by
    sample_seed (the same seed gives the same tokens); filters that keep
    only the top token (top_k=1, a tiny top_p, min_p=1) give greedy's."""
    ids = _prompts(TINY, 2, 8)
    g = Generator(TINY, batch=2, prompt_len=8, max_len=32, device="cpu",
                  kv_dtype="int8")
    greedy, _ = g.generate(ids, 6)
    a, _ = g.generate(ids, 6, temperature=1.0, sample_seed=3)
    b, _ = g.generate(ids, 6, temperature=1.0, sample_seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < TINY.vocab_size
    for kw in ({"top_k": 1}, {"top_p": 1e-6}, {"min_p": 1.0},
               {"top_k": 5, "top_p": 1e-6, "min_p": 0.5,
                "repetition_penalty": 1.0}):
        got, _ = g.generate(ids, 6, temperature=0.7, sample_seed=1, **kw)
        np.testing.assert_array_equal(got, greedy)


def test_teacher_forced_steps_equal_generate():
    """start/step with the tokens generate chose reproduce generate's
    logits exactly (chip_smoke.py re-runs the card's tokens this way), and
    a copy on another device keeps the calibrated KV scales."""
    ids = _prompts(NARROW, 2, 8)
    g = Generator(NARROW, batch=2, prompt_len=8, max_len=32, device="cpu",
                  kv_dtype="int8", int4_weights=True, fused_attention=True)
    toks, logits = g.generate(ids, 4, return_logits=True)
    h = g.to("cpu")
    assert h._kv_scales is not None and h.decode is not g.decode
    first, cache = h.start(ids)
    np.testing.assert_array_equal(first.numpy(), logits[0])
    for t in range(3):
        step, cache = h.step(cache, torch.from_numpy(toks[:, t]), 8 + t)
        np.testing.assert_array_equal(step.numpy(), logits[t + 1])
