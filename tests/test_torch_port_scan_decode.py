"""The port's scan-over-layers decode graphs (gpt2/llama `scan_layers=True`,
models/gpt2._build_gpt2_decode_scan, models/llama._build_llama_decode_scan),
the int4 quantizer over their Scan bodies (quant._int4_scan_body) and
Generator(scan_layers=True) against the JAX package, on the CPU.

- tests/test_scan_decode.py's six configurations (gpt2 and llama; fp32,
  INT8 KV, INT4 weights + INT8 KV): the port's scan Generator against
  JAX's scan Generator (greedy tokens equal; logits within rtol/atol 2e-4,
  that test's tolerance) and against the port's per-layer Generator
  (tokens and logits equal: both run the same emitters on the same
  shapes). The INT4 ones run at widths where JAX takes its Pallas int4
  kernel in interpret mode (ORIET_KERNELS=pallas, K >= 256), the form the
  port implements; both round A to bf16 there, so a 1e-7 difference
  upstream moves an element of A by one bf16 step now and then, and their
  logits are held within 1e-2 x max|logit|, the bound of
  test_torch_port_llama's int4 Generator test (measured: 2.8e-3 on logits
  up to 1.4 for gpt2, 6.1e-4 on logits up to 1.1 for llama);
- the graphs node for node (Scan bodies included) and, after
  quantize_weights_int4, the packed bytes and scales bit for bit;
- the stacked cache interface, device_loop=K with scan_layers, the
  quantizer leaving the caller's body alone, and host_memo sharing the
  draws and the int4 packings between the two forms.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models import llama as j_llama
from onnx_rusty_inference_engine_tpu.quant import (
    quantize_weights_int4 as j_quantize_int4)
from onnx_rusty_inference_engine_tpu_torch import quant as t_quant
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.models import gpt2, host_memo, llama
from torch_port_util import assert_graphs_equal

CONFIGS = [
    ("gpt2", {}),
    ("gpt2", {"kv_dtype": "int8"}),
    ("gpt2", {"kv_dtype": "int8", "int4_weights": True}),
    ("llama", {}),
    ("llama", {"kv_dtype": "int8"}),
    ("llama", {"kv_dtype": "int8", "int4_weights": True}),
]
IDS = [f"{f}-{'-'.join(k) or 'fp32'}" for f, k in CONFIGS]
P, N = 4, 6

PORT = {"gpt2": (gpt2, gpt2.TINY), "llama": (llama, llama.TINY)}
JAXM = {"gpt2": (j_gpt2, j_gpt2.TINY), "llama": (j_llama, j_llama.TINY)}
# the narrowest widths at which JAX's MatMulNBits takes its planar Pallas
# kernel (int4_planar_supported: K // 2 a multiple of 128)
KERNEL_FORM = {
    "gpt2": dict(vocab_size=512, n_positions=64, n_embd=256, n_layer=2,
                 n_head=4),
    "llama": dict(vocab_size=256, max_positions=64, dim=256, n_layer=2,
                  n_head=4, n_kv_head=2, ffn_mult=2)}


def _cfgs(family, int4):
    """(the port's config, JAX's) of a family: TINY, or the kernel-form
    widths for INT4 weights."""
    (tm, tcfg), (jm, jcfg) = PORT[family], JAXM[family]
    if not int4:
        return tcfg, jcfg
    cls = {"gpt2": "GPT2Config", "llama": "LlamaConfig"}[family]
    kw = KERNEL_FORM[family]
    return getattr(tm, cls)(**kw), getattr(jm, cls)(**kw)


def _ids(cfg, seed=11, B=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int64)


def _last(logits):
    return np.concatenate([np.asarray(l)[:, -1:] for l in logits], axis=1)


@pytest.mark.parametrize("family,kwargs", CONFIGS, ids=IDS)
def test_scan_decode_matches_jax_and_per_layer(monkeypatch, family, kwargs):
    monkeypatch.setenv("ORIET_KERNELS", "pallas")
    int4 = bool(kwargs.get("int4_weights"))
    cfg, jcfg = _cfgs(family, int4)
    ids = _ids(cfg)
    kw = dict(batch=2, prompt_len=P, max_len=P + N, family=family, **kwargs)
    jt, jl = JGenerator(jcfg, scan_layers=True, **kw).generate(
        ids, N, return_logits=True)
    tt, tl = Generator(cfg, scan_layers=True, device="cpu", **kw).generate(
        ids, N, return_logits=True)
    pt, pl = Generator(cfg, device="cpu", **kw).generate(
        ids, N, return_logits=True)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    if int4:
        top = float(np.abs(_last(jl)).max())
        assert float(np.abs(_last(tl) - _last(jl)).max()) <= 1e-2 * top
    else:
        np.testing.assert_allclose(_last(tl), _last(jl), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_array_equal(tt, pt)
    np.testing.assert_array_equal(_last(tl), _last(pl))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("int4", [False, True], ids=["fp32w", "int4w"])
def test_scan_graph_equals_jax(family, kv, int4):
    """The scan decode graph node for node, its Scan body included; after
    quantize_weights_int4, the stacked packed bytes and scales bit for
    bit, the body's MatMulNBits attributes, the new scan inputs."""
    (tm, _), (jm, _) = PORT[family], JAXM[family]
    tcfg, jcfg = _cfgs(family, int4)
    build = {"gpt2": "build_gpt2_decode", "llama": "build_llama_decode"}
    jg = j_import(getattr(jm, build[family])(
        jcfg, batch=2, max_len=16, kv_dtype=kv, scan_layers=True))
    tg = import_model(getattr(tm, build[family])(
        tcfg, batch=2, max_len=16, kv_dtype=kv, scan_layers=True))
    if int4:
        jg, tg = j_quantize_int4(jg), t_quant.quantize_weights_int4(tg)
        scan = next(n for n in tg.nodes if n.op_type == "Scan")
        body_ops = [n.op_type for n in scan.attrs["body"].nodes]
        n_mm = {"gpt2": 4, "llama": 7}[family]
        assert body_ops.count("MatMulNBits") == n_mm
        packed = [k for k in tg.weight_names if k.endswith("__w4")]
        assert len(packed) == n_mm + 1  # + the lm head
        for k in packed:
            assert tg.constants[k].shape[-2] % 256 == 0  # N padded as JAX
    assert_graphs_equal(jg, tg)


def test_scan_step_equals_per_layer_step():
    """One decode step of the scan graph equals the per-layer graph's on
    the same feed: the stacked cache holds the per-layer caches."""
    cfg = gpt2.TINY
    B, L = 2, 12
    rng = np.random.default_rng(3)
    scan = Engine(import_model(gpt2.build_gpt2_decode(
        cfg, batch=B, max_len=L, kv_dtype="int8", scan_layers=True)),
        device="cpu")
    per = Engine(import_model(gpt2.build_gpt2_decode(
        cfg, batch=B, max_len=L, kv_dtype="int8")), device="cpu")
    H, hd, NL = cfg.n_head, cfg.head_dim, cfg.n_layer
    ids = rng.integers(0, cfg.vocab_size, (B, 1))
    pos = np.array([3, 5])
    pk = rng.integers(-127, 128, (NL, B, H, L, hd)).astype(np.int8)
    pv = rng.integers(-127, 128, (NL, B, H, L, hd)).astype(np.int8)
    sk = rng.uniform(0.01, 0.05, (NL, H)).astype(np.float32)
    sv = rng.uniform(0.01, 0.05, (NL, H)).astype(np.float32)
    a = scan({"input_ids": ids, "pos": pos, "past_key": pk,
              "past_value": pv, "kv_scale_key": sk, "kv_scale_value": sv})
    feed = {"input_ids": ids, "pos": pos}
    for i in range(NL):
        feed.update({f"past_key_{i}": pk[i], f"past_value_{i}": pv[i],
                     f"kv_scale_key_{i}": sk[i],
                     f"kv_scale_value_{i}": sv[i]})
    b = per(feed)
    np.testing.assert_array_equal(a["logits"].numpy(), b["logits"].numpy())
    for i in range(NL):
        np.testing.assert_array_equal(a["present_key"][i].numpy(),
                                      b[f"present_key_{i}"].numpy())
        np.testing.assert_array_equal(a["present_value"][i].numpy(),
                                      b[f"present_value_{i}"].numpy())


def test_scan_decode_stacked_cache_interface():
    """The scan graph's stacked cache I/O contract: past_/present_
    [n_layer, B, H, max_len, hd] int8, kv_scale_ [n_layer, H]; the
    Generator's cache and scales take that form."""
    cfg = gpt2.TINY
    gen = Generator(cfg, batch=1, prompt_len=2, max_len=8, family="gpt2",
                    scan_layers=True, kv_dtype="int8", device="cpu")
    NL, H, hd = cfg.n_layer, cfg.n_head, cfg.head_dim
    specs = {s.name: (tuple(s.shape), np.dtype(s.dtype))
             for s in gen.decode.graph.inputs}
    assert specs["past_key"] == ((NL, 1, H, 8, hd), np.dtype(np.int8))
    assert specs["past_value"] == ((NL, 1, H, 8, hd), np.dtype(np.int8))
    assert specs["kv_scale_key"] == ((NL, H), np.dtype(np.float32))
    assert gen.decode.graph.outputs == ["logits", "present_key",
                                        "present_value"]
    ids = _ids(cfg, B=1)[:, :2]
    logits, cache = gen.start(ids)
    assert sorted(cache) == ["past_key", "past_value"]
    assert cache["past_key"].shape == (NL, 1, H, 8, hd)
    assert cache["past_key"].dtype == torch.int8
    assert sorted(gen._kv_scales) == ["kv_scale_key", "kv_scale_value"]
    assert gen._kv_scales["kv_scale_key"].shape == (NL, H)
    step_logits, cache2 = gen.step(cache, logits[:, -1].argmax(-1), 2)
    assert step_logits.shape == (1, 1, cfg.vocab_size)
    assert cache2["past_key"].shape == (NL, 1, H, 8, hd)
    toks, _ = gen.generate(ids, 3)
    assert toks.shape == (1, 3)


@pytest.mark.parametrize("family,kwargs", [CONFIGS[1], CONFIGS[5]],
                         ids=[IDS[1], IDS[5]])
def test_device_loop_with_scan_layers(family, kwargs):
    """device_loop=K over the stacked cache: the tokens of the host loop,
    greedy and seeded sampling, K not dividing the steps."""
    cfg = PORT[family][1]
    ids = _ids(cfg)
    gen = Generator(cfg, batch=2, prompt_len=P, max_len=P + 8,
                    family=family, scan_layers=True, device="cpu", **kwargs)
    want, _ = gen.generate(ids, 8)
    samp = dict(temperature=0.8, top_k=20, sample_seed=2)
    want_s, _ = gen.generate(ids, 8, **samp)
    gen.device_loop = 3
    got, _ = gen.generate(ids, 8)
    got_s, _ = gen.generate(ids, 8, **samp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_s, want_s)


def test_int4_scan_quantizer_leaves_the_callers_body():
    g = import_model(gpt2.build_gpt2_decode(gpt2.TINY, batch=2, max_len=16,
                                            kv_dtype="int8",
                                            scan_layers=True))
    scan = next(n for n in g.nodes if n.op_type == "Scan")
    body = scan.attrs["body"]
    before = ([n.op_type for n in body.nodes], [v.name for v in body.inputs],
              list(scan.inputs))
    q = t_quant.quantize_weights_int4(g)
    after = ([n.op_type for n in body.nodes], [v.name for v in body.inputs],
             list(scan.inputs))
    assert after == before and "MatMulNBits" not in before[0]
    qscan = next(n for n in q.nodes if n.op_type == "Scan")
    assert qscan.attrs["body"] is not body
    assert int(qscan.attrs["num_scan_inputs"]) == int(
        scan.attrs["num_scan_inputs"]) + 4
    # the fp32 graph still runs, and equals the quantized one's shapes
    feed = {"input_ids": np.zeros((2, 1), np.int64),
            "pos": np.array([0, 1]),
            "past_key": np.zeros((2, 2, 4, 16, 16), np.int8),
            "past_value": np.zeros((2, 2, 4, 16, 16), np.int8),
            "kv_scale_key": np.full((2, 4), 0.1, np.float32),
            "kv_scale_value": np.full((2, 4), 0.1, np.float32)}
    a = Engine(g, device="cpu")(feed)
    b = Engine(q, device="cpu")(feed)
    assert a["logits"].shape == b["logits"].shape


def test_host_memo_shares_draws_and_packings(monkeypatch):
    """Inside host_memo the scan graph stacks the per-layer graph's very
    arrays, and each layer is int4-packed once for both forms."""
    calls = []
    real = t_quant.pack_int4_planar
    monkeypatch.setattr(t_quant, "pack_int4_planar",
                        lambda w, bs: calls.append(w.shape) or real(w, bs))
    cfg = _cfgs("llama", True)[0]
    with host_memo():
        per = import_model(llama.build_llama_decode(
            cfg, batch=2, max_len=16, kv_dtype="int8"))
        scan = import_model(llama.build_llama_decode(
            cfg, batch=2, max_len=16, kv_dtype="int8", scan_layers=True))
        qper = t_quant.quantize_weights_int4(per)
        n_per = len(calls)
        qscan = t_quant.quantize_weights_int4(scan)
        n_scan = len(calls) - n_per
        qscan2 = t_quant.quantize_weights_int4(import_model(
            llama.build_llama_decode(cfg, batch=2, max_len=16,
                                     kv_dtype="int8", scan_layers=True)))
    for i in range(cfg.n_layer):
        np.testing.assert_array_equal(scan.constants["stack_wq"][i],
                                      per.constants[f"l{i}_wq_w"])
        np.testing.assert_array_equal(
            qscan.constants["stack_wq__w4"][i],
            qper.constants[f"l{i}_wq_w__w4"])
    assert n_per == 7 * cfg.n_layer + 1
    assert n_scan == 0 and len(calls) == n_per  # no layer packed twice
    assert qscan2.constants["stack_wd__w4"] is qscan.constants[
        "stack_wd__w4"]
