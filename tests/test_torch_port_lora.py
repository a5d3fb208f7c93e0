"""Multi-LoRA (onnx_rusty_inference_engine_tpu_torch/lora.py) through the
port on the CPU, against the JAX package.

- make_adapter_stack draws the JAX bank for the same seed, and attach_lora
  gives the JAX graph node for node and constant for constant (fp32 and
  int4 trunks).
- The cases of tests/test_lora.py (the pipeline one waits for the mesh):
  adapter 0 is bit-equal to the base, mixed adapters match the folded
  weights (atol 2e-5, rtol 1e-5, as tests/test_lora.py:59), the int4
  trunk, an unknown weight refused, Generator with adapter 0 equal to the
  plain run (also with device_loop), the served mixed batch equal to the
  isolated runs, `adapter` without a bank refused, the prompt cache keyed
  by adapter.
- Logits against the JAX Engine on TINY GPT-2 with a 2-adapter bank (atol
  2e-5, rtol 1e-5); greedy Generator and DecodeServer tokens equal to
  JAX's; tests/goldens/gpt2_lora.pb at rtol = atol = 1e-3.
- The JAX server attaches the bank before the int4 rewrite, which then
  quantizes a bank's stacked matrices once they reach 4,096 elements; the
  port's server attaches after it, as both Generators do, so its served
  rows equal the isolated Generator's.
"""

import os

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu import onnx_io as j_io
from onnx_rusty_inference_engine_tpu import lora as j_lora
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import import_model as j_import
from onnx_rusty_inference_engine_tpu.models.gpt2 import TINY as J_TINY
from onnx_rusty_inference_engine_tpu.models.gpt2 import (
    build_gpt2 as j_build_gpt2)
from onnx_rusty_inference_engine_tpu.quant import (
    quantize_weights_int4 as j_int4)
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer)
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.graph import import_model
from onnx_rusty_inference_engine_tpu_torch.lora import (
    attach_lora, fold_adapter, make_adapter_stack)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import (
    TINY, build_gpt2)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_weights_int4)
from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer
from torch_port_util import assert_graphs_equal

import test_regression_goldens as goldens

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "goldens")
ALPHA = 8.0
TARGETS = ("attn", "mlp")


def _graph(batch=3, seq=8):
    return import_model(build_gpt2(TINY, batch=batch, seq_len=seq,
                                   with_presents=False))


def _j_graph(batch=3, seq=8):
    return j_import(j_build_gpt2(J_TINY, batch=batch, seq_len=seq,
                                 with_presents=False))


def _bank(n=3, rank=4, seed=0):
    return make_adapter_stack(_graph(), n_adapters=n, rank=rank,
                              targets=TARGETS, seed=seed)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, shape).astype(np.int64)


def _run(graph, feed):
    return Engine(graph, device="cpu").run(feed).outputs["logits"]


# --------------------------------------------------------------------------
# the rewrite against JAX's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("int4", [False, True], ids=["fp32", "int4_trunk"])
def test_attach_gives_the_jax_graph(int4):
    bank = _bank(n=3, rank=4, seed=2)
    j_bank = j_lora.make_adapter_stack(_j_graph(), n_adapters=3, rank=4,
                                       targets=TARGETS, seed=2)
    assert sorted(bank) == sorted(j_bank)
    for k, (a, b) in bank.items():
        np.testing.assert_array_equal(a, j_bank[k][0])
        np.testing.assert_array_equal(b, j_bank[k][1])
    tg, jg = _graph(), _j_graph()
    if int4:
        tg, jg = (quantize_weights_int4(tg, min_elems=512),
                  j_int4(jg, min_elems=512))
    assert_graphs_equal(j_lora.attach_lora(jg, j_bank, alpha=ALPHA),
                        attach_lora(tg, bank, alpha=ALPHA))


def test_fold_adapter_gives_the_jax_weights():
    bank = _bank()
    j_bank = j_lora.make_adapter_stack(_j_graph(), n_adapters=3, rank=4,
                                       targets=TARGETS, seed=0)
    assert_graphs_equal(j_lora.fold_adapter(_j_graph(), j_bank, 2, ALPHA),
                        fold_adapter(_graph(), bank, 2, ALPHA))


def test_logits_match_jax_on_a_two_adapter_bank():
    g, jg = _graph(batch=2), _j_graph(batch=2)
    bank = make_adapter_stack(g, n_adapters=2, rank=4, targets=TARGETS,
                              seed=5)
    ids = _ids(3, (2, 8))
    feed = {"input_ids": ids, "lora_idx": np.array([1, 0], np.int64)}
    got = _run(attach_lora(g, bank, alpha=ALPHA), feed)
    want = np.asarray(JEngine(j_lora.attach_lora(
        jg, bank, alpha=ALPHA)).run(feed)["logits"])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_gpt2_lora_golden():
    (_, _, feed, out_name), = [c for c in goldens._cases()
                               if c[0] == "gpt2_lora"]
    g = import_model(build_gpt2(TINY, batch=1, seq_len=8,
                                with_presents=False))
    bank = make_adapter_stack(g, n_adapters=2, rank=4, targets=TARGETS,
                              seed=5)
    got = Engine(attach_lora(g, bank, alpha=8.0), device="cpu").run(
        feed).outputs[out_name]
    golden = j_io.read_tensor_file(os.path.join(GOLDEN_DIR,
                                                "gpt2_lora.pb")).array
    assert got.shape == golden.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# tests/test_lora.py's cases
# --------------------------------------------------------------------------
def test_zero_adapter_is_exactly_base():
    g = _graph()
    ids = _ids(11, (3, 8))
    base = _run(g, {"input_ids": ids})
    out = _run(attach_lora(g, _bank(), alpha=ALPHA),
               {"input_ids": ids, "lora_idx": np.zeros(3, np.int64)})
    np.testing.assert_array_equal(out, base)


def test_mixed_adapters_match_folded_weights():
    g = _graph()
    bank = _bank()
    ids = _ids(12, (3, 8))
    out = _run(attach_lora(g, bank, alpha=ALPHA),
               {"input_ids": ids, "lora_idx": np.arange(3)})
    for k in range(3):
        want = _run(fold_adapter(g, bank, k, alpha=ALPHA),
                    {"input_ids": ids})
        np.testing.assert_allclose(out[k], want[k], atol=2e-5, rtol=1e-5)


def test_attach_to_int4_trunk():
    g = _graph()
    q = quantize_weights_int4(g, min_elems=512)
    lq = attach_lora(q, _bank(), alpha=ALPHA)
    ids = _ids(13, (3, 8))
    base = _run(q, {"input_ids": ids})
    out0 = _run(lq, {"input_ids": ids, "lora_idx": np.zeros(3, np.int64)})
    np.testing.assert_array_equal(out0, base)
    out1 = _run(lq, {"input_ids": ids, "lora_idx": np.ones(3, np.int64)})
    assert np.abs(out1 - base).max() > 1e-4  # the delta is really applied


def test_unknown_weight_rejected():
    with pytest.raises(ValueError, match="no such weight"):
        attach_lora(_graph(), {"nope_w": (np.zeros((2, 4, 2), np.float32),
                                          np.zeros((2, 2, 4), np.float32))})


def test_generator_zero_adapter_matches_plain():
    bank = _bank()
    kw = dict(batch=2, prompt_len=4, max_len=12, device="cpu")
    ids = _ids(14, (2, 4))
    want, _ = Generator(TINY, **kw).generate(ids, 6)
    got, _ = Generator(TINY, lora_bank=bank, lora_alpha=ALPHA, adapter=0,
                       **kw).generate(ids, 6)
    np.testing.assert_array_equal(got, want)


def test_generator_device_loop_lora_parity():
    bank = _bank()
    kw = dict(batch=2, prompt_len=4, max_len=16, lora_bank=bank,
              lora_alpha=ALPHA, adapter=1, device="cpu")
    ids = _ids(15, (2, 4))
    want, _ = Generator(TINY, **kw).generate(ids, 8)
    got, _ = Generator(TINY, device_loop=4, **kw).generate(ids, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_dtype,adapter", [
    ("float32", [1, 2]), ("int8", 2)], ids=["fp32_rows", "int8_kv"])
def test_generator_tokens_equal_jax(kv_dtype, adapter):
    bank = _bank()
    kw = dict(batch=2, prompt_len=4, max_len=16, lora_bank=bank,
              lora_alpha=ALPHA, adapter=adapter, kv_dtype=kv_dtype)
    ids = _ids(16, (2, 4))
    want, _ = JGenerator(J_TINY, **kw).generate(ids, 8)
    got, _ = Generator(TINY, device="cpu", **kw).generate(ids, 8)
    np.testing.assert_array_equal(got, want)


def test_server_mixed_adapters_match_isolated():
    bank = _bank()
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, TINY.vocab_size, (5,)).astype(np.int64)
               for _ in range(3)]
    srv = DecodeServer(TINY, slots=3, prompt_len=6, max_len=20,
                       lora_bank=bank, lora_alpha=ALPHA, device="cpu")
    try:
        futs = [srv.submit(p, 5, adapter=k) for k, p in enumerate(prompts)]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        srv.stop()
    jsrv = JDecodeServer(J_TINY, slots=3, prompt_len=6, max_len=20,
                         lora_bank=bank, lora_alpha=ALPHA)
    try:
        jouts = [f.result(timeout=300) for f in [
            jsrv.submit(p, 5, adapter=k) for k, p in enumerate(prompts)]]
    finally:
        jsrv.stop()
    assert [list(map(int, o)) for o in outs] == \
        [list(map(int, o)) for o in jouts]
    for k, (p, got) in enumerate(zip(prompts, outs)):
        gen = Generator(TINY, batch=1, prompt_len=5, max_len=20,
                        lora_bank=bank, lora_alpha=ALPHA, adapter=k,
                        device="cpu")
        want, _ = gen.generate(p[None], 5)
        assert list(got) == list(want[0]), (k, got, list(want[0]))


def test_server_int4_small_bank_matches_jax_server():
    """A bank whose stacked matrices stay under 4,096 elements, on an int4
    trunk: the JAX server's int4 rewrite (after its attach) leaves them
    alone, so both servers run the same graph, and the port's served
    tokens are the JAX server's."""
    bank = _bank(n=3, rank=4, seed=5)
    assert max(a.size for ab in bank.values() for a in ab) < 4096
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, TINY.vocab_size, (5,)).astype(np.int64)
               for _ in range(3)]
    kw = dict(slots=3, prompt_len=6, max_len=20, lora_bank=bank,
              lora_alpha=ALPHA, int4_weights=True, kv_dtype="int8")
    srv = DecodeServer(TINY, device="cpu", **kw)
    try:
        outs = [f.result(timeout=300) for f in [
            srv.submit(p, 6, adapter=k) for k, p in enumerate(prompts)]]
        n4 = sum(n.op_type == "MatMulNBits" for n in srv.decode.graph.nodes)
    finally:
        srv.stop()
    jsrv = JDecodeServer(J_TINY, **kw)
    try:
        jouts = [f.result(timeout=300) for f in [
            jsrv.submit(p, 6, adapter=k) for k, p in enumerate(prompts)]]
        j4 = sum(n.op_type == "MatMulNBits"
                 for n in jsrv.decode.graph.nodes)
    finally:
        jsrv.stop()
    assert n4 == j4 == 4 * TINY.n_layer + 1
    assert [list(map(int, o)) for o in outs] == \
        [list(map(int, o)) for o in jouts]


@pytest.mark.parametrize("multi_step", [0, 3], ids=["step", "multi_step3"])
def test_server_int4_bank_rows_equal_isolated_generator(multi_step):
    """A bank whose stacked matrices reach 4,096 elements: the JAX
    server's int4 rewrite runs after the attach and takes them as int4
    MatMulNBits; the port's attaches after it, so the bank stays fp32 and
    each served row equals the isolated int4 Generator on its adapter."""
    bank = make_adapter_stack(_graph(), n_adapters=4, rank=16,
                              targets=TARGETS, seed=4, scale=0.1)
    # the JAX server's decode graph: two more int4 MatMuls per target
    jsrv = JDecodeServer(J_TINY, slots=2, prompt_len=6, max_len=20,
                         lora_bank=bank, lora_alpha=ALPHA,
                         int4_weights=True, autostart=False)
    srv = DecodeServer(TINY, slots=2, prompt_len=6, max_len=20,
                       lora_bank=bank, lora_alpha=ALPHA, int4_weights=True,
                       multi_step=multi_step, device="cpu")
    n4 = [sum(n.op_type == "MatMulNBits" for n in e.decode.graph.nodes)
          for e in (jsrv, srv)]
    jsrv.stop()
    assert n4 == [4 * TINY.n_layer + 1 + 2 * len(bank),
                  4 * TINY.n_layer + 1]
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, TINY.vocab_size, (5,)).astype(np.int64)
               for _ in range(2)]
    try:
        outs = [f.result(timeout=300) for f in [
            srv.submit(p, 6, adapter=k + 2) for k, p in enumerate(prompts)]]
    finally:
        srv.stop()
    for k, (p, got) in enumerate(zip(prompts, outs)):
        want, _ = Generator(TINY, batch=1, prompt_len=5, max_len=20,
                            lora_bank=bank, lora_alpha=ALPHA,
                            adapter=k + 2, int4_weights=True,
                            device="cpu").generate(p[None], 6)
        assert list(got) == list(want[0]), (k, got, list(want[0]))


def test_server_adapter_requires_bank():
    srv = DecodeServer(TINY, slots=2, prompt_len=4, max_len=12,
                       device="cpu")
    try:
        with pytest.raises(ValueError, match="lora_bank"):
            srv.submit(np.array([1, 2, 3]), 2, adapter=1)
    finally:
        srv.stop()


def test_prompt_cache_is_adapter_keyed():
    bank = make_adapter_stack(_graph(), n_adapters=3, rank=4,
                              targets=TARGETS, seed=3, scale=0.3)
    srv = DecodeServer(TINY, slots=2, prompt_len=6, max_len=20,
                       lora_bank=bank, lora_alpha=ALPHA, prompt_cache=8,
                       device="cpu")
    try:
        p = _ids(19, (5,))
        a1 = srv.submit(p, 4, adapter=1).result(timeout=300)
        a2 = srv.submit(p, 4, adapter=2).result(timeout=300)
        assert srv.prefix_hits == 0          # different adapters: no reuse
        a1b = srv.submit(p, 4, adapter=1).result(timeout=300)
        assert srv.prefix_hits == 1
        assert a1b == a1
        assert a1 != a2  # adapters change the generation
    finally:
        srv.stop()
