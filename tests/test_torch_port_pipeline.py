"""The port's pipeline parallelism (parallel/pipeline.py) held against the
JAX package's on the CPU.

- Graph surgery, in-process: `infer_boundaries`, `split_stages` and
  `align_blocks` give JAX's boundaries, stage node lists and stacked
  arrays on GPT-2, Llama and the MoE, under the repo's names and under
  foreign ones (structural inference); every PipelineError case of
  tests/test_pipeline.py raises in the port too.
- `PipelinedDecoder` on {pipe: 2}, one gloo process a stage
  (tests/torch_parallel_worker.py): prefill and decode (fp32 and INT8 KV),
  two device-resident steps through `stacked_call`, declared batch_inputs;
  each rank holds only its stage's rows. Held to JAX's PipelinedDecoder
  on the 8-virtual-device CPU mesh and to the port's Engine at
  test_pipeline.py's tolerance (atol 2e-5, rtol 1e-5).
- `Generator(pipeline_axis="pipe")`, host loop and device_loop=4, fp32
  and INT8 KV, and with a LoRA bank: tokens equal JAX's pipelined
  Generator's (tests/test_lora.py:159-183) exactly.
"""

import os
import types

import numpy as np
import pytest

from onnx_rusty_inference_engine_tpu.custom_decoder import \
    rename_tensors as j_rename
from onnx_rusty_inference_engine_tpu.engine import Engine as JEngine
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.graph import (
    export_model as j_export, import_model as j_import)
from onnx_rusty_inference_engine_tpu.lora import make_adapter_stack
from onnx_rusty_inference_engine_tpu.models.gpt2 import (
    GPT2Config, TINY, build_gpt2, build_gpt2_decode)
from onnx_rusty_inference_engine_tpu.models.llama import (
    LlamaConfig, build_llama_decode)
from onnx_rusty_inference_engine_tpu.models.moe import (
    MoEConfig, build_moe_decode)
from onnx_rusty_inference_engine_tpu.models import build_squeezenet
from onnx_rusty_inference_engine_tpu.parallel import make_mesh as j_mesh
from onnx_rusty_inference_engine_tpu.parallel import pipeline as jp
from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.parallel import make_mesh
from onnx_rusty_inference_engine_tpu_torch.parallel import pipeline as tp
from torch_parallel_worker import result, run_ranks
from torch_port_util import to_port

CFG4 = GPT2Config(vocab_size=128, n_positions=32, n_embd=48, n_layer=4,
                  n_head=4)
LLAMA = LlamaConfig(vocab_size=64, dim=32, n_layer=4, n_head=2, n_kv_head=2)
MOE = MoEConfig(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                n_head=2, n_expert=4)
TOL = dict(atol=2e-5, rtol=1e-5)  # tests/test_pipeline.py's
ALPHA = 8.0


def _ids(batch=8, seq=16, seed=0, vocab=128):
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, seq)).astype(np.int64)


def _decode_feed(cfg, batch, max_len, kv, seed=0):
    """tests/test_pipeline.py's decode feed."""
    rng = np.random.default_rng(seed)
    H, hd = cfg.n_head, cfg.head_dim
    feed = {"input_ids": rng.integers(0, cfg.vocab_size,
                                      (batch, 1)).astype(np.int64),
            "pos": rng.integers(0, max_len // 2, (batch,)).astype(np.int64)}
    for i in range(cfg.n_layer):
        for kind in ("key", "value"):
            if kv == "int8":
                feed[f"past_{kind}_{i}"] = rng.integers(
                    -127, 127, (batch, H, max_len, hd)).astype(np.int8)
                feed[f"kv_scale_{kind}_{i}"] = np.full((H,), 0.02,
                                                       np.float32)
            else:
                feed[f"past_{kind}_{i}"] = rng.standard_normal(
                    (batch, H, max_len, hd)).astype(np.float32)
    return feed


def _foreign(model):
    """The graph with every tensor renamed to an opaque name."""
    g = j_import(model)
    names = set(g.input_names) | set(g.outputs) | set(g.constants)
    for n in g.nodes:
        names.update(x for x in list(n.inputs) + list(n.outputs) if x)
    mapping = {nm: f"t_{i:04d}" for i, nm in enumerate(sorted(names))}
    return j_rename(g, mapping)


MODELS = {
    "gpt2": lambda: build_gpt2(CFG4, batch=8, seq_len=16),
    "gpt2_decode_int8": lambda: build_gpt2_decode(CFG4, batch=8, max_len=16,
                                                  kv_dtype="int8"),
    "llama_decode": lambda: build_llama_decode(LLAMA, batch=4, max_len=16),
    "moe_decode": lambda: build_moe_decode(MOE, batch=4, max_len=8),
}


# -------------------------------------------------------------------------
# graph surgery, in-process
# -------------------------------------------------------------------------
def _names(g):
    return [n.outputs[0] for n in g.nodes]


@pytest.mark.parametrize("which", list(MODELS) + ["gpt2_foreign"])
def test_surgery_equals_jax(which):
    """The same graph cut by both packages: the same boundaries (named, or
    found structurally under foreign names), the same prefix / block /
    suffix node lists, shared tensors and extra outputs, the same stacked
    per-layer arrays and layer-input correspondence."""
    if which == "gpt2_foreign":
        jg = _foreign(MODELS["gpt2"]())
        tg = to_port(j_export(jg))
    else:
        m = MODELS[which]()
        jg = j_import(m)
        tg = to_port(m)
    jb, tb = jp.infer_boundaries(jg), tp.infer_boundaries(tg)
    assert tb == jb
    if which == "gpt2_foreign":
        assert not tb[1].startswith("blk")
    jplan, tplan = jp.split_stages(jg, jb), tp.split_stages(tg, tb)
    assert tplan.shared == jplan.shared
    assert tplan.block_outputs == jplan.block_outputs
    assert _names(tplan.prefix) == _names(jplan.prefix)
    assert _names(tplan.suffix) == _names(jplan.suffix)
    assert [_names(b) for b in tplan.blocks] == [_names(b)
                                                 for b in jplan.blocks]
    ja, ta = jp.align_blocks(jplan), tp.align_blocks(tplan)
    assert ta.layer_inputs == ja.layer_inputs
    assert ta.shared_inputs == ja.shared_inputs
    assert ta.extra_outputs == ja.extra_outputs
    assert sorted(ta.stacked) == sorted(ja.stacked) and ta.stacked
    for k, v in ja.stacked.items():
        np.testing.assert_array_equal(ta.stacked[k], v, err_msg=k)
    assert sorted(ta.canonical.constants) == sorted(ja.canonical.constants)


def _stand_in(pipe: int):
    """A mesh's dims and sizes: what PipelinedDecoder reads before it
    touches a process group (where every PipelineError is raised)."""
    return types.SimpleNamespace(mesh_dim_names=("pipe",), shape=(pipe,),
                                 device_type="cpu")


def _g4():
    return to_port(build_gpt2(CFG4, batch=8, seq_len=16,
                              with_presents=False))


@pytest.mark.parametrize("case", [
    "indivisible", "non_transformer", "bad_microbatch", "batch_inputs",
    "structural_nonrepeating", "no_pipe_axis"])
def test_pipeline_errors_raise_as_in_jax(case):
    """tests/test_pipeline.py's refusals, each with JAX's message."""
    P = tp.PipelinedDecoder
    if case == "indivisible":
        with pytest.raises(tp.PipelineError, match="divide"):
            P(_g4(), _stand_in(3), device="cpu")
    elif case == "non_transformer":
        with pytest.raises(tp.PipelineError, match="boundaries"):
            P(to_port(build_squeezenet()), _stand_in(4), device="cpu")
    elif case == "bad_microbatch":
        pd = P(_g4(), make_mesh({"pipe": 1}, device="cpu"), microbatches=3,
               device="cpu")
        with pytest.raises(tp.PipelineError, match="microbatches"):
            pd({"input_ids": _ids()})
    elif case == "batch_inputs":
        with pytest.raises(tp.PipelineError, match="batch_inputs"):
            P(_g4(), _stand_in(4), batch_inputs=["input_ids", "nope"],
              device="cpu")
    elif case == "structural_nonrepeating":
        g = to_port(build_squeezenet())
        with pytest.raises(tp.PipelineError):
            bnds = tp.infer_boundaries_structural(g)
            P(g, _stand_in(4), boundaries=bnds, device="cpu")
    else:
        with pytest.raises(tp.PipelineError, match="no 'pipe' axis"):
            P(_g4(), types.SimpleNamespace(
                mesh_dim_names=("data",), shape=(2,), device_type="cpu"),
              device="cpu")


# -------------------------------------------------------------------------
# PipelinedDecoder and Generator on two stages
# -------------------------------------------------------------------------
def _bank():
    g = j_import(build_gpt2(TINY, batch=3, seq_len=8, with_presents=False))
    return make_adapter_stack(g, n_adapters=3, rank=4,
                              targets=("attn", "mlp"), seed=0)


GEN = dict(batch=4, prompt_len=4, max_len=12)
LORA_GEN = dict(batch=2, prompt_len=4, max_len=16, lora_alpha=ALPHA,
                adapter=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipeline"))
    save = lambda n, m: onnx_io.save_model(os.path.join(d, n), m)  # noqa
    save("prefill.onnx", build_gpt2(CFG4, batch=8, seq_len=16))
    np.savez(os.path.join(d, "ids.npz"), input_ids=_ids())
    cases = [dict(name="prefill", kind="pipeline", mesh={"pipe": 2},
                  model="prefill.onnx", feed="ids.npz")]
    for kv in ("float32", "int8"):
        save(f"dec_{kv}.onnx", build_gpt2_decode(CFG4, batch=8, max_len=16,
                                                 kv_dtype=kv))
        np.savez(os.path.join(d, f"dec_{kv}.npz"),
                 **_decode_feed(CFG4, 8, 16, kv))
        cases.append(dict(name=f"decode_{kv}", kind="pipeline",
                          mesh={"pipe": 2}, model=f"dec_{kv}.onnx",
                          feed=f"dec_{kv}.npz", roundtrip=kv == "float32"))
    # n_head == batch == the kv_scale dim: declared batch_inputs decide
    small = GPT2Config(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                       n_head=2)
    g = build_gpt2_decode(small, batch=2, max_len=16, kv_dtype="int8")
    save("coincide.onnx", g)
    feed = _decode_feed(small, 2, 16, "int8", seed=3)
    np.savez(os.path.join(d, "coincide.npz"), **feed)
    cases.append(dict(
        name="batch_inputs", kind="pipeline", mesh={"pipe": 2},
        model="coincide.onnx", feed="coincide.npz", microbatches=2,
        batch_inputs=[s for s in ("input_ids", "pos")] + [
            f"past_{k}_{i}" for i in range(2) for k in ("key", "value")]))
    np.savez(os.path.join(d, "gen_ids.npz"),
             input_ids=_ids(batch=4, seq=4, vocab=TINY.vocab_size))
    for kv in ("float32", "int8"):
        for dl in (0, 4):
            cases.append(dict(name=f"gen_{kv}_{dl}", kind="generator",
                              mesh={"pipe": 2}, feed="gen_ids.npz", n_new=6,
                              kw=dict(GEN, kv_dtype=kv, device_loop=dl,
                                      pipeline_axis="pipe")))
    bank = _bank()
    np.savez(os.path.join(d, "bank.npz"),
             **{f"A:{k}": a for k, (a, _) in bank.items()},
             **{f"B:{k}": b for k, (_, b) in bank.items()})
    np.savez(os.path.join(d, "lora_ids.npz"),
             input_ids=_ids(batch=2, seq=4, seed=5, vocab=TINY.vocab_size))
    for dl in (0, 4):
        cases.append(dict(name=f"lora_{dl}", kind="generator",
                          mesh={"pipe": 2}, feed="lora_ids.npz", n_new=8,
                          lora="bank.npz",
                          kw=dict(LORA_GEN, device_loop=dl,
                                  pipeline_axis="pipe")))
    ranks = run_ranks(2, cases, d)
    assert all(rc == 0 for _, rc, _ in ranks), ranks
    return d


def _jax_pipe(model, feed, **kw):
    g = j_import(model)
    pd = jp.PipelinedDecoder(g, j_mesh({"pipe": 2}), **kw)
    return {k: np.asarray(v, np.float32) for k, v in pd(dict(feed)).items()}


def test_prefill_pipeline_equals_jax(runs):
    """GPT-2 prefill with its presents, 4 layers over 2 stages: logits and
    every present equal JAX's pipeline and the port's Engine; each rank
    holds its two layers' rows of every stacked weight."""
    got = result(runs, "prefill")
    m = build_gpt2(CFG4, batch=8, seq_len=16)
    want = _jax_pipe(m, {"input_ids": _ids()})
    mine = Engine(to_port(m), device="cpu")({"input_ids": _ids()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        np.testing.assert_allclose(got[k], mine[k].numpy(), **TOL,
                                   err_msg=k)
    for r in range(2):
        own = result(runs, "prefill", r)
        assert tuple(own["rows"]) == (2 * r, 2 * r + 2)
        assert tuple(own["shape:blk0_mlp_fc_w"]) == (2, 48, 192)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_decode_pipeline_equals_jax(runs, kv):
    """A decode step with the per-layer caches (and INT8 scales) stacked
    per stage: every output equals JAX's pipeline and the port's Engine;
    fp32 also runs two steps through stacked_call, the second from the
    first's presents, which never leave their stage."""
    got = result(runs, f"decode_{kv}")
    m = build_gpt2_decode(CFG4, batch=8, max_len=16, kv_dtype=kv)
    feed = _decode_feed(CFG4, 8, 16, kv)
    want = _jax_pipe(m, feed)
    mine = Engine(to_port(m), device="cpu")(dict(feed))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        np.testing.assert_allclose(got[k], mine[k].numpy().astype(
            np.float32), **TOL, err_msg=k)
    if kv != "float32":
        return
    eng = Engine(to_port(m), device="cpu")
    r1 = eng(dict(feed))
    feed2 = {"input_ids": feed["input_ids"] + 1, "pos": feed["pos"] + 1}
    for i in range(CFG4.n_layer):
        for k in ("key", "value"):
            feed2[f"past_{k}_{i}"] = r1[f"present_{k}_{i}"]
    r2 = eng(feed2)
    np.testing.assert_allclose(got["step2:logits"], r2["logits"].numpy(),
                               **TOL)
    for s in range(2):
        own = result(runs, "decode_float32", s)
        for k in ("key", "value"):
            rows = own[f"step2:present_{k}"]
            assert rows.shape[0] == 2  # this stage's two layers only
            for j in range(2):
                np.testing.assert_allclose(
                    rows[j], r2[f"present_{k}_{2 * s + j}"].numpy(), **TOL)


def test_declared_batch_inputs_beat_shape_coincidence(runs):
    """n_head == batch == 2: the kv_scale [H] inputs are not microbatched
    once batch_inputs is declared; outputs equal the Engine's."""
    got = result(runs, "batch_inputs")
    small = GPT2Config(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                       n_head=2)
    m = build_gpt2_decode(small, batch=2, max_len=16, kv_dtype="int8")
    feed = _decode_feed(small, 2, 16, "int8", seed=3)
    ref = JEngine(j_import(m))(dict(feed))
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=3e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("dl", [0, 4], ids=["host_loop", "device_loop4"])
def test_pipelined_generator_equals_jax(runs, kv, dl):
    """Generator(mesh={pipe: 2}, pipeline_axis="pipe"): the prefill and
    the decode steps GPipe-staged, each stage's cache rows kept on it
    across steps and across a device_loop block; tokens equal JAX's
    pipelined Generator's exactly."""
    got = result(runs, f"gen_{kv}_{dl}")["tokens"]
    ids = _ids(batch=4, seq=4, vocab=TINY.vocab_size)
    want, _ = JGenerator(TINY, mesh=j_mesh({"pipe": 2}),
                         pipeline_axis="pipe", kv_dtype=kv,
                         **GEN).generate(ids, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dl", [0, 4], ids=["host_loop", "device_loop4"])
def test_lora_over_a_pipeline_equals_jax(runs, dl):
    """A LoRA bank over the pipeline: the bank's per-layer matrices stack
    per stage, lora_idx rides as a shared batch input; tokens equal JAX's
    pipelined LoRA Generator (tests/test_lora.py:159-183), host loop and
    device_loop=4."""
    got = result(runs, f"lora_{dl}")["tokens"]
    ids = _ids(batch=2, seq=4, seed=5, vocab=TINY.vocab_size)
    want, _ = JGenerator(TINY, mesh=j_mesh({"pipe": 2}),
                         pipeline_axis="pipe", lora_bank=_bank(),
                         **LORA_GEN).generate(ids, 8)
    np.testing.assert_array_equal(got, want)
