"""The port's multi-process serving and generation on a mesh, held against
the JAX package on the CPU (the counterpart of tests/test_distributed.py).

Every rank is a process on gloo (tests/torch_parallel_worker.py), built
with the same submissions in the same order (pre-queued, autostart=False)
so that the dispatchers issue their collectives in the same order:

- Generator with tests/test_gpt2.py's north-star rule (packed int4
  weights and their scales on N, other 2-D weights on their last dim) on
  {data: 2, model: 2}, INT4 weights + INT8 KV: tokens equal JAX's sharded
  Generator's, and the prefill logits the port's unsharded Generator's
  bit for bit.
- DecodeServer under cnn_param_sharding on {model: 2} and on
  {data: 2, model: 2}: served tokens equal the JAX process-local
  server's (tests/distributed_serve_worker.py's requests).
- SpeculativeServer, Seq2SeqServer and an InferenceServer over a sharded
  SqueezeNet Engine, each on two ranks; a sharded AOT artifact exported
  on two ranks and loaded on the same mesh (outputs equal the sharded
  Engine's bit for bit; the meta records two devices).
- A rank that exits mid-stream fails every future pending on the others;
  none hangs (tests/test_distributed.py::
  test_worker_death_fails_futures_cleanly).

Integer paths (tokens) are compared exactly.
"""

import dataclasses
import os

import numpy as np
import pytest

import onnx_rusty_inference_engine_tpu as joriet
from onnx_rusty_inference_engine_tpu.generate import Generator as JGenerator
from onnx_rusty_inference_engine_tpu.models import build_squeezenet
from onnx_rusty_inference_engine_tpu.models import gpt2 as j_gpt2
from onnx_rusty_inference_engine_tpu.models import t5 as j_t5
from onnx_rusty_inference_engine_tpu.parallel import make_mesh as j_mesh
from onnx_rusty_inference_engine_tpu.serve_llm import (
    DecodeServer as JDecodeServer, SpeculativeServer as JSpeculativeServer)
from onnx_rusty_inference_engine_tpu.serving import (
    Seq2SeqServer as JSeq2SeqServer)
from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_onnx
from torch_parallel_worker import result, run_ranks

V = j_gpt2.TINY.vocab_size
NS = dict(batch=2, prompt_len=4, max_len=12, kv_dtype="int8",
          int4_weights=True)
SERVE = dict(slots=2, prompt_len=4, max_len=24)


def _decode_reqs():
    """tests/distributed_serve_worker.py's decode requests."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, V, (4,)).astype(np.int64),
             int(rng.integers(3, 7))) for _ in range(4)]


def _spec_reqs():
    rng = np.random.default_rng(61)
    return [(rng.integers(0, V, (int(rng.integers(2, 9)),)).astype(np.int64),
             n) for n in (3, 8, 5, 6)]


def _t5_reqs():
    rng = np.random.default_rng(81)
    return [(rng.integers(0, j_t5.TINY.vocab_size,
                          (int(rng.integers(2, 9)),)).astype(np.int64), 5)
            for _ in range(4)]


def _ns_ids():
    return np.random.default_rng(13).integers(0, V, (2, 4)).astype(np.int64)


def _jsonable(reqs):
    return [[p.tolist(), n] for p, n in reqs]


def _north_star_j(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    def shard(name, arr):
        if name.endswith("__w4") and arr.ndim == 2:
            return NamedSharding(mesh, P("model", None))
        if name.endswith("__w4s"):
            return NamedSharding(mesh, P(None, "model"))
        if arr.ndim == 2 and arr.shape[-1] % 4 == 0:
            return NamedSharding(mesh, P(None, "model"))
        return NamedSharding(mesh, P())

    return shard


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four ranks (the north-star Generator, the data x model server),
    two ranks (the other servers and the artifact), and two ranks of
    which one dies."""
    d = str(tmp_path_factory.mktemp("distributed"))
    np.savez(os.path.join(d, "ns_ids.npz"), input_ids=_ns_ids())
    four = [
        dict(name="north_star", kind="generator", mesh={"data": 2,
                                                        "model": 2},
             feed="ns_ids.npz", n_new=4, params="north_star",
             return_logits=True, kw=NS),
        dict(name="north_star_dl", kind="generator",
             mesh={"data": 2, "model": 2}, feed="ns_ids.npz", n_new=4,
             params="north_star", kw=dict(NS, device_loop=2)),
        dict(name="serve_dm", kind="decode_server",
             mesh={"data": 2, "model": 2}, params="cnn",
             reqs=_jsonable(_decode_reqs()), kw=SERVE),
    ]
    onnx_io.save_model(os.path.join(d, "sq.onnx"), build_squeezenet())
    xs = np.random.default_rng(3).random((4, 3, 64, 64), np.float32)
    np.savez(os.path.join(d, "sq_x.npz"), x=xs)
    np.savez(os.path.join(d, "sq_feed.npz"), data_0=xs)
    two = [
        dict(name="serve_m", kind="decode_server", mesh={"model": 2},
             params="cnn", reqs=_jsonable(_decode_reqs()), kw=SERVE),
        dict(name="spec", kind="spec_server", mesh={"model": 2},
             params="cnn", draft_layers=1, reqs=_jsonable(_spec_reqs()),
             kw=dict(slots=2, prompt_len=8, max_len=48, k=4, draft_seed=1)),
        dict(name="seq2seq", kind="seq2seq_server", mesh={"model": 2},
             params="cnn", reqs=_jsonable(_t5_reqs()),
             kw=dict(slots=2, src_len=8, max_len=16)),
        dict(name="cnn_server", kind="inference_server", mesh={"model": 2},
             params="cnn", model="sq.onnx", feed="sq_x.npz", buckets=[4]),
        dict(name="artifact", kind="export", mesh={"data": 1, "model": 2},
             params="cnn", inputs="data", model="sq.onnx",
             feed="sq_feed.npz"),
    ]
    rng = np.random.default_rng(7)
    die = [dict(name="die", kind="die", mesh={"model": 2}, victim=1,
                n_new=64, step_timeout=6.0, result_timeout=60,
                prompts=[rng.integers(0, V, (4,)).tolist()
                         for _ in range(3)],
                kw=dict(slots=2, prompt_len=4, max_len=96))]
    out = {}
    for tag, world, cases, t in (("four", 4, four, 240),
                                 ("two", 2, two, 240),
                                 ("die", 2, die, 150)):
        out[tag] = run_ranks(world, cases, d, timeout=t,
                             collective_timeout=20 if tag == "die" else 60)
    return d, out, xs


def _tokens(res):
    return [[int(t) for t in res[f"tokens{i}"]]
            for i in range(len(res))]


def _jserve(srv, reqs):
    try:
        futs = [srv.submit(p, n) for p, n in reqs]
        return [[int(t) for t in f.result(timeout=300)] for f in futs]
    finally:
        srv.stop()


def test_north_star_generator_equals_jax(runs):
    """INT4 weights + INT8 KV, tensor-sharded on {data: 2, model: 2}: the
    host loop's and a device_loop=2 block's tokens equal JAX's sharded
    Generator's. The prefill logits equal the port's unsharded
    Generator's exactly: the column-parallel gathers add no error. (At
    TINY the two packages' INT4 logits differ by up to 3.5e-3 unsharded
    as sharded, JAX's sharded run being equal to its unsharded one.)"""
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import TINY

    d = runs[0]
    assert all(rc == 0 for _, rc, _ in runs[1]["four"]), runs[1]["four"]
    res = result(d, "north_star")
    mesh = j_mesh({"data": 2, "model": 2})
    gen = JGenerator(j_gpt2.TINY, mesh=mesh,
                     param_sharding_fn=_north_star_j(mesh), **NS)
    with mesh:
        want, logits = gen.generate(_ns_ids(), 4, return_logits=True)
    np.testing.assert_array_equal(res["tokens"], want)
    mine = Generator(TINY, device="cpu", **NS).generate(
        _ns_ids(), 4, return_logits=True)[1]
    np.testing.assert_array_equal(res["logits0"], mine[0])
    np.testing.assert_array_equal(result(d, "north_star_dl")["tokens"],
                                  want)


@pytest.mark.parametrize("name,world", [("serve_m", 2), ("serve_dm", 4)],
                         ids=["model2", "data2_model2"])
def test_decode_server_equals_jax(runs, name, world):
    """A DecodeServer per rank, its weights column-sharded over "model"
    (and replicated over "data"), admission while stepping (4 requests on
    2 slots): served tokens equal JAX's process-local server's."""
    d = runs[0]
    got = _tokens(result(d, name))
    want = _jserve(JDecodeServer(j_gpt2.TINY, **SERVE), _decode_reqs())
    assert got == want
    assert [len(t) for t in got] == [n for _, n in _decode_reqs()]


def test_speculative_server_equals_jax(runs):
    """SpeculativeServer (a one-layer draft, k = 4) with every Engine
    sharded on two ranks: served tokens equal JAX's process-local
    speculative server's."""
    got = _tokens(result(runs[0], "spec"))
    draft = dataclasses.replace(j_gpt2.TINY, n_layer=1)
    want = _jserve(JSpeculativeServer(j_gpt2.TINY, draft, slots=2,
                                      prompt_len=8, max_len=48, k=4,
                                      draft_seed=1), _spec_reqs())
    assert got == want


def test_seq2seq_server_equals_jax(runs):
    """Seq2SeqServer (t5 TINY) with its encoder and decode Engines sharded
    on two ranks: served tokens equal JAX's process-local server's."""
    got = _tokens(result(runs[0], "seq2seq"))
    want = _jserve(JSeq2SeqServer(j_t5.TINY, slots=2, src_len=8,
                                  max_len=16), _t5_reqs())
    assert got == want


def test_inference_server_over_a_sharded_engine(runs):
    """InferenceServer over a SqueezeNet Engine with its convs
    column-sharded on two ranks, four pre-queued requests in one bucket
    of 4: the results equal the port's unsharded Engine exactly and JAX's
    at test_parallel.py's 1e-4."""
    d, xs = runs[0], runs[2]
    got = result(d, "cnn_server")["y"]
    tg = import_onnx(os.path.join(d, "sq.onnx"))
    mine = Engine(tg, device="cpu")({"data_0": xs})["softmaxout_1"].numpy()
    np.testing.assert_array_equal(got, mine)
    want = np.asarray(joriet.Engine(joriet.import_model(build_squeezenet()))(
        {"data_0": xs})["softmaxout_1"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sharded_artifact_equals_the_sharded_engine(runs):
    """An artifact exported from a sharded Engine on two ranks records
    nr_devices = 2 and its mesh; loaded on the same mesh, each rank
    placing its own shards, its outputs equal the Engine's bit for bit."""
    res = result(runs[0], "artifact")
    assert int(res["nr_devices"]) == 2
    eng = {k[7:]: v for k, v in res.items() if k.startswith("engine:")}
    assert eng
    for k, v in eng.items():
        np.testing.assert_array_equal(res[f"loaded:{k}"], v)


def test_dead_peer_fails_every_pending_future(runs):
    """Rank 1 exits once the decode loop has emitted tokens; rank 0's
    pending futures all fail (gloo's peer error, the group's timeout or
    the step watchdog) within the test's bound, and none hangs."""
    d, out = runs[0], runs[1]["die"]
    rc = dict((r, c) for r, c, _ in out)
    assert rc[1] == 3, out
    own = result(d, "die", 0)
    assert int(own["hung"]) == 0
    assert int(own["failed"]) == int(own["n"]) == 3
