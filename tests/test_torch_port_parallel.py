"""The port's meshes, sharding rules and sharded Engine held against the
JAX package's on the CPU.

The rules are pure functions of the mesh's dim names and sizes: their
placements, read back per tensor dim (`spec_of`), equal JAX's
PartitionSpecs on the same arrays. The sharded Engine runs on four gloo
ranks (tests/torch_parallel_worker.py, one process a rank) and is held to
JAX's sharded Engine on the 8-virtual-device CPU mesh (tests/conftest.py)
at JAX's own tolerances (tests/test_parallel.py, tests/test_moe.py), and
bit for bit to the port's unsharded Engine (a column-parallel node's
gather and a data-parallel run change no sum). Each rank holds only its
shards, of the shapes JAX's shardings give.
"""

import json
import os
import types

import numpy as np
import pytest

import onnx_rusty_inference_engine_tpu as joriet
from onnx_rusty_inference_engine_tpu.models import build_squeezenet
from onnx_rusty_inference_engine_tpu.models.gpt2 import (
    GPT2Config as JGPT2Config, build_gpt2 as j_build_gpt2)
from onnx_rusty_inference_engine_tpu.models.moe import (
    TINY as J_MOE, build_moe as j_build_moe,
    moe_param_sharding as j_moe_rule)
from onnx_rusty_inference_engine_tpu.parallel import (
    cnn_param_sharding as j_cnn, data_input_sharding as j_data,
    make_mesh as j_mesh, replicated as j_replicated,
    seq_input_sharding as j_seq)
from onnx_rusty_inference_engine_tpu.quant import quantize_graph as j_quant
from onnx_rusty_inference_engine_tpu_torch import onnx_io
from onnx_rusty_inference_engine_tpu_torch.engine import Engine
from onnx_rusty_inference_engine_tpu_torch.graph import import_onnx
from onnx_rusty_inference_engine_tpu_torch.models.moe import \
    moe_param_sharding
from onnx_rusty_inference_engine_tpu_torch.parallel import (
    cnn_param_sharding, data_input_sharding, initialize_distributed,
    local_mesh, make_mesh, replicated, seq_input_sharding)
from onnx_rusty_inference_engine_tpu_torch.parallel.sharding import spec_of
from onnx_rusty_inference_engine_tpu_torch.quant import quantize_graph
from torch_parallel_worker import result, run_ranks

SEQ_CFG = dict(vocab_size=128, n_positions=32, n_embd=48, n_layer=2,
               n_head=4)
# n_embd 256: the MLP's down projection (K 1024) holds two planar int4
# quant blocks a half, so its K splits over two ranks in whole blocks
WIDE_CFG = dict(vocab_size=128, n_positions=32, n_embd=256, n_layer=1,
                n_head=4)
MESH = {"data": 2, "model": 2}


def _save(d, name, model):
    onnx_io.save_model(os.path.join(d, name), model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file on four ranks, once: SqueezeNet fp32 and
    INT8 on {data: 2, model: 2} under cnn_param_sharding and
    data_input_sharding, GPT-2 prefill under seq_input_sharding on
    {data: 2, seq: 2}, the MoE under moe_param_sharding."""
    d = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(11)
    _save(d, "sq.onnx", build_squeezenet())
    x = rng.random((8, 3, 64, 64), np.float32)
    np.savez(os.path.join(d, "sq_feed.npz"), data_0=x)
    _save(d, "g2.onnx", j_build_gpt2(JGPT2Config(**SEQ_CFG), batch=4,
                                     seq_len=16, with_presents=False))
    ids = rng.integers(0, 128, (4, 16)).astype(np.int64)
    np.savez(os.path.join(d, "g2_feed.npz"), input_ids=ids)
    _save(d, "g2_wide.onnx", j_build_gpt2(JGPT2Config(**WIDE_CFG), batch=2,
                                          seq_len=8, with_presents=False))
    np.savez(os.path.join(d, "g2_wide_feed.npz"), input_ids=rng.integers(
        0, 128, (2, 8)).astype(np.int64))
    _save(d, "moe.onnx", j_build_moe(J_MOE, batch=2, seq_len=8))
    mids = rng.integers(0, J_MOE.vocab_size, (2, 8)).astype(np.int64)
    np.savez(os.path.join(d, "moe_feed.npz"), input_ids=mids)
    cases = [
        dict(name="mesh", kind="mesh", mesh=MESH),
        dict(name="sq_fp32", kind="engine", mesh=MESH, model="sq.onnx",
             feed="sq_feed.npz", params="cnn", inputs="data"),
        dict(name="sq_int8", kind="engine", mesh=MESH, model="sq.onnx",
             feed="sq_feed.npz", params="cnn", inputs="data",
             quantize=True, calib="sq_feed.npz"),
        dict(name="seq", kind="engine", mesh={"data": 2, "seq": 2},
             model="g2.onnx", feed="g2_feed.npz", inputs="seq"),
        dict(name="moe", kind="engine", mesh=MESH, model="moe.onnx",
             feed="moe_feed.npz", params="moe"),
        dict(name="sq_fp32_row", kind="engine", mesh=MESH, model="sq.onnx",
             feed="sq_feed.npz", params="row", inputs="data"),
        dict(name="sq_int8_row", kind="engine", mesh=MESH, model="sq.onnx",
             feed="sq_feed.npz", params="row", inputs="data",
             quantize=True, calib="sq_feed.npz"),
        dict(name="g2_int4_row", kind="engine", mesh=MESH,
             model="g2_wide.onnx", feed="g2_wide_feed.npz", params="row",
             int4=True),
    ]
    ranks = run_ranks(4, cases, d)
    assert all(rc == 0 for _, rc, _ in ranks), ranks
    return d, x, ids, mids


def _routes(res):
    return json.loads(bytes(res.pop("__routes__")))


# -------------------------------------------------------------------------
# meshes
# -------------------------------------------------------------------------
def test_make_mesh_on_one_rank():
    """A world of one (what one card gives): the mesh's dims and shape; a
    mesh wanting more ranks than exist, and local_mesh with a model size
    that does not divide them, raise as in JAX; initialize_distributed
    does nothing at one process."""
    assert initialize_distributed(num_processes=1) is None
    mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="mesh wants 2 devices, have 1"):
        make_mesh({"data": 2}, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model=3"):
        local_mesh(3, device="cpu")
    assert tuple(local_mesh(1, device="cpu").shape) == (1, 1)


def test_make_mesh_on_four_ranks(runs):
    """{data: 2, model: 2} over four gloo ranks: JAX's axes and shape, and
    each rank at its row-major coordinate."""
    d = runs[0]
    res = result(d, "mesh")
    jm = j_mesh(MESH)
    assert tuple(res["names"]) == jm.axis_names
    assert tuple(res["shape"]) == jm.devices.shape
    for r in range(4):
        own = result(d, "mesh", r)
        assert (int(own["local:data"]), int(own["local:model"])) == divmod(
            r, 2)


# -------------------------------------------------------------------------
# the rules
# -------------------------------------------------------------------------
def _jspec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _arrays():
    g = joriet.import_model(build_squeezenet())
    arrs = {k: np.asarray(v) for k, v in g.constants.items()
            if isinstance(v, np.ndarray) and v.dtype != object}
    rng = np.random.default_rng(0)
    for shape in ((8, 3, 64, 64), (4, 16), (3, 16), (16,), (4, 6, 5),
                  (1, 8), (), (2, 8, 8, 16)):
        arrs[f"in{shape}"] = rng.random(shape).astype(np.float32)
    arrs["blk0_exp_w1"] = np.zeros((8, 4, 6), np.float32)
    arrs["blk0_exp_w2"] = np.zeros((6, 4, 6), np.float32)
    return arrs


@pytest.mark.parametrize("rule", ["cnn", "data", "seq", "moe",
                                  "replicated"])
def test_rules_give_jax_partition_specs(rule):
    """Each rule's placements, read per tensor dim, are JAX's
    PartitionSpec for the same array on a mesh of the same dims and sizes
    (SqueezeNet's weights, stacked experts, inputs of many shapes)."""
    axes = {"seq": ("data", "seq")}.get(rule, ("data", "model"))
    sizes = (2, 4)
    tm = types.SimpleNamespace(mesh_dim_names=axes, shape=sizes)
    jm = j_mesh(dict(zip(axes, sizes)))
    port, jax_ = {
        "cnn": (cnn_param_sharding(tm), j_cnn(jm)),
        "data": (data_input_sharding(tm), j_data(jm)),
        "seq": (seq_input_sharding(tm), j_seq(jm)),
        "moe": (moe_param_sharding(tm, 4), j_moe_rule(jm, 4)),
        "replicated": (lambda n, a: replicated(tm),
                       lambda n, a: j_replicated(jm)),
    }[rule]
    seen = set()
    for name, a in _arrays().items():
        got = spec_of(tm, port(name, a), a.ndim)
        assert got == _jspec(jax_(name, a), a.ndim), name
        seen.add(got)
    if rule != "replicated":
        assert len(seen) > 1  # something is sharded


def test_local_shards_have_jax_shard_shapes(runs):
    """Each rank's weights are its shards: the conv kernels' O split over
    "model" (the counterpart of test_weights_actually_sharded), with the
    shard shapes of JAX's sharded Engine; the per-output biases are cut to
    the same range under their local names."""
    d = runs[0]
    jm = j_mesh(MESH)
    jg = joriet.import_model(build_squeezenet())
    jeng = joriet.Engine(jg, mesh=jm, param_sharding_fn=j_cnn(jm))
    want = {k: tuple(v.sharding.shard_shape(v.shape))
            for k, v in jeng.params.items()}
    for r in range(4):
        own = result(d, "sq_fp32", r)
        shapes = {k[6:]: tuple(v) for k, v in own.items()
                  if k.startswith("shape:")}
        for k, shape in want.items():
            if k in shapes:
                assert shapes[k] == shape, (r, k)
            else:  # a replicated bias, cut with its conv's O
                whole = tuple(jeng.params[k].shape)
                assert shapes[f"{k}@shard:model"] == (whole[0] // 2,), k
        assert shapes["conv1_w_0"] == (48, 3, 7, 7)
        assert shapes["conv10_b_0@shard:model"] == (500,)


# -------------------------------------------------------------------------
# the sharded Engine
# -------------------------------------------------------------------------
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_sharded_squeezenet_equals_jax(runs, int8):
    """SqueezeNet on {data: 2, model: 2}: every conv column-parallel (26
    on route a), every other node on the local rows; the output equals
    JAX's sharded Engine (fp32 at test_parallel.py's 1e-4; INT8 at the
    cross-package bound of test_torch_port_squeezenet.py, 1e-3 and the
    same top-1) and the port's unsharded Engine exactly."""
    d, x = runs[0], runs[1]
    res = result(d, "sq_int8" if int8 else "sq_fp32")
    routes = _routes(res)
    assert routes["a_column"] == 26 and routes["whole"] == 0
    assert routes["d_gathered"] == routes["b_row"] == 0
    assert routes["output_gathers"] == 1 and routes["local"] > 30
    jg = joriet.import_model(build_squeezenet())
    tg = import_onnx(os.path.join(d, "sq.onnx"))
    if int8:
        jg = j_quant(jg, calibration_inputs=[{"data_0": x}])
        tg = quantize_graph(tg, calibration_inputs=[{"data_0": x}],
                            device="cpu")
    jm = j_mesh(MESH)
    jeng = joriet.Engine(jg, mesh=jm, param_sharding_fn=j_cnn(jm),
                         input_sharding_fn=j_data(jm))
    with jm:
        jout = {k: np.asarray(v) for k, v in jeng({"data_0": x}).items()}
    mine = {k: v.numpy()
            for k, v in Engine(tg, device="cpu")({"data_0": x}).items()}
    # INT8 across the packages: test_torch_port_squeezenet.py's bound
    # (requant ties may round either way): softmax within 1e-3, same top-1
    tol = dict(rtol=0, atol=1e-3) if int8 else dict(rtol=1e-4, atol=1e-4)
    for k, want in jout.items():
        np.testing.assert_allclose(res[k], want, **tol)
        np.testing.assert_array_equal(res[k].reshape(8, -1).argmax(1),
                                      want.reshape(8, -1).argmax(1))
        np.testing.assert_array_equal(res[k], mine[k])


def test_seq_parallel_prefill_equals_jax(runs):
    """GPT-2 prefill with L over "seq" and the batch over "data": the
    embedding Gather, the position add, the norms, the qkv MatMul and its
    bias and the split run on the local positions; L is gathered at the
    head split. Logits equal JAX's seq-sharded Engine (rtol 1e-4, atol
    1e-4) and the port's unsharded Engine exactly."""
    d, ids = runs[0], runs[2]
    res = result(d, "seq")
    routes = _routes(res)
    assert routes["local"] >= 2 * 8 and routes["activation_gathers"] > 0
    jg = joriet.import_model(j_build_gpt2(JGPT2Config(**SEQ_CFG), batch=4,
                                          seq_len=16, with_presents=False))
    jm = j_mesh({"data": 2, "seq": 2})
    jeng = joriet.Engine(jg, mesh=jm,
                         param_sharding_fn=lambda n, a: j_replicated(jm),
                         input_sharding_fn=j_seq(jm))
    with jm:
        want = np.asarray(jeng({"input_ids": ids})["logits"])
    np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-4)
    tg = import_onnx(os.path.join(d, "g2.onnx"))
    mine = Engine(tg, device="cpu")({"input_ids": ids})["logits"].numpy()
    np.testing.assert_array_equal(res["logits"], mine)


def test_moe_expert_parallel_equals_jax(runs):
    """The MoE under moe_param_sharding on "model": each expert MatMul
    runs the rank's experts and gathers along E (route c, two per layer);
    logits equal JAX's expert-parallel Engine at test_moe.py's tolerance
    (1e-4) and the port's unsharded Engine exactly."""
    d, mids = runs[0], runs[3]
    res = result(d, "moe")
    routes = _routes(res)
    assert routes["c_expert"] == 2 * J_MOE.n_layer
    assert routes["d_gathered"] == 0
    jg = joriet.import_model(j_build_moe(J_MOE, batch=2, seq_len=8))
    jm = j_mesh(MESH)
    with jm:
        jeng = joriet.Engine(jg, mesh=jm,
                             param_sharding_fn=j_moe_rule(jm, 2))
        want = jeng.run({"input_ids": mids})["logits"]
    np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-4)
    tg = import_onnx(os.path.join(d, "moe.onnx"))
    mine = Engine(tg, device="cpu")({"input_ids": mids})["logits"].numpy()
    np.testing.assert_array_equal(res["logits"], mine)
    for r in range(4):
        own = result(d, "moe", r)
        for w in ("blk0_exp_w1", "blk0_exp_w2"):
            assert own[f"shape:{w}"][0] == J_MOE.n_expert // 2


def test_rules_need_a_mesh_and_one_rank_equals_unsharded():
    """A rule without a mesh is refused before anything runs; on a world of one the sharded Engine
    equals the unsharded one exactly."""
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model
    from onnx_rusty_inference_engine_tpu_torch.models import \
        build_squeezenet as t_build

    g = import_model(t_build())
    with pytest.raises(ValueError, match="need a mesh"):
        Engine(g, device="cpu", param_sharding_fn=lambda n, a: None)
    mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
    eng = Engine(g, device="cpu", mesh=mesh,
                 param_sharding_fn=cnn_param_sharding(mesh),
                 input_sharding_fn=data_input_sharding(mesh))
    x = np.random.default_rng(1).random((2, 3, 64, 64), np.float32)
    got = eng({"data_0": x})["softmaxout_1"].numpy()
    want = Engine(g, device="cpu")({"data_0": x})["softmaxout_1"].numpy()
    np.testing.assert_array_equal(got, want)
    assert eng.shard_routes["output_gathers"] == 1


def _j_row(jm):
    """The worker's row rule on JAX's shardings."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def rule(name, arr):
        if arr.ndim == 4 and arr.shape[1] % 2 == 0:
            return NamedSharding(jm, P(None, "model", None, None))
        if arr.ndim == 2 and arr.shape[0] % 2 == 0:
            return NamedSharding(jm, P("model", None))
        return NamedSharding(jm, P())

    return rule


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_row_parallel_squeezenet(runs, int8):
    """Every conv whose input channels divide sharded on them (route b):
    each rank convolves its channels, an all_reduce sums the parts, the
    bias is added once after. INT8 sums int32 and requantizes once after
    the reduce: the output equals the unsharded Engine bit for bit; fp32
    sums in another order (1e-4). Both equal JAX's Engine under the same
    shardings (fp32 1e-4; INT8 at the cross-package 1e-3, same top-1)."""
    d, x = runs[0], runs[1]
    res = result(d, "sq_int8_row" if int8 else "sq_fp32_row")
    routes = _routes(res)
    assert routes["b_row"] == 25 and routes["a_column"] == 0
    assert routes["d_gathered"] == 0  # conv1's 3 channels: replicated
    jg = joriet.import_model(build_squeezenet())
    tg = import_onnx(os.path.join(d, "sq.onnx"))
    if int8:
        jg = j_quant(jg, calibration_inputs=[{"data_0": x}])
        tg = quantize_graph(tg, calibration_inputs=[{"data_0": x}],
                            device="cpu")
    jm = j_mesh(MESH)
    jeng = joriet.Engine(jg, mesh=jm, param_sharding_fn=_j_row(jm),
                         input_sharding_fn=j_data(jm))
    with jm:
        jout = {k: np.asarray(v) for k, v in jeng({"data_0": x}).items()}
    mine = {k: v.numpy()
            for k, v in Engine(tg, device="cpu")({"data_0": x}).items()}
    for k, want in jout.items():
        if int8:
            np.testing.assert_array_equal(res[k], mine[k])
            np.testing.assert_allclose(res[k], want, rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(res[k], mine[k], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(res[k], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(res[k].reshape(8, -1).argmax(1),
                                      want.reshape(8, -1).argmax(1))


def test_row_parallel_int4_whole_blocks(runs):
    """GPT-2 on planar int4 weights sharded on their packed K/2: the MLP's
    down projection (two quant blocks a half) runs row-parallel on its
    block of each half of K; the others (one block a half) cannot split
    into whole blocks and gather their weight (route d). Logits equal the
    unsharded Engine's at 1e-4 (the parts' sums add in another order)."""
    d = runs[0]
    res = result(d, "g2_int4_row")
    routes = _routes(res)
    assert routes["b_row"] == WIDE_CFG["n_layer"]
    assert routes["d_gathered"] > 0
    from onnx_rusty_inference_engine_tpu_torch.quant import \
        quantize_weights_int4

    tg = quantize_weights_int4(import_onnx(os.path.join(d, "g2_wide.onnx")))
    ids = dict(np.load(os.path.join(d, "g2_wide_feed.npz")))
    want = Engine(tg, device="cpu")(ids)["logits"].numpy()
    np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-4)
