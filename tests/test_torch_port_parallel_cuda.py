"""The mesh on the card: a world of one rank on NCCL (marker `cuda`; each
test skips without a CUDA device).

This file imports neither JAX nor the JAX package. Run it on a card,
without the suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_parallel_cuda.py -q

At one rank every collective runs over a group of one, so a sharded run
computes what the unsharded one does, on the same kernels:

- row-parallel INT8 convs (their int32 epilogue, the reduce, then one
  requant in PyTorch) bit-equal to the fused requant kernel's run, eager
  and replayed;
- row-parallel planar int4 (the K halves cut) bit-equal to the unsharded
  Engine;
- a sharded artifact exported for the card and loaded on the mesh,
  bit-equal to its Engine, eager and replayed;
- a pipelined decode step captured with its broadcast, the replay
  bit-equal to the eager schedule.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from onnx_rusty_inference_engine_tpu_torch import Engine, import_model
from onnx_rusty_inference_engine_tpu_torch.models import gpt2
from onnx_rusty_inference_engine_tpu_torch.models import build_squeezenet
from onnx_rusty_inference_engine_tpu_torch.parallel import (
    PipelinedDecoder, make_mesh)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    quantize_graph, quantize_weights_int4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _row(name, arr):
    """Every weight on its contraction dim over "model" (a conv's I, a
    MatMul weight's K, a packed int4 weight's K/2)."""
    if arr.ndim == 4 or name.endswith("__w4"):
        return (Shard(1),)
    if arr.ndim == 2 and not name.endswith("__w4s"):
        return (Shard(0),)
    return (Replicate(),)


def _o(name, arr):
    """Conv kernels on their output channels over "model"."""
    return (Shard(0),) if arr.ndim == 4 else (Replicate(),)


def _squeezenet_int8(x):
    g = import_model(build_squeezenet())
    return quantize_graph(g, calibration_inputs=[{"data_0": x}],
                          device="cuda")


def test_row_parallel_int8_equals_the_fused_kernel(cuda):
    x = np.random.default_rng(0).random((8, 3, 64, 64), np.float32)
    q = _squeezenet_int8(x)
    mesh = make_mesh({"model": 1})
    eng = Engine(q, mesh=mesh, param_sharding_fn=_row)
    want = Engine(q)({"data_0": x})["softmaxout_1"]
    got = eng({"data_0": x})["softmaxout_1"]
    assert eng.shard_routes["b_row"] == 26
    assert torch.equal(got, want)
    assert torch.equal(eng({"data_0": x})["softmaxout_1"], got)  # replay


def test_row_parallel_int4_equals_unsharded(cuda):
    cfg = gpt2.GPT2Config(vocab_size=128, n_positions=32, n_embd=256,
                          n_layer=1, n_head=4)
    g = quantize_weights_int4(import_model(gpt2.build_gpt2(
        cfg, batch=2, seq_len=8, with_presents=False)))
    ids = np.random.default_rng(1).integers(0, 128, (2, 8))
    eng = Engine(g, mesh=make_mesh({"model": 1}), param_sharding_fn=_row)
    got = eng({"input_ids": ids})["logits"]
    assert eng.shard_routes["b_row"] == 5  # every int4 MatMulNBits
    assert torch.equal(got, Engine(g)({"input_ids": ids})["logits"])


def test_sharded_artifact_on_the_card(cuda, tmp_path):
    from onnx_rusty_inference_engine_tpu_torch.export_aot import (
        export_engine, load_exported)

    x = np.random.default_rng(2).random((4, 3, 64, 64), np.float32)
    mesh = make_mesh({"data": 1, "model": 1})
    eng = Engine(import_model(build_squeezenet()), mesh=mesh,
                 param_sharding_fn=lambda n, a: (Replicate(),) + _o(n, a))
    want = eng({"data_0": x})["softmaxout_1"]
    path = str(tmp_path / "sq.npz")
    export_engine(eng, {"data_0": x}, path)
    model = load_exported(path, mesh=mesh)
    assert model.meta["mesh"] == {"data": 1, "model": 1}
    for _ in range(2):  # eager and captured, then replayed
        assert torch.equal(model({"data_0": x})["softmaxout_1"], want)


def test_pipelined_step_replays_its_eager_schedule(cuda):
    g = import_model(gpt2.build_gpt2_decode(gpt2.TINY, batch=4, max_len=16,
                                            kv_dtype="int8"))
    pd = PipelinedDecoder(g, make_mesh({"pipe": 1}), device=cuda)
    rng = np.random.default_rng(3)
    H, hd, L = gpt2.TINY.n_head, gpt2.TINY.head_dim, gpt2.TINY.n_layer
    feed = {"input_ids": torch.as_tensor(rng.integers(0, 64, (4, 1)),
                                         device=cuda),
            "pos": torch.full((4,), 5, dtype=torch.int64, device=cuda)}
    stacked = {f"past_{k}_0": torch.as_tensor(rng.integers(
        -100, 100, (L, 4, H, 16, hd)).astype(np.int8), device=cuda)
        for k in ("key", "value")}
    stacked.update({f"kv_scale_{k}_0": torch.full(
        (L, H), 0.02, device=cuda) for k in ("key", "value")})
    eager = pd.stacked_call(feed, stacked, eager=True)
    first = pd.stacked_call(feed, stacked)     # eager run, then capture
    replay = pd.stacked_call(feed, stacked)
    for a, b, c in zip(eager, first, replay):
        for k in a:
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
