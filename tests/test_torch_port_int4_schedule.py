"""The int4 kernels' schedule choice (ops/kernels/qmatmul_int4.py::
int4_schedule), on the CPU: a pure function of the shape, so every shape the
main paths launch can be checked here, without the card.

GPT-2 124M's decode step (M = batch 8) must take `small_m`, its prefill
(M = 8 x 64 = 512) `mma`, in both weight layouts; quant blocks the two fast
schedules cannot take (21 bytes) and unaligned operands go to `general`.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch.ops.kernels import _build
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qmatmul_int4 as q4
from onnx_rusty_inference_engine_tpu_torch.quant import (
    pack_int4, pack_int4_planar)
from test_torch_port_cuda import INT4_BF16_CASES, INT4_CASES

# GPT-2 124M's four matmuls per layer and its lm_head: (K, N)
GPT2_SHAPES = {"qkv": (768, 2304), "attn_proj": (768, 768),
               "mlp_fc": (768, 3072), "mlp_proj": (3072, 768),
               "lm_head": (768, 50257)}
STEP_M, PREFILL_M = 8, 8 * 64


def _blocks(layout, K, block=256):
    """(nblk, blk) the wrapper passes for a [K, N] weight packed by
    quant.pack_int4_planar / pack_int4 at `block`."""
    if layout == "planar":
        return q4.planar_layout(K, block)
    return K // block, q4.interleaved_layout(K, K // 2, K // block)


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("shape", list(GPT2_SHAPES))
@pytest.mark.parametrize("M,want", [(STEP_M, "small_m"),
                                    (PREFILL_M, "mma")])
def test_gpt2_shapes_pick_their_schedule(layout, shape, M, want):
    K, _ = GPT2_SHAPES[shape]
    assert q4.int4_schedule(M, K, *_blocks(layout, K)) == want


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_crossover(layout):
    """M = SMALL_M_MAX is the last M on small_m; one more row goes to mma,
    at every GPT-2 shape."""
    for K, _ in GPT2_SHAPES.values():
        nblk, blk = _blocks(layout, K)
        assert q4.int4_schedule(q4.SMALL_M_MAX, K, nblk, blk) == "small_m"
        assert q4.int4_schedule(q4.SMALL_M_MAX + 1, K, nblk, blk) == "mma"


def test_crossover_is_within_small_m_rows():
    """small_m stages at most 16 rows of A."""
    assert 1 <= q4.SMALL_M_MAX <= 16


@pytest.mark.parametrize("case,layout", [("odd_bs21", "planar"),
                                         ("odd_qbh21", "interleaved")])
def test_odd_blocks_pick_general(case, layout):
    M, K, _, block = {**INT4_CASES, **INT4_BF16_CASES}[case]
    nblk, blk = _blocks(layout, K, block)
    assert blk == 21
    for m in (M, STEP_M, PREFILL_M):
        assert q4.int4_schedule(m, K, nblk, blk) == "general"


def test_unaligned_operands_pick_general():
    for M in (1, STEP_M, PREFILL_M):
        assert q4.int4_schedule(M, 768, 3, 128, aligned=False) == "general"


@pytest.mark.parametrize("M,K,nblk,blk,want", [
    (8, 768, 8, 48, "small_m"),        # 3 chunks a block
    (8, 768, 16, 24, "general"),       # 24-byte blocks: not whole chunks
    (8, 7000, 14, 250, "general"),     # 250-byte blocks
    (8, 7008, 219, 16, "small_m"),     # A's 8 x 7008 f32 + sums: 227 KB
    (8, 7040, 220, 16, "mma"),         # 8 x 7040: too many
    (16, 768, 3, 128, "mma"),          # above the crossover
    (1, 800, 25, 16, "small_m"),       # one 16-byte chunk a block
    (4096, 768, 3, 128, "mma"),
    (8, 4096, 2, 1024, "small_m"),     # 64 chunks a block
])
def test_shape_constraints(M, K, nblk, blk, want):
    assert q4.int4_schedule(M, K, nblk, blk) == want


def test_choice_loads_no_library():
    """The choice is Python alone: no kernel library is built or loaded."""
    loaded = dict(_build._LOADED)
    for M in (1, 8, 17, 512):
        q4.int4_schedule(M, 768, 3, 128)
    assert _build._LOADED == loaded


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
def test_cpu_tensors_take_the_plain_version_and_count_nothing(layout):
    """On CPU tensors the wrappers run the plain versions: no launch and no
    schedule is counted."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((768, 96)).astype(np.float32)
    a = torch.from_numpy(rng.standard_normal((8, 768)).astype(np.float32))
    if layout == "planar":
        kern, plain, kw = (q4.qmatmul_int4_planar,
                           q4.qmatmul_int4_planar_plain, {"qblock": 256})
        packed, scales = pack_int4_planar(w, 256)
    else:
        kern, plain, kw = q4.qmatmul_int4_bf16, q4.qmatmul_int4_bf16_plain, {}
        packed, scales = pack_int4(w, 256)
    packed, scales = torch.from_numpy(packed), torch.from_numpy(scales)
    before = (kern.launches, dict(kern.schedules))
    got = kern(a, packed, scales, **kw)
    assert torch.equal(got, plain(a, packed, scales, **kw))
    assert (kern.launches, kern.schedules) == before
    assert set(kern.schedules) == set(q4.SCHEDULES)


@pytest.mark.parametrize("variant", q4.NIBBLE_VARIANTS)
def test_nibble_probe_variants_on_cpu(variant):
    p = torch.from_numpy((np.arange(1001) % 256).astype(np.uint8))
    lo, hi = q4.nibble_probe(p, variant)
    plo, phi = q4.nibble_probe_plain(p)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)


def test_nibble_probe_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        q4.nibble_probe(torch.zeros(4, dtype=torch.uint8), "fp8")
