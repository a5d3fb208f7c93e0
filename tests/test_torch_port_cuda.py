"""The port's kernels, engine and generator on the card (marker `cuda`;
each test skips without a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. Run it on a card, without the suite's conftest.py
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

The int8 conv kernel must equal its plain version bit for bit: both sum
int8 products exactly in 32 bits, then apply the same fp32 epilogue; on the
card it returns a channels-last tensor. The int8 GEMM's two epilogues
(int32, and the fused requant) are exact the same way. The
int4 and f32 attention kernels sum f32 in another order than their plain
versions (1e-5 of max|out|); the int8 x int8 attention can move one
quantized-probability step on a rounding tie (1e-2 of max|out|). The int8
GEMM (QLinearMatMul) is exact, so it equals its plain version bit for bit.

Whole models on the card against the CPU (12 layers at small widths, so
the launch counts are those of the full-size paths: 73 int8 GEMMs per BERT
forward, 49 int4 products per GPT-2 pass): the fp32 islands (LayerNorm,
Softmax, Gelu) sum in another order on each device, so an int8 value at a
requant tie, or a bf16-rounded activation, can move one step; the graphs
are held to more than 99% of int8 values equal and outputs within 1e-2 of
their largest magnitude.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch import (
    Engine, calibrate, import_model, quantize_graph)
from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
from onnx_rusty_inference_engine_tpu_torch.engine import collector_held
from onnx_rusty_inference_engine_tpu_torch.models._builder import (
    GraphBuilder)
from onnx_rusty_inference_engine_tpu_torch.generate import Generator
from onnx_rusty_inference_engine_tpu_torch.models.bert import (
    BertConfig, build_bert)
from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
from onnx_rusty_inference_engine_tpu_torch.models.llama import (
    LlamaConfig, build_llama_decode)
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import decode_attn as da
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qconv_int8 as k
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qmatmul_int4 as q4
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qmatmul_int8 as q8
from onnx_rusty_inference_engine_tpu_torch.models.squeezenet import (
    build_squeezenet)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    pack_int4, pack_int4_planar, quantize_weights_int4)
from chip_smoke import _int4_picks, ort_int4_generator
from torch_port_opcases import OPS, op_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (B, C, H, W, O, kernel, stride, pads[t, l, b, r], per-channel mult, bias)
CASES = {
    "1x1": (2, 32, 7, 7, 48, 1, 1, (0, 0, 0, 0), True, True),
    "1x1_scalar_nobias": (2, 24, 6, 5, 40, 1, 1, (0, 0, 0, 0), False,
                          False),
    "3x3_pad1_vector_path": (2, 64, 9, 9, 72, 3, 1, (1, 1, 1, 1), True,
                             True),
    "3x3_pad1_byte_path": (1, 20, 8, 7, 12, 3, 1, (1, 1, 1, 1), False, True),
    "7x7_stride2_c3": (2, 3, 23, 23, 16, 7, 2, (0, 0, 0, 0), True, True),
    "3x3_stride2_asym_pad": (1, 32, 10, 11, 8, 3, 2, (1, 0, 2, 1), True,
                             False),
    "k_beyond_one_stage": (3, 48, 5, 6, 130, 3, 1, (1, 1, 1, 1), True,
                           True),
    "1x1_c16_n8": (2, 16, 5, 7, 8, 1, 1, (0, 0, 0, 0), True, True),
    "1x1_c16_n1000": (1, 16, 9, 9, 1000, 1, 1, (0, 0, 0, 0), True, True),
    "3x3_c16_n16_stride2": (3, 16, 11, 9, 16, 3, 2, (1, 1, 1, 1), True,
                            False),
    "7x7_c3_stride2_pad3": (2, 3, 30, 29, 96, 7, 2, (3, 3, 3, 3), True,
                            True),
    "5x5_c8_asym_pad": (2, 8, 13, 10, 40, 5, 1, (2, 0, 1, 3), False, True),
    "1x1_stride2_c32": (2, 32, 9, 9, 24, 1, 2, (0, 0, 0, 0), True, True),
    "ragged_m_many_blocks": (3, 64, 23, 21, 200, 3, 1, (1, 1, 1, 1), True,
                             True),
    # K of 61 128-byte slices and B too large to stay resident
    "31x31_c8_stride2": (1, 8, 300, 300, 16, 31, 2, (0, 0, 0, 0), True,
                         True),
}


def _qconv_operands(B, C, H, W, O, ksz, per_ch, with_bias, rng, cuda):
    x = torch.from_numpy(rng.integers(-128, 128, (B, C, H, W), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (O, C, ksz, ksz), np.int8))
    # about 1.5 output steps per standard deviation of the sums
    sd = 128 * 73 * np.sqrt(C * ksz * ksz)
    mult = torch.from_numpy(
        (np.abs(rng.standard_normal(O if per_ch else 1)) * 100 / sd
         + 1 / sd).astype(np.float32))
    bias = (torch.from_numpy(rng.integers(-3000, 3000, (O,), np.int32))
            if with_bias else None)
    x, w, mult = x.to(cuda), w.to(cuda), mult.to(cuda)
    return x, w, mult, None if bias is None else bias.to(cuda)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(cuda, case):
    B, C, H, W, O, ksz, s, (pt, pl, pb, pr), per_ch, with_bias = CASES[case]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(-128, 128, (B, C, H, W), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (O, C, ksz, ksz), np.int8))
    mult = torch.from_numpy(
        (np.abs(rng.standard_normal(O if per_ch else 1)) * 2e-4 + 1e-5
         ).astype(np.float32))
    bias = (torch.from_numpy(rng.integers(-3000, 3000, (O,), np.int32))
            if with_bias else None)
    x, w, mult = x.to(cuda), w.to(cuda), mult.to(cuda)
    bias = None if bias is None else bias.to(cuda)
    padding = ((pt, pb), (pl, pr))
    before = k.qconv_int8_requant.launches
    got = k.qconv_int8_requant(x, w, mult, bias, stride=(s, s),
                               padding=padding,
                               packed=k.pack_qconv_weight(w, (s, s)))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.launches == before + 1
    want = k.qconv_int8_requant_plain(x, w, mult, bias, stride=(s, s),
                                      padding=padding)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


# SqueezeNet 1.0's 22 distinct QLinearConv shapes at b256, 224x224:
# (C, H, O, kernel, stride, pad)
SQUEEZENET_B256_CONVS = [
    (3, 224, 96, 7, 2, 0),
    (96, 54, 16, 1, 1, 0), (16, 54, 64, 1, 1, 0), (16, 54, 64, 3, 1, 1),
    (128, 54, 16, 1, 1, 0), (128, 54, 32, 1, 1, 0), (32, 54, 128, 1, 1, 0),
    (32, 54, 128, 3, 1, 1), (256, 26, 32, 1, 1, 0), (32, 26, 128, 1, 1, 0),
    (32, 26, 128, 3, 1, 1), (256, 26, 48, 1, 1, 0), (48, 26, 192, 1, 1, 0),
    (48, 26, 192, 3, 1, 1), (384, 26, 48, 1, 1, 0), (384, 26, 64, 1, 1, 0),
    (64, 26, 256, 1, 1, 0), (64, 26, 256, 3, 1, 1), (512, 12, 64, 1, 1, 0),
    (64, 12, 256, 1, 1, 0), (64, 12, 256, 3, 1, 1), (512, 12, 1000, 1, 1, 0),
]


@pytest.mark.parametrize("C,H,O,ksz,s,pad", SQUEEZENET_B256_CONVS)
def test_kernel_equals_plain_at_every_squeezenet_b256_conv(cuda, C, H, O,
                                                           ksz, s, pad):
    """On channels-last input, as the previous conv leaves it (conv1's
    NCHW input is laid out as its space-to-depth rewrite, its weight
    packed at its stride), through the producer its shape picks."""
    x, w, mult, bias = _qconv_operands(256, C, H, H, O, ksz, True, True,
                                       np.random.default_rng(C + O), cuda)
    if C != 3:
        x = x.contiguous(memory_format=torch.channels_last)
    padding = ((pad, pad), (pad, pad))
    producer = k.conv_plan(x.shape, w.shape, (s, s), padding)[0]
    before = dict(k.qconv_int8_requant.producers)
    got = k.qconv_int8_requant(x, w, mult, bias, stride=(s, s),
                               padding=padding,
                               packed=k.pack_qconv_weight(w, (s, s)))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.producers[producer] == before[producer] + 1
    want = k.qconv_int8_requant_plain(x, w, mult, bias, stride=(s, s),
                                      padding=padding)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_conv_takes_either_layout_and_returns_channels_last(cuda, layout):
    x, w, mult, bias = _qconv_operands(2, 32, 9, 7, 48, 3, True, True,
                                       np.random.default_rng(3), cuda)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    padding = ((1, 1), (1, 1))
    got = k.qconv_int8_requant(x, w, mult, bias, padding=padding,
                               packed=k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert got.shape == (2, 48, 9, 7)
    assert got.stride() == (9 * 7 * 48, 1, 7 * 48, 48)
    assert torch.equal(got, k.qconv_int8_requant_plain(x, w, mult, bias,
                                                       padding=padding))
    # the next conv reads it in place
    assert k.channels_last_input(got).data_ptr() == got.data_ptr()


# (M, K, N): ragged M, N and K (K not a multiple of 16 is copied into a
# padded A), N = 8, 16 and 1000
GEMM_FORM_CASES = [(100, 300, 50), (17, 64, 1000), (5, 13, 8), (300, 48, 16),
                   (1, 768, 768), (4097, 160, 96)]


@pytest.mark.parametrize("M,K,N", GEMM_FORM_CASES)
def test_gemm_form_equals_plain(cuda, M, K, N):
    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), np.int8)).to(cuda)
    mult = torch.tensor(3e-4, device=cuda)
    bias = torch.from_numpy(
        rng.integers(-1000, 1000, (N,), np.int32)).to(cuda)
    before = dict(q8.qmatmul_int8.epilogues)
    got = q8.qmatmul_int8_requant(a, b, mult, bias,
                                  packed=q8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.epilogues == dict(before, requant=before[
        "requant"] + 1)
    assert got.dtype == torch.int8 and got.shape == (M, N)
    assert torch.equal(got, q8.qmatmul_int8_requant_plain(a, b, mult, bias))


def test_refused_tiles_raise_and_count_nothing(cuda, monkeypatch):
    """A tile the C entry points refuse (a BN the kernel lacks, a ring of 9
    slots, one past 227 KB of shared memory): the wrappers raise and count
    no launch. The conv is a strided 3x3, which stays on the gather
    (test_torch_port_conv2d_cuda.py refuses halo tiles)."""
    a = torch.zeros((64, 64), dtype=torch.int8, device=cuda)
    b = torch.zeros((64, 32), dtype=torch.int8, device=cuda)
    packed = q8.pack_qmatmul_weight(b)
    x = torch.zeros((1, 16, 8, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 16, 3, 3), dtype=torch.int8, device=cuda)
    mult = torch.ones(32, device=cuda)
    for tile in (q8.Int8Tile(128, 80, 2), q8.Int8Tile(128, 32, 9),
                 q8.Int8Tile(128, 256, 5), q8.Int8Tile(96, 32, 2)):
        monkeypatch.setattr(q8, "int8_tile", lambda *args, t=tile: t)
        monkeypatch.setattr(k, "int8_tile", lambda *args, t=tile: t)
        before = (q8.qmatmul_int8.launches, dict(q8.qmatmul_int8.epilogues),
                  k.qconv_int8_requant.launches)
        with pytest.raises(RuntimeError, match="int32 epilogue"):
            q8.qmatmul_int8(a, b, packed=packed)
        with pytest.raises(RuntimeError, match="requant epilogue"):
            q8.qmatmul_int8_requant(a, b, mult, packed=packed)
        with pytest.raises(RuntimeError, match="gather producer"):
            k.qconv_int8_requant(x, w, mult, stride=(2, 2),
                                 packed=k.pack_qconv_weight(w))
        assert (q8.qmatmul_int8.launches, q8.qmatmul_int8.epilogues,
                k.qconv_int8_requant.launches) == before


def test_operands_off_the_card_raise(cuda):
    x = torch.zeros((1, 8, 4, 4), dtype=torch.int8, device=cuda)
    w = torch.zeros((4, 8, 1, 1), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="mult"):
        k.qconv_int8_requant(x, w, torch.ones(4), None,
                             packed=k.pack_qconv_weight(w))
    with pytest.raises(ValueError, match="pre-packed"):
        k.qconv_int8_requant(x, w, torch.ones(4, device=cuda), None)


def _small_cnn():
    b = GraphBuilder("small_cnn", opset=8, seed=5)
    x = b.input("x", [4, 3, 32, 32])

    def conv(x, name, cin, cout, ksz, stride=1, pad=0):
        y = b.op("Conv", x, b.he(f"{name}_w", (cout, cin, ksz, ksz)),
                 b.zeros(f"{name}_b", (cout,)), kernel_shape=[ksz, ksz],
                 strides=[stride, stride], pads=[pad] * 4)
        return b.op("Relu", y)

    y = conv(x, "stem", 3, 32, 7, stride=2, pad=3)
    y = b.op("MaxPool", y, kernel_shape=[3, 3], strides=[2, 2])
    s = conv(y, "squeeze", 32, 16, 1)
    y = b.op("Concat", conv(s, "e1", 16, 32, 1), conv(s, "e3", 16, 32, 3,
                                                      pad=1), axis=1)
    y = b.op("GlobalAveragePool", conv(y, "head", 64, 10, 1))
    b.output(b.node("Softmax", [y], ["prob"])[0])
    return b.model()


def test_int8_engine_on_card_matches_cpu(cuda):
    g = import_model(_small_cnn())
    x = np.random.default_rng(0).standard_normal((4, 3, 32, 32)).astype(
        np.float32)
    q = quantize_graph(g, ranges=calibrate(g, [{"x": x}], device="cpu"))
    n_qconv = sum(n.op_type == "QLinearConv" for n in q.nodes)
    probe = probe_graph(q)
    before = k.qconv_int8_requant.launches
    card = Engine(probe)({"x": x})
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.launches == before + n_qconv == before + 5
    host = Engine(probe, device="cpu")({"x": x})
    for name, v in host.items():
        if v.dtype == torch.int8:
            assert torch.equal(card[name].cpu(), v), name
    err = float((card["prob"].cpu() - host["prob"]).abs().max())
    assert err <= 1e-5, err


def _rel_err(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


# (M, K, N, block): M = 1; N = 130; K = 2 * bs * 3 at bs 128 and 64; an odd
# half-K block (bs = 21, byte loads); a prefill-sized M
INT4_CASES = {"m1_n130": (1, 768, 130, 256), "k_2bs3_bs64": (8, 384, 130, 64),
              "m17_k3072": (17, 3072, 300, 256), "odd_bs21": (3, 42, 33, 256),
              "m512": (512, 768, 1000, 256)}


@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_kernel_matches_plain(cuda, case):
    M, K, N, block = INT4_CASES[case]
    rng = np.random.default_rng(M + K)
    packed, scales = pack_int4_planar(
        rng.standard_normal((K, N)).astype(np.float32), block)
    Nw = -(-N // 256) * 256
    packed = torch.from_numpy(np.pad(packed, ((0, Nw - N), (0, 0)))).to(cuda)
    scales = torch.from_numpy(np.pad(scales, ((0, 0), (0, Nw - N)))).to(cuda)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(cuda)
    before = q4.qmatmul_int4_planar.launches
    got = q4.qmatmul_int4_planar(a, packed, scales, qblock=block, n=N)
    torch.cuda.synchronize()
    assert q4.qmatmul_int4_planar.launches == before + 1
    want = q4.qmatmul_int4_planar_plain(a, packed, scales, qblock=block, n=N)
    assert got.shape == want.shape == (M, N)
    assert _rel_err(got, want) <= 1e-5


# (B, H, Hkv, L, hd, live rows, cluster). live: None draws a valid length
# per batch row, an int keeps that many rows live in every batch row,
# "masked" also masks batch row 0 entirely (all biases equal: nothing is
# skipped there). cluster: None takes attn_split's C, an int forces it.
# GPT-2's decode shape; L not a multiple of 32 with GQA; hd not a multiple
# of 16 (byte loads); the attn_sweep shapes of chip_smoke.py (the main
# path's first and last steps, full context at batch 8 and 1, a long cache
# mostly empty, GQA rep 4 at hd 128); L not divisible by C; L < C (empty
# chunks); hd 80 (lanes past hd) and 256; MQA (rep 12: three RB passes).
ATTN_CASES = {
    "gpt2": (8, 12, 12, 256, 64, None, None),
    "gqa_l77": (2, 4, 2, 77, 64, None, None),
    "gqa_hd10": (3, 6, 3, 50, 10, None, None),
    "main_pos64": (8, 12, 12, 256, 64, 65, None),
    "main_last_step": (8, 12, 12, 256, 64, 128, None),
    "l1024_full": (8, 12, 12, 1024, 64, 1024, None),
    "b1_l1024_full": (1, 12, 12, 1024, 64, 1024, None),
    "l1024_live257": (8, 12, 12, 1024, 64, 257, None),
    "gqa_rep4_hd128": (8, 32, 8, 1024, 128, 1024, None),
    "l1000_c8": (1, 12, 12, 1000, 64, None, None),
    "l5_below_c8": (2, 4, 2, 5, 64, None, 8),
    "hd128_l77_c2": (2, 8, 2, 77, 128, None, 2),
    "hd80": (2, 4, 4, 64, 80, None, None),
    "hd256": (1, 2, 2, 300, 256, None, None),
    "all_masked_row": (3, 4, 4, 96, 64, "masked", None),
    "mqa_rep12": (2, 12, 1, 200, 64, None, None),
}


def _attn_case(case, cuda):
    """(q, k8, v8, bias, H, cluster) of ATTN_CASES[case], on the card."""
    B, H, Hkv, L, hd, live, split = ATTN_CASES[case]
    rng = np.random.default_rng(L)
    q = torch.from_numpy((rng.standard_normal((B * H, 1, hd))
                          / (127 * np.sqrt(hd))).astype(np.float32)).to(cuda)
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (B * Hkv, L, hd),
                                            dtype=np.int8)).to(cuda)
              for _ in range(2))
    if live is None or live == "masked":
        n_live = rng.integers(1, L + 1, (B, 1))
    else:
        n_live = np.full((B, 1), live)
    valid = np.arange(L)[None, :] < n_live
    if live == "masked":
        valid[0] = False
    bias = torch.from_numpy(np.where(valid, 0.0, -1e9).astype(np.float32)
                            [:, None, :]).to(cuda)
    return q, k8, v8, bias, H, split


def _attn_forms(mxu):
    return ((da.decode_attention_int8_mxu, da.decode_attention_int8_mxu_plain,
             1e-2) if mxu else (da.decode_attention_int8,
                                da.decode_attention_int8_plain, 1e-5))


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_kernels_match_plain(cuda, case, mxu):
    q, k8, v8, bias, H, split = _attn_case(case, cuda)
    kern, plain, tol = _attn_forms(mxu)
    before = kern.launches
    if split is None:
        got = kern(q, k8, v8, bias, n_q_heads=H)
        assert kern.launches == before + 1
    else:  # the wrapper's own launch with the cluster forced
        got = da._launch(kern.__name__, q, k8, v8, bias, H, split=split)
    torch.cuda.synchronize()
    assert _rel_err(got, plain(q, k8, v8, bias, n_q_heads=H)) <= tol


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("case", ["main_pos64", "l1024_live257",
                                  "all_masked_row", "gqa_l77", "l5_below_c8",
                                  "gqa_rep4_hd128"])
def test_attention_rows_read_match_attn_live_chunks(cuda, case, mxu):
    """The K rows the kernel loads are the rows attn_live_chunks calls
    live; at pos 64 and on the long mostly-empty cache that is fewer than
    L."""
    q, k8, v8, bias, H, split = _attn_case(case, cuda)
    B, L = bias.shape[0], bias.shape[-1]
    Hkv = k8.shape[0] // B
    kern, plain, tol = _attn_forms(mxu)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = da._launch(kern.__name__, q, k8, v8, bias, H, split=split,
                     rows_read=counter)
    torch.cuda.synchronize()
    want = da.attn_live_chunks(q, bias, n_q_heads=H, n_kv_heads=Hkv, mxu=mxu)
    assert int(counter.item()) == int(want.sum())
    if case in ("main_pos64", "l1024_live257"):
        assert int(counter.item()) < B * Hkv * L
    assert _rel_err(got, plain(q, k8, v8, bias, n_q_heads=H)) <= tol


@pytest.mark.parametrize("mxu", [False, True])
def test_attention_in_a_cuda_graph_equals_eager(cuda, mxu):
    """Captured once and replayed: the replays equal the eager call bit for
    bit (no atomics, fixed summation order), and the capture counts one
    launch, the replays none."""
    q, k8, v8, bias, H, _ = _attn_case("main_pos64", cuda)
    kern, _, _ = _attn_forms(mxu)
    eager = kern(q, k8, v8, bias, n_q_heads=H)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern(q, k8, v8, bias, n_q_heads=H)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kern.launches
    with collector_held(), torch.cuda.graph(graph):
        out = kern(q, k8, v8, bias, n_q_heads=H)
    assert kern.launches == before + 1
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(out, eager)


@pytest.mark.parametrize("mxu", [False, True])
def test_attention_unaligned_cache_takes_byte_loads(cuda, mxu):
    """A cache 1 byte off 16-byte alignment (hd 64) goes through the
    kernel's byte loads and still matches the plain version."""
    q, k8, v8, bias, H, _ = _attn_case("gqa_l77", cuda)
    kern, plain, tol = _attn_forms(mxu)
    k8u, v8u = (torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
                [1:].view(x.shape).copy_(x) for x in (k8, v8))
    assert k8u.data_ptr() % 16 and k8u.is_contiguous()
    got = kern(q, k8u, v8u, bias, n_q_heads=H)
    torch.cuda.synchronize()
    assert _rel_err(got, plain(q, k8, v8, bias, n_q_heads=H)) <= tol


def test_nibble_probe_on_card(cuda):
    """Every unpack variant the int4 schedules use, bit for bit; 1,001 bytes
    as well, a length the probe's 4-byte words do not divide."""
    for p in (np.arange(256 * 256).reshape(256, 256) % 251,
              np.arange(1001) % 256):
        p = torch.from_numpy(p.astype(np.uint8)).to(cuda)
        plo, phi = q4.nibble_probe_plain(p)
        for variant in q4.NIBBLE_VARIANTS:
            lo, hi = q4.nibble_probe(p, variant)
            torch.cuda.synchronize()
            assert torch.equal(lo, plo) and torch.equal(hi, phi), variant


def _int4_operands(layout, M, K, N, block, rng, cuda):
    """(wrapper, plain, a, packed, scales, kwargs) for an int4 product in
    `layout` with the weight padded to Nw = 256-multiple rows (Nw > N, as
    the quantizer pads it)."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    Nw = -(-N // 256) * 256 + (256 if N % 256 == 0 else 0)
    if layout == "planar":
        packed, scales = pack_int4_planar(w, block)
        scales = np.pad(scales, ((0, 0), (0, Nw - N)))
        fns, kw = (q4.qmatmul_int4_planar, q4.qmatmul_int4_planar_plain), {
            "qblock": block, "n": N}
    else:
        packed, scales = pack_int4(w, block)
        scales = np.pad(scales, ((0, Nw - N), (0, 0)))
        fns, kw = (q4.qmatmul_int4_bf16, q4.qmatmul_int4_bf16_plain), {"n": N}
    packed = np.pad(packed, ((0, Nw - N), (0, 0)))
    a = rng.standard_normal((M, K)).astype(np.float32)
    return (*fns, *(torch.from_numpy(x).to(cuda) for x in (a, packed, scales)),
            kw)


# (M, K, N, block) at the schedules' edges: M at the crossover and one
# above it, 16 and 17; K = 3072 with N = 768; N not a multiple of the mma
# N tile (128) or of small_m's row groups; a quant block of 64 16-byte
# chunks (planar bs 1024: more than a warp's 32 lanes); 25 16-byte steps
# of 16-byte blocks (an odd step count, one lane per block in small_m).
# Every case has Nw > N.
SCHEDULE_CASES = {"m_crossover": (q4.SMALL_M_MAX, 768, 2304, 256),
                  "m_crossover_plus1": (q4.SMALL_M_MAX + 1, 768, 2304, 256),
                  "m16": (16, 768, 2304, 256), "m17": (17, 768, 2304, 256),
                  "m8_k3072_n768": (8, 3072, 768, 256),
                  "m8_n300": (8, 768, 300, 256),
                  "m100_n300": (100, 768, 300, 256),
                  "m3_big_block": (3, 4096, 260, 1024),
                  "m70_big_block": (70, 4096, 260, 1024),
                  "m5_k800_bs16": (5, 800, 130, 32),
                  "m40_k800_bs16": (40, 800, 130, 32)}


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_int4_schedules_match_plain(cuda, case, layout):
    M, K, N, block = SCHEDULE_CASES[case]
    kern, plain, a, packed, scales, kw = _int4_operands(
        layout, M, K, N, block, np.random.default_rng(M + K + N), cuda)
    want_schedule = "small_m" if M <= q4.SMALL_M_MAX else "mma"
    before = dict(kern.schedules)
    got = kern(a, packed, scales, **kw)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in kern.schedules.items()}
    assert moved == {s: int(s == want_schedule) for s in q4.SCHEDULES}, moved
    want = plain(a, packed, scales, **kw)
    assert got.shape == want.shape == (M, N)
    assert _rel_err(got, want) <= 1e-5


def test_int4_entry_points_refuse_a_schedule_that_does_not_fit(
        cuda, monkeypatch):
    """small_m at M = 64 and mma on 21-byte quant blocks: the C entry point
    returns cudaErrorInvalidValue, the wrapper raises and counts nothing."""
    rng = np.random.default_rng(0)
    for layout, M, K, block, schedule in (("planar", 64, 768, 256, "small_m"),
                                          ("interleaved", 64, 768, 256,
                                           "small_m"),
                                          ("planar", 8, 42, 256, "mma"),
                                          ("interleaved", 8, 84, 42, "mma")):
        kern, _, a, packed, scales, kw = _int4_operands(
            layout, M, K, 40, block, rng, cuda)
        monkeypatch.setattr(q4, "int4_schedule",
                            lambda *args, s=schedule, **kws: s)
        before = (kern.launches, dict(kern.schedules))
        with pytest.raises(RuntimeError, match=f"schedule {schedule}"):
            kern(a, packed, scales, **kw)
        assert (kern.launches, kern.schedules) == before


def test_kernels_refuse_cpu_operands_and_wrong_dtypes(cuda):
    a = torch.zeros((2, 64), device=cuda)
    packed = torch.zeros((256, 32), dtype=torch.uint8, device=cuda)
    scales = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="scales"):
        q4.qmatmul_int4_planar(a, packed, scales.cpu())
    with pytest.raises(ValueError, match="a wants"):
        q4.qmatmul_int4_planar(a.double(), packed, scales)
    q = torch.zeros((4, 1, 8), device=cuda)
    kv = torch.zeros((4, 6, 8), dtype=torch.int8, device=cuda)
    bias = torch.zeros((1, 1, 6), device=cuda)
    with pytest.raises(ValueError, match="k8"):
        da.decode_attention_int8(q, kv.float(), kv, bias, n_q_heads=4)
    with pytest.raises(ValueError, match="bias"):
        da.decode_attention_int8_mxu(q, kv, kv, bias.cpu(), n_q_heads=4)


def test_int4_int8kv_generator_on_card_matches_cpu(cuda):
    """A TINY GPT-2 with INT4 weights, INT8 KV and fused attention: the
    card's greedy tokens equal the CPU run's, every MatMulNBits and every
    attention ran on its kernel."""
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                     n_head=4)
    kw = dict(batch=2, prompt_len=8, max_len=32, kv_dtype="int8",
              int4_weights=True, fused_attention=True)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    n_new = 6
    i4, at = q4.qmatmul_int4_planar.launches, da.decode_attention_int8.launches
    card, card_logits = Generator(cfg, **kw).generate(ids, n_new,
                                                      return_logits=True)
    assert q4.qmatmul_int4_planar.launches - i4 == (4 * 2 + 1) * n_new
    assert da.decode_attention_int8.launches - at == 2 * (n_new - 1)
    host, host_logits = Generator(cfg, device="cpu", **kw).generate(
        ids, n_new, return_logits=True)
    np.testing.assert_array_equal(card, host)
    for c, h in zip(card_logits, host_logits):
        np.testing.assert_allclose(c, h, rtol=1e-4, atol=1e-4)


# (M, K, N): BERT-base's four shapes at B = 32, T = 128; M = 1 and 17; K
# not a multiple of 16 (byte loads of a); odd N (scalar stores); more than
# one block tile in both M and N
QMM8_CASES = {"bert_qkvo": (4096, 768, 768), "bert_ffn_in": (4096, 768, 3072),
              "bert_ffn_out": (4096, 3072, 768), "bert_pooler": (32, 768, 768),
              "m1": (1, 768, 768), "m17_k200_n48": (17, 200, 48),
              "odd_n_k13": (5, 13, 3), "m130_n130": (130, 72, 130)}


@pytest.mark.parametrize("case", list(QMM8_CASES))
def test_qmatmul_int8_equals_plain(cuda, case):
    M, K, N = QMM8_CASES[case]
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (K, N), np.int8)).to(cuda)
    before = q8.qmatmul_int8.launches
    got = q8.qmatmul_int8(a, b, packed=q8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, q8.qmatmul_int8_plain(a, b))


@pytest.mark.parametrize("case", list(QMM8_CASES))
def test_qmatmul_int8_requant_equals_plain(cuda, case):
    """The requant epilogue at the same shapes: per-column multipliers
    that put the outputs across the int8 range (some saturate), a bias."""
    M, K, N = QMM8_CASES[case]
    rng = np.random.default_rng(M + K + N + 1)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (K, N), np.int8)).to(cuda)
    sd = 128 * 74 * np.sqrt(K)
    mult = torch.from_numpy((rng.uniform(10, 200, N) / sd).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-50000, 50000, (N,), np.int32)
                            ).to(cuda)
    before = q8.qmatmul_int8.launches
    got = q8.qmatmul_int8_requant(a, b, mult, bias,
                                  packed=q8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (M, N)
    assert torch.equal(got, q8.qmatmul_int8_requant_plain(a, b, mult, bias))


def test_qmatmul_int8_extreme_sums_are_exact(cuda):
    """All -128: every product is +16384, the sum 3072 * 16384 = 50331648;
    through the requant epilogue, with bias -50331648 + k and mult 0.5, the
    sums k = -3..3 land on halves (round half to even) and 300 saturates."""
    a = torch.full((64, 3072), -128, dtype=torch.int8, device=cuda)
    b = torch.full((3072, 64), -128, dtype=torch.int8, device=cuda)
    packed = q8.pack_qmatmul_weight(b)
    got = q8.qmatmul_int8(a, b, packed=packed)
    assert bool((got == 3072 * 16384).all())
    k_off = torch.tensor([-3, -1, 1, 3, 5, 300, -300, 0] * 8,
                         dtype=torch.int32, device=cuda)
    bias = k_off - 3072 * 16384
    q = q8.qmatmul_int8_requant(a, b, torch.tensor(0.5, device=cuda), bias,
                                packed=packed)
    torch.cuda.synchronize()
    want = torch.tensor([-2, 0, 0, 2, 2, 127, -128, 0] * 8,
                        dtype=torch.int8, device=cuda)
    assert bool((q == want).all())


def test_qmatmul_int8_refuses_what_it_cannot_take(cuda):
    a = torch.zeros((8, 64), dtype=torch.int8, device=cuda)
    b = torch.zeros((64, 16), dtype=torch.int8, device=cuda)
    packed = q8.pack_qmatmul_weight(b)
    with pytest.raises(ValueError, match="a wants"):
        q8.qmatmul_int8(a.to(torch.uint8), b, packed=packed)
    with pytest.raises(ValueError, match="packed wants"):
        q8.qmatmul_int8(a, b, packed=packed.cpu())
    with pytest.raises(ValueError, match="contiguous=False"):
        wide = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
        q8.qmatmul_int8(wide[:, ::2], b, packed=packed)
    with pytest.raises(ValueError, match="pre-packed"):
        q8.qmatmul_int8(a, b)
    with pytest.raises(ValueError, match="packed weight"):
        q8.qmatmul_int8(a, b, packed=packed[:, :32].contiguous())


# (M, K, N, block): GPT-2 124M's decode-step (M = 8) and prefill (M = 512)
# shapes, the lm_head's N = 50257 among them; M = 1 and 17; K = 200 (one
# block of 200); N = 48 and 130; a block of 42 (21 bytes: byte loads)
INT4_BF16_CASES = {"step_qkv": (8, 768, 2304, 256),
                   "step_mlp_proj": (8, 3072, 768, 256),
                   "step_lm_head": (8, 768, 50257, 256),
                   "prefill_fc": (512, 768, 3072, 256),
                   "m1": (1, 768, 768, 256), "m17_k200_n48": (17, 200, 48, 256),
                   "bs64_n130": (3, 384, 130, 64), "odd_qbh21": (3, 84, 33, 42)}


@pytest.mark.parametrize("case", list(INT4_BF16_CASES))
def test_int4_bf16_kernel_matches_plain(cuda, case):
    M, K, N, block = INT4_BF16_CASES[case]
    rng = np.random.default_rng(M + K)
    packed, scales = pack_int4(rng.standard_normal((K, N)).astype(np.float32),
                               block)
    Nw = -(-N // 256) * 256  # rows past N, as a padded weight carries them
    packed = torch.from_numpy(np.pad(packed, ((0, Nw - N), (0, 0)))).to(cuda)
    scales = torch.from_numpy(np.pad(scales, ((0, Nw - N), (0, 0)))).to(cuda)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)
                         ).to(cuda)
    before = q4.qmatmul_int4_bf16.launches
    got = q4.qmatmul_int4_bf16(a, packed, scales, n=N)
    torch.cuda.synchronize()
    assert q4.qmatmul_int4_bf16.launches == before + 1
    want = q4.qmatmul_int4_bf16_plain(a, packed, scales, n=N)
    assert got.shape == want.shape == (M, N)
    assert _rel_err(got, want) <= 1e-5


def test_int4_bf16_refuses_what_it_cannot_take(cuda):
    a = torch.zeros((2, 64), device=cuda)
    packed = torch.zeros((32, 32), dtype=torch.uint8, device=cuda)
    scales = torch.zeros((32, 1), device=cuda)
    with pytest.raises(ValueError, match="scales wants"):
        q4.qmatmul_int4_bf16(a, packed, scales.cpu())
    with pytest.raises(ValueError, match="a wants"):
        q4.qmatmul_int4_bf16(a.double(), packed, scales)
    with pytest.raises(ValueError, match="contiguous=False"):
        wide = torch.zeros((32, 64), dtype=torch.uint8, device=cuda)
        q4.qmatmul_int4_bf16(a, wide[:, ::2], scales)
    with pytest.raises(ValueError, match="interleaved"):
        q4.qmatmul_int4_bf16(a, packed[:, :16].contiguous(), scales)


def test_bert_int8_engine_on_card_matches_cpu(cuda):
    """BERT with BERT-base's 12 layers at hidden 64: 73 int8 GEMM launches
    per INT8 forward, and the card's int8 values against the CPU's."""
    cfg = BertConfig(vocab_size=500, max_positions=64, hidden=64, n_layer=12,
                     n_head=4)
    B, T = 2, 16
    g = import_model(build_bert(cfg, batch=B, seq_len=T, seed=0))
    rng = np.random.default_rng(0)
    feed = {"input_ids": rng.integers(0, cfg.vocab_size, (B, T)),
            "token_type_ids": rng.integers(0, 2, (B, T)),
            "attention_mask": (np.arange(T)[None] < np.array([[T], [9]])
                               ).astype(np.int64)}
    q = quantize_graph(g, ranges=calibrate(g, [feed], device="cpu"))
    probe = probe_graph(q)
    before = (q8.qmatmul_int8.launches, dict(q8.qmatmul_int8.epilogues))
    card = Engine(probe)(feed)
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.launches - before[0] == 73
    assert q8.qmatmul_int8.epilogues["requant"] - before[1]["requant"] == 73
    host = Engine(probe, device="cpu")(feed)
    n_eq = n_all = 0
    for name, v in host.items():
        if v.dtype == torch.int8:
            n_eq += int((card[name].cpu() == v).sum())
            n_all += v.numel()
    assert n_all > 0 and n_eq / n_all > 0.99, n_eq / n_all
    for name in ("last_hidden_state", "pooler_output"):
        assert _rel_err(card[name].cpu(), host[name]) <= 1e-2, name


def test_ort_int4_generator_on_card_matches_cpu(cuda):
    """GPT-2 with GPT-2 124M's 12 layers at n_embd 64, its weights in the
    interleaved ORT int4 form carried as ONNX bytes, INT8 KV and fused
    attention: 49 interleaved int4 launches per pass and no planar one;
    the prefill's and a teacher-forced step's logits against the CPU's."""
    cfg = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=12,
                     n_head=4)
    gen = Generator(cfg, batch=2, prompt_len=8, max_len=32, kv_dtype="int8",
                    fused_attention=True)
    ort_int4_generator(gen)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))
    n_new = 6
    i4, pl = q4.qmatmul_int4_bf16.launches, q4.qmatmul_int4_planar.launches
    toks, _ = gen.generate(ids, n_new)
    torch.cuda.synchronize()
    assert q4.qmatmul_int4_bf16.launches - i4 == 49 * n_new
    assert q4.qmatmul_int4_planar.launches == pl
    host = gen.to("cpu")
    card_l, card_cache = gen.start(ids)
    host_l, host_cache = host.start(ids)
    assert _rel_err(card_l.cpu(), host_l) <= 1e-2
    tok = torch.from_numpy(toks[:, 0])
    card_l, _ = gen.step(card_cache, tok.to(cuda), 8)
    host_l, _ = host.step(host_cache, tok, 8)
    assert _rel_err(card_l.cpu(), host_l) <= 1e-2


# --------------------------------------------------------------------------
# whole-graph capture, the K-step device loop and the servers on the card
# --------------------------------------------------------------------------
def _captured_cases():
    """(graph, two feeds, kernel wrapper, launches per forward): the small
    INT8 CNN of test_int8_engine_on_card_matches_cpu and BERT with 12
    layers at hidden 64."""
    rng = np.random.default_rng(3)
    g = import_model(_small_cnn())
    xs = [rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
          for _ in range(2)]
    cnn = quantize_graph(g, ranges=calibrate(g, [{"x": xs[0]}],
                                             device="cpu"))
    cfg = BertConfig(vocab_size=500, max_positions=64, hidden=64, n_layer=12,
                     n_head=4)
    B, T = 2, 16
    bg = import_model(build_bert(cfg, batch=B, seq_len=T, seed=0))
    feeds = [{"input_ids": rng.integers(0, cfg.vocab_size, (B, T)),
              "token_type_ids": rng.integers(0, 2, (B, T)),
              "attention_mask": (np.arange(T)[None] < np.array([[T], [n]])
                                 ).astype(np.int64)} for n in (9, 13)]
    bert = quantize_graph(bg, ranges=calibrate(bg, feeds[:1],
                                               device="cpu"))
    return {"cnn_int8": (cnn, [{"x": x} for x in xs], k.qconv_int8_requant,
                         5),
            "bert_int8": (bert, feeds, q8.qmatmul_int8, 73)}


def test_capture_holds_the_collector_off(cuda):
    """A graph held only by a reference cycle, collected while another
    graph captures, invalidates that capture (the capture then fails at
    its end). capture() holds the cycle collector off: with a threshold
    that collects at every allocation and such a cycle made inside the
    capture, no collection starts there, and the replay is right. The
    same allocations outside a capture do collect, and the cycle goes."""
    import gc
    import weakref

    from onnx_rusty_inference_engine_tpu_torch.engine import (
        capture, side_stream)

    class Box:
        pass

    x = torch.arange(1024, dtype=torch.float32, device=cuda)
    s = torch.cuda.Stream()
    inside, runs, holder, dead = [False], [], [], []

    def body(capturing=False):
        inside[0] = capturing
        if capturing:               # the old graph, held by a new cycle
            box = Box()
            box.replay, box.self = holder.pop(), box
            dead.append(weakref.ref(box))
            del box
        _ = [[] for _ in range(5000)]
        inside[0] = False
        return x + 1

    with side_stream(s):
        x * 2
        body()
        holder.append(capture(lambda: x * 2, stream=s)[1])

    def seen(phase, info):
        if phase == "start":
            runs.append(inside[0])

    threshold = gc.get_threshold()
    gc.callbacks.append(seen)
    try:
        gc.set_threshold(1)
        with side_stream(s):
            out, replay = capture(lambda: body(True), stream=s)
        assert True not in runs
        runs.clear()
        _ = [[] for _ in range(5000)]
        assert runs                        # the same churn collects outside
    finally:
        gc.set_threshold(*threshold)
        gc.callbacks.remove(seen)
    gc.collect()
    assert dead[0]() is None
    out.zero_()
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x + 1)


@pytest.mark.parametrize("case", ["cnn_int8", "bert_int8"])
def test_captured_engine_equals_eager_and_counts_replays(cuda, case):
    """An Engine's first call runs eagerly and captures; its replays, over
    two inputs, equal the eager function bit for bit; a returned output is
    the caller's (the next call does not overwrite it); and N replays
    count N forwards' launches."""
    graph, feeds, wrapper, per_forward = _captured_cases()[case]
    eng = Engine(graph)
    first = eng(feeds[0])                         # eager + capture
    with torch.no_grad():
        eager = [eng._fn(eng.params, {n: torch.as_tensor(v, device=cuda)
                                      for n, v in f.items()})
                 for f in feeds]
    for name, v in eager[0].items():
        assert torch.equal(first[name], v), name
    kept = None
    for f, want in zip(feeds * 2, eager * 2):     # replays
        got = eng(f)
        for name, v in want.items():
            assert torch.equal(got[name], v), name
        if kept is None:
            kept = (got, {n: v.clone() for n, v in got.items()})
    for name, v in kept[1].items():               # not overwritten since
        assert torch.equal(kept[0][name], v), name
    torch.cuda.synchronize()
    before = wrapper.launches
    for _ in range(5):
        eng(feeds[1])
    torch.cuda.synchronize()
    assert wrapper.launches - before == 5 * per_forward
    assert len(eng._graphs) == 1


def test_engine_captures_one_graph_per_signature(cuda):
    graph, feeds, wrapper, per_forward = _captured_cases()["cnn_int8"]
    eng = Engine(graph)
    for f in (feeds[0], {"x": feeds[0]["x"][:2]}, feeds[1],
              {"x": feeds[1]["x"][:2]}):
        eng(f)
    assert len(eng._graphs) == 2
    half = eng({"x": feeds[1]["x"][:2]})
    with torch.no_grad():
        want = eng._fn(eng.params, {"x": torch.as_tensor(
            feeds[1]["x"][:2], device=cuda)})
    for name, v in want.items():
        assert torch.equal(half[name], v), name


_TINY4 = GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                    n_head=4)


@pytest.mark.parametrize("kw", [
    {}, {"temperature": 0.8, "top_k": 20, "sample_seed": 7},
    {"temperature": 1.0, "top_p": 0.9, "repetition_penalty": 1.2,
     "sample_seed": 3}], ids=["greedy", "sampled", "sampled_penalty"])
def test_device_loop_equals_host_loop_on_card(cuda, kw):
    """Generator(device_loop=4) on the card: K steps as one replayed CUDA
    graph give the host loop's tokens, greedy and seeded sampling, with
    one int4 launch per MatMulNBits and one attention launch per layer per
    step counted over the replays."""
    gkw = dict(batch=2, prompt_len=8, max_len=32, kv_dtype="int8",
               int4_weights=True, fused_attention=True)
    ids = np.random.default_rng(0).integers(0, _TINY4.vocab_size, (2, 8))
    host = Generator(_TINY4, **gkw)
    dev = Generator(_TINY4, device_loop=4, **gkw)
    want, _ = host.generate(ids, 11, **kw)
    got, _ = dev.generate(ids, 11, **kw)            # eager block + capture
    np.testing.assert_array_equal(got, want)
    torch.cuda.synchronize()
    i4, at = q4.qmatmul_int4_planar.launches, da.decode_attention_int8.launches
    again, _ = dev.generate(ids, 11, **kw)          # prefill + 3 replays
    torch.cuda.synchronize()
    np.testing.assert_array_equal(again, want)
    assert q4.qmatmul_int4_planar.launches - i4 == 9 * (1 + 3 * 4)
    assert da.decode_attention_int8.launches - at == 2 * 3 * 4


def test_decode_server_multi_step_equals_single_step_on_card(cuda):
    """DecodeServer(multi_step=4) on the card (INT4 weights, INT8 KV,
    prompt buckets): every greedy request's tokens equal multi_step=0's."""
    from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer

    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, _TINY4.vocab_size, (int(n),)), int(m))
            for n, m in zip(rng.integers(2, 17, 6), rng.integers(3, 12, 6))]
    outs = {}
    for K in (0, 4):
        srv = DecodeServer(_TINY4, slots=4, prompt_len=16, max_len=32,
                           kv_dtype="int8", int4_weights=True,
                           prompt_buckets=(8, 16), multi_step=K)
        try:
            futs = [srv.submit(p, n) for p, n in reqs]
            outs[K] = [f.result(timeout=300) for f in futs]
        finally:
            srv.stop()
    assert outs[4] == outs[0]
    assert [len(o) for o in outs[0]] == [n for _, n in reqs]


def test_inference_server_on_card_equals_engine(cuda):
    from onnx_rusty_inference_engine_tpu_torch.serve import InferenceServer

    graph, feeds, _, _ = _captured_cases()["cnn_int8"]
    eng = Engine(graph)
    x = feeds[0]["x"]
    srv = InferenceServer(eng, batch_buckets=(1, 2, 4), max_delay_s=0.5,
                          warmup=True, example_shape=(3, 32, 32),
                          autostart=False)
    assert len(eng._graphs) == 3
    futs = [srv.submit(x[i]) for i in range(3)]
    srv.start()
    try:
        outs = [f.result(timeout=300)["prob"] for f in futs]
    finally:
        srv.stop()
    padded = np.concatenate([x[:3], np.zeros_like(x[:1])])
    with torch.no_grad():
        want = eng._fn(eng.params, {"x": torch.as_tensor(padded,
                                                         device=cuda)})
    np.testing.assert_array_equal(np.concatenate(outs),
                                  want["prob"][:3].cpu().numpy())


# --------------------------------------------------------------------------
# the Llama slice on the card: GQA at 4 query heads per KV head and head
# dim 128, the int4 KV cache, and the int4 down projection's schedule
# --------------------------------------------------------------------------
_GQA = LlamaConfig(vocab_size=256, max_positions=64, dim=512, n_layer=2,
                   n_head=4, n_kv_head=1, ffn_mult=2)


@pytest.mark.parametrize("K,schedule", [(4096, "small_m"), (16384, "mma")])
def test_int4_decode_m8_schedule_by_k(cuda, K, schedule):
    """At M = 8 a Llama step's int4 products stage A in small_m's shared
    memory up to K = 4096; the down projection (K = 16384) does not fit
    and runs on mma. Both equal the plain version."""
    kern, plain, a, packed, scales, kw = _int4_operands(
        "planar", 8, K, 512, 256, np.random.default_rng(K), cuda)
    nblk, blk = q4.planar_layout(K, 256)
    assert q4.int4_schedule(8, K, nblk, blk) == schedule
    before = dict(kern.schedules)
    got = kern(a, packed, scales, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in kern.schedules.items()} == {
        s: int(s == schedule) for s in q4.SCHEDULES}
    assert _rel_err(got, plain(a, packed, scales, **kw)) <= 1e-5


def _teacher_forced_errors(gen, ids, toks, steps):
    """The prefill and `steps` steps on the card and through the plain
    versions on the CPU, both fed the card's tokens: each pass's max
    |difference| / max |logit|. The card's teacher-forced passes repeat
    its own greedy tokens."""
    cpu = gen.to("cpu")
    P = ids.shape[1]
    card_l, card_c = gen.start(ids)
    host_l, host_c = cpu.start(ids)
    errs = []
    for t in range(steps + 1):
        c, h = card_l[:, -1].cpu(), host_l[:, -1]
        errs.append(float((c - h).abs().max() / h.abs().max()))
        np.testing.assert_array_equal(c.argmax(-1).numpy(), toks[:, t])
        if t == steps:
            break
        tok = torch.from_numpy(toks[:, t])
        card_l, card_c = gen.step(card_c, tok.to(gen.device), P + t)
        host_l, host_c = cpu.step(host_c, tok, P + t)
    return errs


def test_llama_gqa_decode_on_card_matches_cpu(cuda):
    """Generator(family="llama") at GQA rep 4, hd 128 with INT4 weights,
    an INT8 KV cache and fused attention: 15 int4 launches per pass, each
    on int4_schedule's pick, 2 attention launches per step; every pass
    re-run through the plain versions on the CPU with the card's tokens
    within 1e-2 x max|logit| (both int4 forms round A to bf16)."""
    kw = dict(batch=2, prompt_len=8, max_len=32, family="llama",
              kv_dtype="int8", int4_weights=True, fused_attention=True)
    ids = np.random.default_rng(5).integers(0, _GQA.vocab_size, (2, 8))
    n_new = 6
    gen = Generator(_GQA, **kw)
    i4, at = q4.qmatmul_int4_planar.launches, da.decode_attention_int8.launches
    sched = dict(q4.qmatmul_int4_planar.schedules)
    toks, _ = gen.generate(ids, n_new)
    torch.cuda.synchronize()
    assert q4.qmatmul_int4_planar.launches - i4 == (7 * 2 + 1) * n_new
    assert da.decode_attention_int8.launches - at == 2 * (n_new - 1)
    assert {k: v - sched[k] for k, v in
            q4.qmatmul_int4_planar.schedules.items()} == _int4_picks(
        gen, "qmatmul_int4_planar", 16, 2, n_new - 1)
    assert max(_teacher_forced_errors(gen, ids, toks, n_new - 1)) <= 1e-2


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_int4_kv_decode_on_card_matches_cpu(cuda, family):
    """kv_dtype="int4" (the nibble-packed cache, fp32 weights) on the card:
    the cache is packed int8 [B, Hkv, L, hd/2], no kernel of the port runs
    (the pack and unpack are elementwise), and every pass re-run on the
    CPU with the card's tokens is within 1e-3 x max|logit|."""
    cfg = _GQA if family == "llama" else _TINY4
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 8))
    gen = Generator(cfg, batch=2, prompt_len=8, max_len=32, family=family,
                    kv_dtype="int4")
    i4 = q4.qmatmul_int4_planar.launches
    toks, _ = gen.generate(ids, 6)
    _, cache = gen.start(ids)
    heads = getattr(cfg, "n_kv_head", cfg.n_head)
    assert cache["past_key_0"].dtype == torch.int8
    assert tuple(cache["past_key_0"].shape) == (2, heads, 32,
                                                cfg.head_dim // 2)
    assert q4.qmatmul_int4_planar.launches == i4
    assert max(_teacher_forced_errors(gen, ids, toks, 5)) <= 1e-3


def _llama_step_feeds(kv, rng):
    """Two decode-step feeds of _GQA at batch 2, max_len 32: per-slot
    positions, a random cache (int8, or nibble-packed int8) and scales."""
    feeds = []
    for pos in ((3, 17), (9, 30)):
        feed = {"input_ids": rng.integers(0, _GQA.vocab_size, (2, 1)),
                "pos": np.array(pos, np.int64)}
        for i in range(_GQA.n_layer):
            for kind in ("key", "value"):
                width = _GQA.head_dim // (2 if kv == "int4" else 1)
                feed[f"past_{kind}_{i}"] = rng.integers(
                    -128, 128, (2, 1, 32, width)).astype(np.int8)
                feed[f"kv_scale_{kind}_{i}"] = (
                    rng.random(1) * 0.05 + 0.02).astype(np.float32)
        feeds.append(feed)
    return feeds


@pytest.mark.parametrize("kv", ["int8_fused_int4w", "int4"])
def test_llama_step_captured_equals_eager(cuda, kv):
    """The Llama decode step's captured graph (the RoPE Gather at pos [B],
    GQA attention, the int4 KV pack and unpack) replays equal to the eager
    function bit for bit, for two inputs."""
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        quantize_weights_int4)

    if kv == "int4":
        g = import_model(build_llama_decode(_GQA, batch=2, max_len=32,
                                            kv_dtype="int4"))
    else:
        g = quantize_weights_int4(import_model(build_llama_decode(
            _GQA, batch=2, max_len=32, kv_dtype="int8",
            fused_attention=True)))
    feeds = _llama_step_feeds("int4" if kv == "int4" else "int8",
                              np.random.default_rng(7))
    eng = Engine(g)
    first = eng(feeds[0])                         # eager + capture
    with torch.no_grad():
        eager = [eng._fn(eng.params, {n: torch.as_tensor(v, device=cuda)
                                      for n, v in f.items()})
                 for f in feeds]
    for name, v in eager[0].items():
        assert torch.equal(first[name], v), name
    for f, want in zip(feeds * 2, eager * 2):     # replays
        got = eng(f)
        for name, v in want.items():
            assert torch.equal(got[name], v), name
    assert len(eng._graphs) == 1


# --------------------------------------------------------------------------
# the vision slice: the grouped int8 conv, QLinearAdd, the N = 1000 heads
# --------------------------------------------------------------------------
def _mobilenet_depthwise_convs(size: int = 224):
    """(C, H, stride) of MobileNetV2's 17 depthwise convs at size x size,
    in graph order (models/mobilenet.py's inverted residual config)."""
    from onnx_rusty_inference_engine_tpu_torch.models.mobilenet import (
        _IR_CFG)

    out, h, c_in = [], size // 2, 32
    for t, c, n, s in _IR_CFG:
        for i in range(n):
            stride = s if i == 0 else 1
            out.append((c_in * t, h, stride))
            h = -(-h // stride)
            c_in = c
    return out


def _grouped_operands(B, C, H, W, O, group, ksz, rng, dev):
    x = torch.from_numpy(rng.integers(-128, 128, (B, C, H, W),
                                      dtype=np.int8)).to(dev)
    w = torch.from_numpy(rng.integers(-127, 128, (O, C // group, ksz, ksz),
                                      dtype=np.int8)).to(dev)
    mult = torch.from_numpy((np.abs(rng.standard_normal(O)) * 2e-3 + 1e-3)
                            .astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.integers(-3000, 3000, (O,),
                                         dtype=np.int32)).to(dev)
    return x, w, mult, bias


@pytest.mark.parametrize("C,H,s", _mobilenet_depthwise_convs(),
                         ids=[f"block{i}_c{c}_h{h}_s{s}" for i, (c, h, s)
                              in enumerate(_mobilenet_depthwise_convs())])
def test_grouped_kernel_equals_plain_at_every_mobilenet_b256_depthwise(
        cuda, C, H, s):
    """Each of MobileNetV2's 17 depthwise convs at b256 (3x3, pad 1), on
    channels-last input as the expand conv leaves it: the tile form, bit
    for bit, and a channels-last int8 output."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    x, w, mult, bias = _grouped_operands(256, C, H, H, C, C, 3,
                                         np.random.default_rng(C + H), cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, stride=(s, s), padding=((1, 1), (1, 1)),
        packed=g8.pack_qconv_grouped_weight(w))
    torch.cuda.synchronize()
    assert (g8.qconv_grouped_int8_requant.schedules["tile"]
            == before["tile"] + 1)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = g8.qconv_grouped_int8_requant_plain(
        x, w, mult, bias, stride=(s, s), padding=((1, 1), (1, 1)))
    assert torch.equal(got, want)


# (B, C, H, W, O, group, kernel, stride, pads (t, b, l, r), layout)
GROUPED_CASES = {
    "dw_c6_unaligned": (3, 6, 9, 7, 6, 6, 3, 1, (1, 1, 1, 1), "cl"),
    "dw_c4_nchw_input": (2, 4, 8, 8, 4, 4, 3, 2, (1, 1, 1, 1), "nchw"),
    "dw_c36_asym_pad": (2, 36, 10, 9, 36, 36, 3, 2, (1, 0, 2, 1), "cl"),
    "dw_5x5_c20": (2, 20, 13, 11, 20, 20, 5, 1, (2, 2, 2, 2), "cl"),
    "group2_c16_o24": (2, 16, 8, 9, 24, 2, 3, 1, (1, 1, 1, 1), "cl"),
    "group2_c10_o6": (1, 10, 6, 7, 6, 2, 3, 2, (1, 1, 1, 1), "cl"),
    "dw_multiplier2": (2, 8, 7, 7, 16, 8, 3, 1, (1, 1, 1, 1), "cl"),
    "group4_1x1": (2, 16, 5, 5, 32, 4, 1, 1, (0, 0, 0, 0), "nchw"),
    "dw_c960_7x7": (4, 960, 7, 7, 960, 960, 3, 1, (1, 1, 1, 1), "cl"),
}


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_kernel_equals_plain(cuda, case):
    """Unaligned channel counts, NCHW inputs, asymmetric padding, other
    kernel sizes and group > 1 beyond depthwise (the general form), bit
    for bit; the launch counted in the form grouped_plan picks."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    B, C, H, W, O, group, ksz, s, (pt, pb, pl, pr), layout = \
        GROUPED_CASES[case]
    x, w, mult, bias = _grouped_operands(B, C, H, W, O, group, ksz,
                                         np.random.default_rng(B * C + O),
                                         cuda)
    if layout == "cl":
        x = x.contiguous(memory_format=torch.channels_last)
    padding = ((pt, pb), (pl, pr))
    mode = g8.grouped_plan(x.shape, w.shape, (s, s), padding,
                           g8.input_align(x))["form"]
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, stride=(s, s), padding=padding,
        packed=g8.pack_qconv_grouped_weight(w))
    torch.cuda.synchronize()
    assert g8.qconv_grouped_int8_requant.schedules[mode] == before[mode] + 1
    want = g8.qconv_grouped_int8_requant_plain(x, w, mult, bias,
                                               stride=(s, s),
                                               padding=padding)
    assert torch.equal(got, want)
    # no bias and a scalar multiplier
    got = g8.qconv_grouped_int8_requant(
        x, w, mult[0], None, stride=(s, s), padding=padding,
        packed=g8.pack_qconv_grouped_weight(w))
    want = g8.qconv_grouped_int8_requant_plain(x, w, mult[0], None,
                                               stride=(s, s),
                                               padding=padding)
    assert torch.equal(got, want)


# the tile form at its edges: (B, C, H, W, stride, pads (t, b, l, r), the
# plan's constants narrowed so that the shape splits into many tiles or a
# channel run that does not divide C, the input's byte offset from an
# aligned base: 4 and 1 take the general form)
TILE_EDGE_CASES = {
    "ragged_hw_s1": (2, 32, 29, 23, 1, (1, 1, 1, 1),
                     {"TILE_BUF": 4096, "TILE_THREADS": 64}, 0),
    "ragged_hw_s2": (2, 32, 29, 23, 2, (1, 1, 1, 1),
                     {"TILE_BUF": 4096, "TILE_THREADS": 64}, 0),
    "odd_hw_many_tiles_s2": (1, 16, 33, 35, 2, (1, 1, 1, 1),
                             {"TILE_BUF": 2048, "TILE_THREADS": 32}, 0),
    "c48_run32_s1": (2, 48, 15, 13, 1, (1, 1, 1, 1),
                     {"TILE_RUNS": (32,), "TILE_WHOLE": 0}, 0),
    "c48_run32_s2": (2, 48, 15, 13, 2, (1, 1, 1, 1),
                     {"TILE_RUNS": (32,), "TILE_WHOLE": 0}, 0),
    "c80_run64_s1": (2, 80, 9, 12, 1, (1, 1, 1, 1),
                     {"TILE_RUNS": (64,), "TILE_WHOLE": 0}, 0),
    "c80_run64_s2": (2, 80, 9, 12, 2, (1, 1, 1, 1),
                     {"TILE_RUNS": (64,), "TILE_WHOLE": 0}, 0),
    "spatial_1x1_s1": (3, 64, 1, 1, 1, (1, 1, 1, 1), {}, 0),
    "spatial_1x1_s2": (3, 64, 1, 1, 2, (1, 1, 1, 1), {}, 0),
    "batch1_s1": (1, 144, 56, 56, 1, (1, 1, 1, 1), {}, 0),
    "batch1_s2": (1, 96, 112, 112, 2, (1, 1, 1, 1), {}, 0),
    "odd_h_s2": (2, 32, 27, 20, 2, (1, 1, 1, 1), {}, 0),
    "asym_pad_s2": (2, 32, 10, 11, 2, (1, 0, 2, 1), {}, 0),
    "no_pad_s1": (2, 16, 9, 8, 1, (0, 0, 0, 0), {}, 0),
    "unaligned_base4_s1": (2, 32, 14, 14, 1, (1, 1, 1, 1), {}, 4),
    "unaligned_base1_s2": (2, 32, 14, 14, 2, (1, 1, 1, 1), {}, 1),
}


def _offset_input(x, offset):
    """x [B, C, H, W] as a channels-last view whose data starts `offset`
    bytes past an aligned allocation."""
    B, C, H, W = x.shape
    base = torch.empty(B * H * W * C + offset, dtype=torch.int8,
                       device=x.device)
    xl = base[offset:].view(B, H, W, C)
    xl.copy_(x.permute(0, 2, 3, 1))
    return xl.permute(0, 3, 1, 2)


@pytest.mark.parametrize("case", list(TILE_EDGE_CASES))
def test_grouped_tile_edges_equal_plain(cuda, case, monkeypatch):
    """Depthwise 3x3 at both strides where tiles meet the image's edges:
    H and W not multiples of the tile, a channel run that does not divide
    C, 1x1 images, batch 1, odd H at stride 2, asymmetric and no padding,
    and inputs off a 16-byte boundary (the general form); bit for bit,
    counted in the form the plan gives."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    B, C, H, W, s, (pt, pb, pl, pr), consts, offset = TILE_EDGE_CASES[case]
    for k, v in consts.items():
        monkeypatch.setattr(g8, k, v)
    x, w, mult, bias = _grouped_operands(B, C, H, W, C, C, 3,
                                         np.random.default_rng(B * C + H),
                                         cuda)
    x = _offset_input(x, offset)
    padding = ((pt, pb), (pl, pr))
    plan = g8.grouped_plan(x.shape, w.shape, (s, s), padding,
                           g8.input_align(x))
    assert plan["form"] == ("tile" if offset == 0 else "general")
    if "TILE_RUNS" in consts:
        assert C % plan["run"] != 0
    if "TILE_BUF" in consts:
        assert plan["tiles"] >= 4 * B
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, stride=(s, s), padding=padding,
        packed=g8.pack_qconv_grouped_weight(w))
    torch.cuda.synchronize()
    after = g8.qconv_grouped_int8_requant.schedules
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == plan["form"]) for k in after}
    want = g8.qconv_grouped_int8_requant_plain(x, w, mult, bias,
                                               stride=(s, s),
                                               padding=padding)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [1, 2])
def test_grouped_tile_extreme_bias_and_ties(cuda, s):
    """Biases up to 2^30 on every third channel (their sums leave the
    range where the epilogue's float trick is exact, so those threads take
    __int2float_rn), multipliers of 0.5 on every fifth (many results on a
    rounding tie) and weights of -128: bit for bit."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    rng = np.random.default_rng(17 + s)
    x, w, mult, bias = _grouped_operands(4, 64, 20, 18, 64, 64, 3, rng,
                                         cuda)
    w[::7] = -128
    bias[::3] = torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, bias[::3]
                                              .shape, dtype=np.int32)).to(cuda)
    mult[::5] = 0.5
    x = x.contiguous(memory_format=torch.channels_last)
    kw = dict(stride=(s, s), padding=((1, 1), (1, 1)))
    got = g8.qconv_grouped_int8_requant(
        x, w, mult, bias, packed=g8.pack_qconv_grouped_weight(w), **kw)
    assert torch.equal(got, g8.qconv_grouped_int8_requant_plain(
        x, w, mult, bias, **kw))


def test_grouped_forms_agree_at_a_tile_shape(cuda, monkeypatch):
    """At a MobileNetV2 shape (b8) the tile form and the general form (the
    same input 4 bytes off a 16-byte boundary) give the plain version's
    bytes; a plan whose box does not hold its tile's reads is refused by
    the kernel's entry point."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    x, w, mult, bias = _grouped_operands(8, 144, 56, 56, 144, 144, 3,
                                         np.random.default_rng(5), cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    packed = g8.pack_qconv_grouped_weight(w)
    kw = dict(stride=(1, 1), padding=((1, 1), (1, 1)))
    want = g8.qconv_grouped_int8_requant_plain(x, w, mult, bias, **kw)
    for offset, form in ((0, "tile"), (4, "general")):
        got, used, _ = g8._launch(_offset_input(x, offset), w, mult, bias,
                                  kw["stride"], kw["padding"], packed)
        torch.cuda.synchronize()
        assert used == form and torch.equal(got, want), form
    tile = g8._tile

    def short_box(*a):
        plan = tile(*a)
        bh, bw, run = plan["box"]
        return {**plan, "box": (bh - 1, bw, run)}

    monkeypatch.setattr(g8, "_tile", short_box)
    with pytest.raises(RuntimeError, match="tile"):
        g8._launch(x, w, mult, bias, kw["stride"], kw["padding"], packed)


def test_grouped_kernel_in_a_cuda_graph_equals_eager(cuda):
    """Captured into a CUDA graph (launched on the capturing stream, no
    sync, no allocation of its own), replays give the eager bytes."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    x, w, mult, bias = _grouped_operands(8, 144, 28, 28, 144, 144, 3,
                                         np.random.default_rng(3), cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    packed = g8.pack_qconv_grouped_weight(w)

    def run():
        return g8.qconv_grouped_int8_requant(
            x, w, mult, bias, stride=(2, 2), padding=((1, 1), (1, 1)),
            packed=packed)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_held(), torch.cuda.graph(graph):
        out = run()
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    x.copy_(torch.roll(x, 1, dims=0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, run())


def test_qlinear_add_keeps_channels_last(cuda):
    """QLinearAdd of two channels-last int8 tensors (the conv kernels'
    output) returns channels-last, so the next conv reads it uncopied;
    its values equal the CPU's bit for bit."""
    from onnx_rusty_inference_engine_tpu_torch.ops.quantized import (
        _qlinear_binary)

    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(-128, 128, (4, 64, 14, 14),
                                          dtype=np.int8)) for _ in range(2))
    scales = [torch.tensor(v, dtype=torch.float32)
              for v in (0.05, 0.025, 0.1)]
    zp = torch.tensor(0, dtype=torch.int8)
    emit = _qlinear_binary(torch.add)

    def ins(dev, cl):
        a2, b2 = (t.to(dev) for t in (a, b))
        if cl:
            a2, b2 = (t.contiguous(memory_format=torch.channels_last)
                      for t in (a2, b2))
        s = [v.to(dev) for v in scales]
        z = zp.to(dev)
        return [a2, s[0], z, b2, s[1], z, s[2], z]

    (got,) = emit(None, None, ins(cuda, True))
    (want,) = emit(None, None, ins("cpu", False))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("M,K", [(256, 2048), (256, 1280), (64, 768),
                                 (1, 2048)])
def test_classifier_head_n1000_equals_plain(cuda, M, K):
    """The vision models' heads as QLinearMatMul: N = 1000, not a multiple
    of 16, through both epilogues, bit for bit."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K),
                                      dtype=np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (K, 1000),
                                      dtype=np.int8)).to(cuda)
    mult = torch.from_numpy((np.abs(rng.standard_normal(1000)) * 1e-4
                             + 1e-5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-5000, 5000, (1000,),
                                         dtype=np.int32)).to(cuda)
    packed = q8.pack_qmatmul_weight(b)
    got = q8.qmatmul_int8_requant(a, b, mult, bias, packed=packed)
    assert torch.equal(got, q8.qmatmul_int8_requant_plain(a, b, mult, bias))
    got32 = q8.qmatmul_int8(a, b, packed=packed)
    assert torch.equal(got32, q8.qmatmul_int8_plain(a, b))


# --------------------------------------------------------------------------
# bf16 and dynamic W8A8: MatMulInteger on the int8 kernel, bf16 A into the
# int4 kernels, the bf16 and W8A8 Engines captured
# --------------------------------------------------------------------------
# (lead, M, K, N): W8A8 BERT-base at B 32, T 128 (a [32, 128, K]); GPT-2
# 124M's prefill at batch 8, prompt 64, its lm_head's odd N = 50,257
# among them; Llama's FFN at dim 4096; K not a multiple of 16 (a padded
# copy of a) with a small odd N
MATMUL_INTEGER_CASES = {
    "bert_qkvo": (32, 128, 768, 768), "bert_ffn_in": (32, 128, 768, 3072),
    "bert_ffn_out": (32, 128, 3072, 768),
    "gpt2_prefill_qkv": (8, 64, 768, 2304),
    "gpt2_lm_head_odd_n": (8, 64, 768, 50257),
    "llama_prefill_ffn": (8, 64, 4096, 16384),
    "odd_k_odd_n": (3, 5, 13, 7)}


@pytest.mark.parametrize("case", list(MATMUL_INTEGER_CASES))
def test_matmul_integer_kernel_equals_plain(cuda, case):
    lead, M, K, N = MATMUL_INTEGER_CASES[case]
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (lead, M, K), np.int8)
                         ).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), np.int8)).to(cuda)
    before = dict(q8.qmatmul_int8.epilogues)
    got = q8.matmul_integer_int8(a, b, packed=q8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.epilogues["int32"] == before["int32"] + 1
    assert got.dtype == torch.int32 and got.shape == (lead, M, N)
    want = q8.qmatmul_int8_plain(a.reshape(-1, K), b).reshape(lead, M, N)
    assert torch.equal(got, want)


def _matmul_integer_graph(form, rng):
    """One MatMulInteger node in a zero-point form (see the cases below),
    and its feed."""
    adt, bdt, azp, bzp = form
    gen = {np.uint8: lambda s: rng.integers(0, 256, s).astype(np.uint8),
           np.int8: lambda s: rng.integers(-128, 128, s).astype(np.int8)}
    M, K, N = 37, 96, 40
    b = GraphBuilder("mi", opset=13)
    a = b.input("a", [2, M, K], dtype=adt)
    names = [a, b.init("b", gen[bdt]((K, N))), "", ""]
    feed = {"a": gen[adt]((2, M, K))}
    if azp == "scalar":
        names[2] = b.init("a_zp", gen[adt](()))
    elif azp == "row":
        names[2] = b.init("a_zp", gen[adt]((M, 1)))
    elif azp == "input":
        names[2] = b.input("a_zp", [], dtype=adt)
        feed["a_zp"] = gen[adt](())
    if bzp == "col":
        names[3] = b.init("b_zp", gen[bdt]((N,)))
    elif bzp == "scalar":
        names[3] = b.init("b_zp", gen[bdt](()))
    names = names[:max(i for i, n in enumerate(names) if n) + 1]
    b.output(b.node("MatMulInteger", names, ["y"])[0])
    return import_model(b.model()), feed


@pytest.mark.parametrize("form", [
    (np.int8, np.int8, None, None), (np.uint8, np.int8, "scalar", None),
    (np.uint8, np.int8, None, None), (np.uint8, np.int8, "row", None),
    (np.int8, np.int8, None, "col"), (np.uint8, np.uint8, "scalar", "col"),
    (np.uint8, np.int8, "input", "scalar")],
    ids=["i8", "u8_a_zp", "u8_no_zp", "u8_a_row", "b_col", "u8u8_both",
         "a_zp_input_b_scalar"])
def test_matmul_integer_zero_points_on_card_equal_cpu(cuda, form):
    """Every zero-point form through the emitter: the kernel's int32 plus
    the corrections equals the CPU's exactly, one int32-epilogue launch."""
    graph, feed = _matmul_integer_graph(form, np.random.default_rng(3))
    before = dict(q8.qmatmul_int8.epilogues)
    eng = Engine(graph)
    with torch.no_grad():
        card = eng._fn(eng.params, {k: torch.as_tensor(v, device=cuda)
                                    for k, v in feed.items()})
    torch.cuda.synchronize()
    assert q8.qmatmul_int8.epilogues["int32"] >= before["int32"] + 1
    host = Engine(graph, device="cpu")(feed)
    assert torch.equal(card["y"].cpu(), host["y"])


# (M, K, N, block): the bf16 prefill's int4 shapes at M = 512 (GPT-2's qkv,
# Llama's layer-0 q and k at dim 4096), a decode-sized M on small_m, and an
# odd quant block on general
INT4_BF16A_CASES = {"prefill_qkv": (512, 768, 2304, 256),
                    "llama_q": (512, 4096, 4096, 256),
                    "llama_k": (512, 4096, 1024, 256),
                    "small_m": (8, 768, 768, 256),
                    "general_block42": (17, 84, 40, 42)}


@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("case", list(INT4_BF16A_CASES))
def test_int4_kernels_take_bf16_a(cuda, case, layout):
    """bf16 A: within 1e-5 x max|out| of the plain twin, and equal to the
    kernel on the same values given as f32 A (the kernel rounds f32 A to
    bf16 itself); counted as a bf16-A launch."""
    M, K, N, block = INT4_BF16A_CASES[case]
    if layout == "interleaved" and block == 42:
        block = 84  # an interleaved block of 42 bytes
    kern, plain, a, packed, scales, kw = _int4_operands(
        layout, M, K, N, block, np.random.default_rng(M + K), cuda)
    ab = a.to(torch.bfloat16)
    before = dict(kern.a_dtypes)
    got = kern(ab, packed, scales, **kw)
    torch.cuda.synchronize()
    assert kern.a_dtypes["bfloat16"] == before["bfloat16"] + 1
    want = plain(ab, packed, scales, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape == (M, N)
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(got, kern(ab.float(), packed, scales, **kw))


@pytest.mark.parametrize("scheme", ["bf16", "w8a8", "w8a8_bf16"])
def test_precision_engines_replay_equals_eager(cuda, scheme):
    """BERT with BERT-base's 12 layers at hidden 64 as a bf16 Engine, a
    W8A8 Engine (fp32 policy) and a W8A8 Engine under bf16: the captured
    graph's replays equal the eager function bit for bit, outputs f32;
    73 MatMulInteger launches per replayed W8A8 forward."""
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        quantize_matmuls_w8a8)

    cfg = BertConfig(vocab_size=500, max_positions=64, hidden=64, n_layer=12,
                     n_head=4)
    B, T = 2, 16
    g = import_model(build_bert(cfg, batch=B, seq_len=T, seed=0))
    if scheme != "bf16":
        g = quantize_matmuls_w8a8(g, min_elems=1024)
    eng = Engine(g, dtype="float32" if scheme == "w8a8" else "bfloat16")
    rng = np.random.default_rng(1)
    feed = {"input_ids": rng.integers(0, cfg.vocab_size, (B, T)),
            "token_type_ids": rng.integers(0, 2, (B, T)),
            "attention_mask": (np.arange(T)[None] < np.array([[T], [11]])
                               ).astype(np.int64)}
    dev = {k: torch.as_tensor(v, device=cuda) for k, v in feed.items()}
    first = eng(feed)                             # eager + capture
    with torch.no_grad():
        eager = eng._fn(eng.params, dev)
    torch.cuda.synchronize()
    before = q8.qmatmul_int8.launches
    for _ in range(3):
        got = eng(feed)                           # replays
        for name, v in eager.items():
            assert v.dtype == torch.float32, name
            assert torch.equal(got[name], v), name
            assert torch.equal(first[name], v), name
    torch.cuda.synchronize()
    per = 73 if scheme != "bf16" else 0
    assert q8.qmatmul_int8.launches - before == 3 * per
    host = Engine(g, device="cpu",
                  dtype="float32" if scheme == "w8a8" else "bfloat16")(feed)
    for name, v in host.items():
        assert _rel_err(got[name].cpu(), v) <= 2e-2, name


# --------------------------------------------------------------------------
# ONNX Runtime's QOperator forms on the int8 kernels: uint8 or int8 x, the
# x zero point as the padding's value, y's zero point and type, dilation,
# the int32 epilogue; zero points at both ends of each type, padding on
# every border, odd sizes
# --------------------------------------------------------------------------
# x dtype -> (x zero point, y zero point) pairs
QOP_ZERO_POINTS = {torch.uint8: [(0, 0), (1, 1), (128, 127), (255, 255)],
                   torch.int8: [(0, 0), (1, -1), (127, -128), (-128, 127)]}
QOP_ZP_CASES = [(dt, zx, zy) for dt, pairs in QOP_ZERO_POINTS.items()
                for zx, zy in pairs]
QOP_ZP_IDS = [f"{str(dt)[6:]}_zx{zx}_zy{zy}" for dt, zx, zy in QOP_ZP_CASES]

# (B, C, H, W, O, kernel, stride, pads (t, b, l, r), dilation)
QOP_CONV_SHAPES = {
    "3x3_pad1_odd": (2, 20, 9, 7, 24, 3, 1, (1, 1, 1, 1), 1),
    "3x3_s2_every_border": (1, 32, 11, 10, 40, 3, 2, (2, 1, 1, 2), 1),
    "5x5_dilated2_c8": (2, 8, 13, 12, 16, 5, 1, (4, 3, 4, 2), 2),
    "1x1_tma_c32": (2, 32, 7, 5, 48, 1, 1, (0, 0, 0, 0), 1),
    "7x7_c3_s2_pad3": (2, 3, 17, 19, 16, 7, 2, (3, 3, 3, 3), 1),
}


def _qop_x(dt, shape, rng, cuda):
    info = torch.iinfo(dt)
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape)
                            .astype(np.uint8 if dt == torch.uint8
                                    else np.int8)).to(cuda)


@pytest.mark.parametrize("shape", list(QOP_CONV_SHAPES))
@pytest.mark.parametrize("dt,zx,zy", QOP_ZP_CASES, ids=QOP_ZP_IDS)
def test_qoperator_conv_forms_equal_plain(cuda, shape, dt, zx, zy):
    """The group-1 kernel's requant epilogue (y of x's type, y's zero
    point) and int32 epilogue, each bit-equal to its plain version on the
    card, with the launch counted per producer, epilogue and form."""
    B, C, H, W, O, ksz, s, (pt, pb, pl, pr), d = QOP_CONV_SHAPES[shape]
    rng = np.random.default_rng(21)
    x = _qop_x(dt, (B, C, H, W), rng, cuda)
    _, w, mult, bias = _qconv_operands(B, C, H, W, O, ksz, True, True, rng,
                                       cuda)
    packed = k.pack_qconv_weight(w, (s, s), (d, d))
    kw = dict(stride=(s, s), padding=((pt, pb), (pl, pr)), dilation=(d, d),
              pad_value=zx)
    before = (k.qconv_int8_requant.launches,
              dict(k.qconv_int8_requant.forms))
    got = k.qconv_int8_requant(x, w, mult, bias, **kw, y_zp=zy,
                               out_dtype=dt, packed=packed)
    got32 = k.qconv_int8(x, w, **kw, packed=packed)
    torch.cuda.synchronize()
    assert got.dtype == dt and got32.dtype == torch.int32
    assert torch.equal(got, k.qconv_int8_requant_plain(
        x, w, mult, bias, **kw, y_zp=zy, out_dtype=dt))
    assert torch.equal(got32, k.qconv_int8_plain(x, w, **kw))
    forms = k.qconv_int8_requant.forms
    assert k.qconv_int8_requant.launches == before[0] + 2
    assert forms["int32"] == before[1]["int32"] + 1
    assert forms["uint8_x"] == before[1]["uint8_x"] + 2 * (dt == torch.uint8)
    assert forms["zero_point_pad"] == before[1]["zero_point_pad"] + 2 * (
        zx != 0 and pt + pb + pl + pr > 0)


# (B, C, H, W, O, group, kernel, stride, pad, dilation, form)
QOP_GROUPED_SHAPES = {
    "dw_s1_odd": (2, 32, 15, 13, 32, 32, 3, 1, 1, 1, "tile"),
    "dw_s2_odd": (2, 48, 17, 15, 48, 48, 3, 2, 1, 1, "tile"),
    "dw_s1_c160_whole_run": (1, 160, 9, 9, 160, 160, 3, 1, 1, 1, "tile"),
    "group2_cg4": (2, 8, 9, 11, 12, 2, 3, 1, 1, 1, "general"),
    "dw_dilated2": (1, 16, 12, 10, 16, 16, 3, 1, 2, 2, "general"),
}


@pytest.mark.parametrize("shape", list(QOP_GROUPED_SHAPES))
@pytest.mark.parametrize("dt,zx,zy", QOP_ZP_CASES, ids=QOP_ZP_IDS)
def test_qoperator_grouped_forms_equal_plain(cuda, shape, dt, zx, zy):
    """The grouped kernel on a uint8 or int8 x with a zero point as the
    padding (in the tile form stored over each border tile's halo in
    shared memory), y's zero point and type, dilation in the general form,
    and the general form's int32 output, bit-equal to the plain versions."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8)

    B, C, H, W, O, g, ksz, s, p, d, form = QOP_GROUPED_SHAPES[shape]
    rng = np.random.default_rng(22)
    _, w, mult, bias = _grouped_operands(B, C, H, W, O, g, ksz, rng, cuda)
    x = _qop_x(dt, (B, C, H, W), rng, cuda).contiguous(
        memory_format=torch.channels_last)
    packed = g8.pack_qconv_grouped_weight(w)
    kw = dict(stride=(s, s), padding=((p, p), (p, p)), dilation=(d, d),
              pad_value=zx)
    before = dict(g8.qconv_grouped_int8_requant.schedules)
    got = g8.qconv_grouped_int8_requant(x, w, mult, bias, **kw, y_zp=zy,
                                        out_dtype=dt, packed=packed)
    got32 = g8.qconv_grouped_int8(x, w, bias, **kw, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, g8.qconv_grouped_int8_requant_plain(
        x, w, mult, bias, **kw, y_zp=zy, out_dtype=dt))
    assert torch.equal(got32, g8.qconv_grouped_int8_plain(x, w, bias, **kw))
    want = dict(before)
    want[form] += 1
    want["general"] += 1  # the int32 output
    assert g8.qconv_grouped_int8_requant.schedules == want


@pytest.mark.parametrize("M,K,N", [(37, 72, 40), (129, 200, 1000),
                                   (256, 1280, 1000)])
@pytest.mark.parametrize("dt,zy", [(torch.int8, -128), (torch.int8, 5),
                                   (torch.uint8, 0), (torch.uint8, 128),
                                   (torch.uint8, 255)])
def test_qoperator_gemm_requant_forms_equal_plain(cuda, M, K, N, dt, zy):
    """The GEMM's requant epilogue with y's zero point and a uint8 output,
    bit-equal to its plain version."""
    rng = np.random.default_rng(23)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), np.int8)).to(cuda)
    mult = torch.from_numpy((np.abs(rng.standard_normal(N)) * 3e-4 + 1e-5)
                            .astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-3000, 3000, (N,), np.int32)
                            ).to(cuda)
    got = q8.qmatmul_int8_requant(a, b, mult, bias, y_zp=zy, out_dtype=dt,
                                  packed=q8.pack_qmatmul_weight(b))
    torch.cuda.synchronize()
    assert got.dtype == dt
    assert torch.equal(got, q8.qmatmul_int8_requant_plain(
        a, b, mult, bias, y_zp=zy, out_dtype=dt))


def test_qoperator_int32_routes_in_a_captured_engine(cuda):
    """A ConvInteger with a per-channel w zero point (the conv kernel's
    int32 output and its window sums), a grouped QLinearConv with a weight
    zero point and a QLinearMatMul with b and a zero points (the GEMM's
    int32 route), in one Engine on the card: the first call (eager, then
    captured) and a replay equal the CPU Engine exactly; no zero point is
    copied from the host during the capture."""
    from onnx_rusty_inference_engine_tpu_torch.graph import (
        Graph, InputSpec, Node)

    rng = np.random.default_rng(31)
    x = rng.integers(0, 256, (2, 8, 9, 9)).astype(np.uint8)
    consts = {
        "w": rng.integers(-127, 128, (6, 8, 3, 3)).astype(np.int8),
        "xzp": np.uint8(131), "wzp": rng.integers(-3, 4, (6,)).astype(
            np.int8),
        "xs": np.float32(0.05), "gw": rng.integers(
            -127, 128, (8, 2, 3, 3)).astype(np.int8),
        "gws": np.float32(0.01), "gwzp": np.int8(2), "ys": np.float32(0.4),
        "yzp": np.uint8(120),
        "b": rng.integers(0, 256, (10, 5)).astype(np.uint8),
        "bs": np.float32(0.02), "bzp": np.uint8(125), "ms": np.float32(0.3),
        "mzp": np.uint8(100)}
    nodes = [
        Node("ConvInteger", ["x", "w", "xzp", "wzp"], ["ci"], "ci",
             {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
        Node("QLinearConv", ["x", "xs", "xzp", "gw", "gws", "gwzp", "ys",
                             "yzp"], ["gc"], "gc",
             {"kernel_shape": [3, 3], "pads": [1, 2, 0, 1], "group": 4}),
        Node("QLinearMatMul", ["gc", "ys", "yzp", "b", "bs", "bzp", "ms",
                               "mzp"], ["mm"], "mm")]
    g = Graph(name="int32_routes", nodes=nodes, constants=consts,
              inputs=[InputSpec("x", x.shape, np.dtype(np.uint8))],
              outputs=["ci", "mm"], opset=13,
              weight_names=["w", "gw", "b"])
    want = Engine(g, device="cpu").run({"x": x}).outputs
    eng = Engine(g)
    dev = {"x": torch.as_tensor(x, device=cuda)}
    first = {k: v.cpu().numpy() for k, v in eng(dev).items()}
    x2 = rng.integers(0, 256, x.shape).astype(np.uint8)
    want2 = Engine(g, device="cpu").run({"x": x2}).outputs
    second = {k: v.cpu().numpy() for k, v in eng(
        {"x": torch.as_tensor(x2, device=cuda)}).items()}
    for k in ("ci", "mm"):
        np.testing.assert_array_equal(first[k], want[k], err_msg=k)
        np.testing.assert_array_equal(second[k], want2[k], err_msg=k)


# --------------------------------------------------------------------------
# the kernels as torch.library ops, and the exported artifact on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", OPS)
def test_op_passes_opcheck_on_the_card(cuda, name):
    """Each `oriet::` op's CUDA implementation (the launch) against its
    fake one (shape, dtype, strides: channels-last convs), its schema and
    dynamic-shape tracing; ops 4 and 6 (interleaved int4, int8 x int8
    attention) run on no exported path of the smoke."""
    op, args = op_case(name, cuda)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def _launch_gains(fn, reps: int = 3) -> dict:
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import counters

    before = counters.snapshot()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return counters.delta(before)


def _round_trip(eng, feed, tmp_path, platforms=None):
    """(the Engine's outputs, the loaded artifact's first call and its
    replay, the artifact, launches over 3 replays of each) on the card."""
    from onnx_rusty_inference_engine_tpu_torch.export_aot import (
        export_engine, load_exported)

    want = eng.run(feed).outputs
    path = str(tmp_path / "a.oriet.npz")
    export_engine(eng, feed, path, platforms=platforms)
    m = load_exported(path)
    first, replayed = m.run(feed), m.run(feed)
    gains = (_launch_gains(lambda: eng(feed)), _launch_gains(lambda: m(feed)))
    return want, first, replayed, path, gains


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_export_round_trip_int8_squeezenet(cuda, tmp_path):
    """Bit for bit against the Engine, eager and replayed; the same
    launches per replayed forward (26 conv launches)."""
    g = import_model(build_squeezenet())
    x = np.random.default_rng(0).standard_normal((8, 3, 64, 64))
    feed = {"data_0": x.astype(np.float32)}
    q = quantize_graph(g, ranges=calibrate(g, [feed], device="cpu"))
    want, first, replayed, _, (e_gain, m_gain) = _round_trip(
        Engine(q), feed, tmp_path)
    _assert_equal(first, want)
    _assert_equal(replayed, want)
    assert m_gain == e_gain
    assert e_gain[("qconv_int8_requant", "launches", "")] == 26 * 3


@pytest.mark.parametrize("attn", ["f32", "int8_mxu"])
def test_export_round_trip_decode_step(cuda, tmp_path, monkeypatch, attn):
    """GPT-2's INT4-planar, INT8-KV, fused-attention decode step (2 layers,
    n_embd 256) with each attention kernel: bit for bit, the same
    launches (9 int4 and 2 attention per step)."""
    from onnx_rusty_inference_engine_tpu_torch.models import (
        build_gpt2_decode)

    if attn == "int8_mxu":
        monkeypatch.setenv("ORIET_ATTN_I8", "1")
    cfg = GPT2Config(vocab_size=512, n_positions=64, n_embd=256, n_layer=2,
                     n_head=4)
    g = quantize_weights_int4(import_model(build_gpt2_decode(
        cfg, batch=2, max_len=32, kv_dtype="int8", fused_attention=True)))
    rng = np.random.default_rng(0)
    feed = {"input_ids": rng.integers(0, 512, (2, 1)),
            "pos": np.array([5, 9])}
    for i in range(2):
        for kind in ("key", "value"):
            feed[f"past_{kind}_{i}"] = rng.integers(
                -127, 128, (2, 4, 32, 64)).astype(np.int8)
            feed[f"kv_scale_{kind}_{i}"] = (
                rng.random(4) * 0.05 + 0.01).astype(np.float32)
    want, first, replayed, _, (e_gain, m_gain) = _round_trip(
        Engine(g), feed, tmp_path)
    _assert_equal(first, want)
    _assert_equal(replayed, want)
    assert m_gain == e_gain
    kernel = ("decode_attention_int8_mxu" if attn == "int8_mxu"
              else "decode_attention_int8")
    assert e_gain[(kernel, "launches", "")] == 2 * 3
    assert e_gain[("qmatmul_int4_planar", "launches", "")] == 9 * 3


def test_export_round_trip_int32_routes(cuda, tmp_path):
    """ConvInteger, a grouped conv with a weight zero point and an
    asymmetric QLinearMatMul (the int32 routes of qconv_int8,
    qconv_grouped_int8 and qmatmul_int8) through export: bit for bit."""
    from onnx_rusty_inference_engine_tpu_torch.graph import (
        Graph, InputSpec, Node)

    rng = np.random.default_rng(31)
    x = rng.integers(0, 256, (2, 8, 9, 9)).astype(np.uint8)
    consts = {
        "w": rng.integers(-127, 128, (6, 8, 3, 3)).astype(np.int8),
        "xzp": np.uint8(131), "wzp": rng.integers(-3, 4, (6,)).astype(
            np.int8),
        "xs": np.float32(0.05), "gw": rng.integers(
            -127, 128, (8, 2, 3, 3)).astype(np.int8),
        "gws": np.float32(0.01), "gwzp": np.int8(2), "ys": np.float32(0.4),
        "yzp": np.uint8(120),
        "b": rng.integers(0, 256, (10, 5)).astype(np.uint8),
        "bs": np.float32(0.02), "bzp": np.uint8(125), "ms": np.float32(0.3),
        "mzp": np.uint8(100)}
    nodes = [
        Node("ConvInteger", ["x", "w", "xzp", "wzp"], ["ci"], "ci",
             {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
        Node("QLinearConv", ["x", "xs", "xzp", "gw", "gws", "gwzp", "ys",
                             "yzp"], ["gc"], "gc",
             {"kernel_shape": [3, 3], "pads": [1, 2, 0, 1], "group": 4}),
        Node("QLinearMatMul", ["gc", "ys", "yzp", "b", "bs", "bzp", "ms",
                               "mzp"], ["mm"], "mm")]
    g = Graph(name="int32_routes", nodes=nodes, constants=consts,
              inputs=[InputSpec("x", x.shape, np.dtype(np.uint8))],
              outputs=["ci", "mm"], opset=13,
              weight_names=["w", "gw", "b"])
    want, first, replayed, _, (e_gain, m_gain) = _round_trip(
        Engine(g), {"x": x}, tmp_path)
    _assert_equal(first, want)
    _assert_equal(replayed, want)
    assert m_gain == e_gain


def test_cpu_cuda_artifact_runs_on_both_devices(cuda, tmp_path):
    """One artifact with both programs: on the card bit for bit with the
    card's Engine, on the CPU bit for bit with a CPU Engine (the plain
    versions)."""
    from onnx_rusty_inference_engine_tpu_torch.export_aot import (
        load_exported)

    g = import_model(build_squeezenet())
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64))
    feed = {"data_0": x.astype(np.float32)}
    q = quantize_graph(g, ranges=calibrate(g, [feed], device="cpu"))
    want, first, _, path, _ = _round_trip(Engine(q), feed, tmp_path,
                                          platforms=["cpu", "cuda"])
    _assert_equal(first, want)
    on_cpu = load_exported(path, device="cpu")
    assert on_cpu.platforms == ["cpu", "cuda"]
    _assert_equal(on_cpu.run(feed), Engine(q, device="cpu").run(feed).outputs)


# --------------------------------------------------------------------------
# control flow and the scan-over-layers decode
# --------------------------------------------------------------------------
# 12 layers at a narrow width: the Scan iterates as GPT-2 124M's does, and
# every int4 product takes the planar kernel (K // 2 a multiple of 128)
SCAN_GPT2 = GPT2Config(vocab_size=512, n_positions=64, n_embd=256,
                       n_layer=12, n_head=4)


def _scan_pair(cuda, **kw):
    ids = np.random.default_rng(4).integers(0, SCAN_GPT2.vocab_size, (2, 8))
    gens = {form: Generator(SCAN_GPT2, batch=2, prompt_len=8, max_len=32,
                            kv_dtype="int8", int4_weights=True,
                            scan_layers=form == "scan", device=cuda, **kw)
            for form in ("per_layer", "scan")}
    return gens, ids


def test_scan_decode_on_card_equals_per_layer(cuda):
    """The scan form on the card: greedy tokens, and logits and cache of
    teacher-forced steps, equal the per-layer form's bit for bit (the same
    kernels on the same shapes); 49 int4 launches per step in both, each
    on the same schedule."""
    gens, ids = _scan_pair(cuda)
    toks, counts = {}, {}
    for form, gen in gens.items():
        q4.qmatmul_int4_planar.launches = 0
        q4.qmatmul_int4_planar.schedules = dict.fromkeys(q4.SCHEDULES, 0)
        toks[form], _ = gen.generate(ids, 8)
        torch.cuda.synchronize()
        counts[form] = (q4.qmatmul_int4_planar.launches,
                        dict(q4.qmatmul_int4_planar.schedules))
    np.testing.assert_array_equal(toks["scan"], toks["per_layer"])
    assert counts["scan"] == counts["per_layer"]
    assert counts["scan"][0] == 49 * 8
    (ls, cs), (lp, cp) = (gens[f].start(ids) for f in ("scan", "per_layer"))
    assert torch.equal(ls, lp)
    for t in range(3):
        tok = torch.from_numpy(toks["scan"][:, t]).to(cuda)
        ls, cs = gens["scan"].step(cs, tok, 8 + t)
        lp, cp = gens["per_layer"].step(cp, tok, 8 + t)
        assert torch.equal(ls, lp)
        for i in range(SCAN_GPT2.n_layer):
            assert torch.equal(cs["past_key"][i], cp[f"past_key_{i}"])
            assert torch.equal(cs["past_value"][i], cp[f"past_value_{i}"])


def test_scan_decode_device_loop_on_card(cuda):
    """device_loop = K over the stacked cache, K not dividing the steps:
    the host loop's tokens, greedy and sampled."""
    gens, ids = _scan_pair(cuda)
    gen = gens["scan"]
    want, _ = gen.generate(ids, 10)
    samp = dict(temperature=0.8, top_k=20, sample_seed=5)
    want_s, _ = gen.generate(ids, 10, **samp)
    gen.device_loop = 4
    for _ in range(2):  # the eager block and capture, then replays
        np.testing.assert_array_equal(gen.generate(ids, 10)[0], want)
        np.testing.assert_array_equal(gen.generate(ids, 10, **samp)[0],
                                      want_s)


def test_int4_kernel_on_stacked_weight_slices(cuda):
    """The planar kernel on layer slices of a stacked [NL, Nw, K/2] weight
    (contiguous views at an offset, as a Scan hands each iteration) picks
    the schedule and gives the result of the same weights held apart."""
    rng = np.random.default_rng(8)
    K, N, NL = 768, 2304, 3
    packs, scales = zip(*(pack_int4_planar(rng.standard_normal(
        (K, N)).astype(np.float32) * 0.02) for _ in range(NL)))
    stack = torch.from_numpy(np.stack(packs)).to(cuda)
    sstack = torch.from_numpy(np.stack(scales)).to(cuda)
    for M in (8, 512):
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(cuda)
        for layer in range(NL):
            p, s = stack[layer], sstack[layer]
            assert p.is_contiguous()
            assert (p.storage_offset() == 0) == (layer == 0)
            before = dict(q4.qmatmul_int4_planar.schedules)
            got = q4.qmatmul_int4_planar(a, p, s, qblock=256)
            picked = {k for k, v in q4.qmatmul_int4_planar.schedules.items()
                      if v != before[k]}
            want = q4.qmatmul_int4_planar(a, p.clone(), s.clone(),
                                          qblock=256)
            assert picked == {"small_m" if M == 8 else "mma"}
            assert torch.equal(got, want)


@pytest.fixture(scope="module")
def control_flow():
    from chip_smoke import control_flow_graphs

    return control_flow_graphs(seed=1)


@pytest.mark.parametrize("name", [
    "if_runtime_predicate", "loop_early_exit", "loop_sequence_state",
    "scan_reverse_two_inputs", "lstm", "gru", "rnn"])
def test_control_flow_graph_on_card_equals_cpu(cuda, control_flow, name):
    """The smoke's control-flow and recurrence graphs on the card: the
    first call, replays and eager forwards of every feed against the CPU
    (1e-5 x max|out| for If/Loop/Scan, rtol 1e-4 / atol 1e-5 for the
    RNNs); an If's two predicate values replay one captured graph."""
    from chip_smoke import _cf_check

    graph, feeds, bound = control_flow[name]
    cpu = Engine(graph, device="cpu")
    eng = Engine(graph, device=cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            for label, feed in feeds + feeds:  # first call, then replays
                _cf_check(eng(feed), cpu(feed), bound)
                dev = {k: torch.as_tensor(v).to(cuda)
                       for k, v in feed.items()}
                _cf_check(eng.forward(dev), cpu(feed), bound)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert len(eng._graphs) == 1


# ---------------------------------------------------------------------------
# the op library (tests/torch_port_oplib.py) and its model families
# ---------------------------------------------------------------------------
import torch_port_oplib as oplib  # noqa: E402


@pytest.mark.parametrize("c", oplib.ALL_CASES,
                         ids=[c.id for c in oplib.ALL_CASES])
def test_op_library_case_on_card_equals_cpu(cuda, c):
    """Every op-library case through an Engine on the card, eager and
    replayed, against the port's CPU run: exact for integer, boolean and
    index outputs (TopK's stable ties, the random ops' fixed draws), else
    the CPU tests' tolerance; one captured graph."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            oplib.card_vs_cpu(c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_unet_tiny_int8_on_card(cuda):
    """UNet TINY's INT8 graph on the card: every QLinearConv on the hand
    kernel (2 * depth + 2 + depth launches a forward, replays included),
    the dequantized logits at most 1 step of the output's scale from the
    CPU's INT8 run, eager and replayed."""
    from chip_smoke import output_steps, read_counts, reset_counts
    from onnx_rusty_inference_engine_tpu_torch.models.unet import (
        TINY, build_unet)

    g = import_model(build_unet(TINY, batch=2, size=32))
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    q = quantize_graph(g, ranges=calibrate(g, [{"image": x}], device=cuda))
    want = Engine(q, device="cpu").run({"image": x})["mask_logits"]
    eng = Engine(q, device=cuda)
    reset_counts()
    for _ in range(3):
        got = eng.run({"image": x})["mask_logits"]
        assert output_steps(q, "mask_logits", got, want) <= 1
    n = 3 * TINY.depth + 2
    assert {k: v for k, v in read_counts().items() if v} == {
        "qconv_int8_requant": 3 * n}
