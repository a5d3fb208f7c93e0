"""The port's int8 kernel and engine on the card (marker `cuda`; each test
skips without a CUDA device).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. Run it on a card, without the suite's conftest.py
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

The kernel must equal its plain version bit for bit: both sum int8
products exactly in 32 bits, then apply the same fp32 epilogue.
"""

import numpy as np
import pytest
import torch

from onnx_rusty_inference_engine_tpu_torch import (
    Engine, calibrate, import_model, quantize_graph)
from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
from onnx_rusty_inference_engine_tpu_torch.models._builder import (
    GraphBuilder)
from onnx_rusty_inference_engine_tpu_torch.ops.kernels import qconv_int8 as k

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
}


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
                               packed=k.pack_qconv_weight(w))
    torch.cuda.synchronize()
    assert k.qconv_int8_requant.launches == before + 1
    want = k.qconv_int8_requant_plain(x, w, mult, bias, stride=(s, s),
                                      padding=padding)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(100, 300, 50), (17, 64, 1000)])
def test_gemm_form_equals_plain(cuda, M, K, N):
    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-127, 128, (K, N), np.int8)).to(cuda)
    mult = torch.tensor(3e-4, device=cuda)
    bias = torch.from_numpy(
        rng.integers(-1000, 1000, (N,), np.int32)).to(cuda)
    got = k.qmatmul_int8_requant(a, b, mult, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, k.qmatmul_int8_requant_plain(a, b, mult, bias))


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
