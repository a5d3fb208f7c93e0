"""One call of each `oriet::` kernel op (ops/kernels/), for
`torch.library.opcheck`: the op and its arguments on a device, from
numpy with a seed. On the card the weights are pre-packed as an Engine
packs them; on the CPU nothing is packed, as there.

It imports only the port (no JAX), so the card tests
(tests/test_torch_port_cuda.py) use it as the CPU tests do
(tests/test_torch_port_export.py).
"""

from __future__ import annotations

import numpy as np
import torch

from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (  # noqa: F401
    decode_attn, qconv_grouped_int8 as g8, qconv_int8 as c8, qmatmul_int4,
    qmatmul_int8 as m8)
from onnx_rusty_inference_engine_tpu_torch.quant import (
    pack_int4, pack_int4_planar)


def _i8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(
        np.int8)).to(dev)


def _f32(rng, shape, dev, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _packed(pack, w, dev):
    return pack(w) if torch.device(dev).type == "cuda" else None


def op_case(name: str, dev):
    """(the op overload, its arguments) for op `name` on `dev`."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ops = torch.ops.oriet
    if name in ("qconv_int8_requant", "qconv_int8"):
        x = _i8(rng, (2, 16, 9, 9), dev)
        w = _i8(rng, (32, 16, 3, 3), dev)
        pk = _packed(c8.pack_qconv_weight, w, dev)
        if name == "qconv_int8":
            return ops.qconv_int8.default, (x, w, pk, [2, 2], [1, 0, 1, 1],
                                            [1, 1], 3)
        mult = torch.from_numpy(rng.random(32).astype(np.float32) * 1e-3
                                ).to(dev)
        bias = torch.from_numpy(rng.integers(-999, 999, 32).astype(
            np.int32)).to(dev)
        return ops.qconv_int8_requant.default, (
            x, w, mult, bias, pk, [1, 1], [1, 1, 1, 1], [1, 1], 0, -3,
            torch.int8)
    if name in ("qconv_grouped_int8_requant", "qconv_grouped_int8"):
        x = _i8(rng, (2, 16, 9, 9), dev)
        w = _i8(rng, (16, 1, 3, 3), dev)
        pk = _packed(g8.pack_qconv_grouped_weight, w, dev)
        bias = torch.from_numpy(rng.integers(-999, 999, 16).astype(
            np.int32)).to(dev)
        if name == "qconv_grouped_int8":
            return ops.qconv_grouped_int8.default, (
                x, w, bias, pk, [1, 1], [1, 1, 1, 1], [1, 1], 0)
        mult = torch.from_numpy(rng.random(16).astype(np.float32) * 1e-2
                                ).to(dev)
        return ops.qconv_grouped_int8_requant.default, (
            x, w, mult, bias, pk, [2, 2], [1, 1, 1, 1], [1, 1], 0, 5,
            torch.uint8)
    if name in ("qmatmul_int8", "qmatmul_int8_requant"):
        a = _i8(rng, (64, 96), dev)
        b = _i8(rng, (96, 48), dev)
        pk = _packed(m8.pack_qmatmul_weight, b, dev)
        if name == "qmatmul_int8":
            return ops.qmatmul_int8.default, (a, b, pk)
        mult = torch.from_numpy(rng.random(48).astype(np.float32) * 1e-3
                                ).to(dev)
        return ops.qmatmul_int8_requant.default, (a, b, mult, None, pk, 3,
                                                  torch.uint8)
    if name in ("qmatmul_int4_planar", "qmatmul_int4_bf16"):
        w = rng.standard_normal((256, 64)).astype(np.float32)
        a = _f32(rng, (8, 256), dev)
        if name == "qmatmul_int4_planar":
            p, s = pack_int4_planar(w, 128)
            return ops.qmatmul_int4_planar.default, (
                a, torch.from_numpy(p).to(dev), torch.from_numpy(s).to(dev),
                128, 60)
        p, s = pack_int4(w, 64)
        return ops.qmatmul_int4_bf16.default, (
            a, torch.from_numpy(p).to(dev), torch.from_numpy(s).to(dev), 64)
    if name in ("decode_attention_int8", "decode_attention_int8_mxu"):
        B, H, Hkv, L, hd = 2, 4, 2, 40, 64
        q = _f32(rng, (B * H, 1, hd), dev, 0.05)
        k8 = _i8(rng, (B * Hkv, L, hd), dev)
        v8 = _i8(rng, (B * Hkv, L, hd), dev)
        bias = torch.zeros((B, 1, L), dtype=torch.float32)
        bias[:, :, 33:] = -1e9
        return getattr(ops, name).default, (q, k8, v8, bias.to(dev), H)
    raise KeyError(name)


# every `oriet::` op
OPS = ("qconv_int8_requant", "qconv_int8", "qconv_grouped_int8_requant",
       "qconv_grouped_int8", "qmatmul_int8", "qmatmul_int8_requant",
       "qmatmul_int4_planar", "qmatmul_int4_bf16", "decode_attention_int8",
       "decode_attention_int8_mxu")
