"""Quantized ONNX op emitters: QuantizeLinear / DequantizeLinear /
QLinearConv / QLinearMatMul / QLinearAdd / QLinearMul / MatMulNBits /
MatMulInteger / DynamicQuantizeLinear.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/quantized.py
for the INT8 CNN (SqueezeNet, ResNet-50, MobileNetV2), BERT and ViT paths
and the INT4 decode paths.
Requant math (ONNX QLinear convention): y = saturate(round(acc * (x_s *
w_s / y_s)) + y_zp), rounding half to even.

QLinearConv runs on the hand-written kernels in the cases the quantizer
emits: 2-D, no dilation, int8 operands, and all three zero points
statically 0; group 1 on the implicit-GEMM kernel (ops/kernels/
qconv_int8.py), group > 1 (MobileNetV2's depthwise convs) on the direct
grouped kernel (ops/kernels/qconv_grouped_int8.py). QLinearMatMul runs
its int8 x int8 -> product on the kernel of ops/kernels/qmatmul_int8.py for
int8 operands, a 2-D b, an a of any rank and both input zero points
statically 0. Where y_zero_point is statically 0 too (the quantizer's
form), the kernel's requant epilogue adds the bias and requantizes, and
only int8 leaves it; otherwise it returns int32 and the bias add and the
requant run in PyTorch, in the JAX emitter's order. Both give the JAX emitter's values bit
for bit. Every other QLinearConv or QLinearMatMul raises UnsupportedOpError
naming the case, on the CPU as on the card, so both devices run the same
function.

QLinearAdd and QLinearMul (the quantizer's residual adds) dequantize,
combine and requantize elementwise in PyTorch, as the JAX emitter does.

MatMulInteger (the dynamic W8A8 rewrite's contraction, quant.
quantize_matmuls_w8a8, and ORT's quantize_dynamic form) runs its int8 x
int8 product on the int32 epilogue of ops/kernels/qmatmul_int8.py, for an
a of any rank and a 2-D b, int8 or uint8 each, with every zero-point form
ONNX gives (a_zero_point per tensor or per row, b_zero_point per tensor or
per column, either one a runtime tensor): uint8 operands are shifted into
int8 and the zero points folded in by small int32 corrections after the
kernel, so the result is the exact int32 the JAX emitter computes.
DynamicQuantizeLinear stays elementwise PyTorch, as JAX keeps it outside
Pallas.

MatMulNBits runs on the int4 kernels (ops/kernels/qmatmul_int4.py), with
f32 or bf16 activations (the bf16 Engine's), in both nibble layouts:
planar (quant.quantize_weights_int4) at every K and block
size the quantizer gives, and the interleaved ORT layout of quant.pack_int4
(packed [N, K/2], scales [N, K/block]) at every even K and every even block
that divides it. The JAX package's dense-dequant fallbacks, for layouts its
TPU kernels cannot tile, are not needed on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph import Node
from .kernels.qconv_grouped_int8 import qconv_grouped_int8_requant
from .kernels.qconv_int8 import qconv_int8_requant
from .kernels.qmatmul_int4 import (interleaved_layout, qmatmul_int4_bf16,
                                   qmatmul_int4_planar)
from .kernels.qmatmul_int8 import (as_int8, colsum_key, matmul_integer_int8,
                                   pack_qmatmul_weight, qmatmul_int8,
                                   qmatmul_int8_requant)
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import _conv_padding, promote


def _per_axis(t: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A 1-D per-channel tensor shaped to broadcast along `axis`."""
    shape = [1] * ndim
    shape[axis] = t.numel()
    return t.reshape(shape)


# --------------------------------------------------------------------------
# Quantize / Dequantize
# --------------------------------------------------------------------------
@register("QuantizeLinear")
def quantize_linear(ctx: LoweringContext, node: Node, ins):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    qdtype = zp.dtype if zp is not None else torch.int8
    info = torch.iinfo(qdtype)
    axis = int(node.attr("axis", 1))
    if scale.dim() == 1 and scale.numel() > 1:
        scale = _per_axis(scale, x.dim(), axis)
        if zp is not None and zp.numel() == scale.numel():
            zp = _per_axis(zp, x.dim(), axis)
    # a true division, as the JAX emitter's; scale is a tensor on x's
    # device (PyTorch turns division by a CPU scalar into a multiply by
    # its reciprocal, which moves ties by one step)
    y = torch.round(torch.true_divide(*promote(x, scale)))
    if zp is not None:
        y = y + zp.to(y.dtype)
    return (y.clamp(info.min, info.max).to(qdtype),)


@register("DequantizeLinear")
def dequantize_linear(ctx: LoweringContext, node: Node, ins):
    x, scale = ins[0], ins[1]
    zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    axis = int(node.attr("axis", 1))
    if scale.dim() == 1 and scale.numel() > 1:
        scale = _per_axis(scale, x.dim(), axis)
        if zp is not None and zp.numel() == scale.numel():
            zp = _per_axis(zp, x.dim(), axis)
    xf = x.to(torch.float32)
    if zp is not None:
        xf = xf - zp.to(torch.float32)
    return (xf * scale.to(torch.float32),)


# --------------------------------------------------------------------------
# QLinearConv
# --------------------------------------------------------------------------
def _static_zp_is_zero(ctx: LoweringContext, name: str) -> bool:
    v = ctx.constant(name) if name else None
    return v is not None and not np.any(v)


def _unsupported_qconv(ctx: LoweringContext, node: Node, x, w, spatial,
                       dilations, group) -> Optional[str]:
    """Why the kernel cannot run this QLinearConv, or None."""
    if spatial != 2:
        return f"{spatial}-D spatial (the kernel is 2-D)"
    if group < 1 or x.shape[1] != w.shape[1] * group \
            or w.shape[0] % group:
        return (f"group={group} with x {tuple(x.shape)} and w "
                f"{tuple(w.shape)} (channels do not split into the groups)")
    if any(d != 1 for d in dilations):
        return f"dilations={dilations} (dilated convs are not ported)"
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        return f"{x.dtype} x {w.dtype} operands (the kernel takes int8)"
    for idx, what in ((2, "x"), (5, "w"), (7, "y")):
        if not _static_zp_is_zero(ctx, node.inputs[idx]):
            return (f"{what}_zero_point is not a constant 0 (asymmetric "
                    f"quantization is not ported)")
    return None


@register("QLinearConv")
def qlinear_conv(ctx: LoweringContext, node: Node, ins):
    (x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    spatial = x.dim() - 2
    kernel = node.attr("kernel_shape", list(w.shape[2:]))
    strides = [int(s) for s in node.attr("strides", [1] * spatial)]
    dilations = [int(d) for d in node.attr("dilations", [1] * spatial)]
    group = int(node.attr("group", 1))
    why = _unsupported_qconv(ctx, node, x, w, spatial, dilations, group)
    if why is not None:
        raise UnsupportedOpError(
            f"QLinearConv {node.name or node.outputs[0]!r}: {why}")
    padding = _conv_padding(node, x.shape[2:], kernel, strides, dilations)
    # the multiplier in fp32 and in the JAX emitter's order
    mult = (x_s.to(torch.float32) * w_s.to(torch.float32)
            / y_s.to(torch.float32))
    conv = qconv_int8_requant if group == 1 else qconv_grouped_int8_requant
    return (conv(x, w, mult, bias, stride=strides, padding=padding,
                 packed=ctx.packed.get(node.inputs[3])),)


# --------------------------------------------------------------------------
# QLinearMatMul
# --------------------------------------------------------------------------
def _requant(acc: torch.Tensor, mult: torch.Tensor,
             y_zp: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX emitter's `_requant`: acc as f32 * mult, round half to even,
    + y_zp, saturate to int8."""
    y = torch.round(acc.to(torch.float32) * mult)
    if y_zp is not None:
        y = y + y_zp.to(torch.float32)
    return y.clamp(-128, 127).to(torch.int8)


def _unsupported_qmatmul(ctx: LoweringContext, node: Node, a,
                         b) -> Optional[str]:
    """Why the kernel cannot run this QLinearMatMul, or None."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        return f"{a.dtype} x {b.dtype} operands (the kernel takes int8)"
    if b.dim() != 2:
        return f"a {b.dim()}-D b (the kernel takes a 2-D weight)"
    for idx, what in ((2, "a"), (5, "b")):
        if not _static_zp_is_zero(ctx, node.inputs[idx]):
            return (f"{what}_zero_point is not a constant 0 (asymmetric "
                    f"quantization is not ported)")
    return None


@register("QLinearMatMul")
def qlinear_matmul(ctx: LoweringContext, node: Node, ins):
    (a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    why = _unsupported_qmatmul(ctx, node, a, b)
    if why is not None:
        raise UnsupportedOpError(
            f"QLinearMatMul {node.name or node.outputs[0]!r}: {why}")
    K, N = b.shape
    # the leading dims of a flattened: the product jnp.matmul computes
    a2 = a.reshape(-1, K).contiguous()
    packed = ctx.packed.get(node.inputs[3])
    # in fp32 and in the JAX emitter's order, from tensors on the device (a
    # true division: a CPU scalar divisor becomes a reciprocal multiply on
    # the card); a 1-D b_s is per output column, broadcast over the last dim
    mult = (a_s.to(torch.float32) * b_s.to(torch.float32)
            / y_s.to(torch.float32))
    if (_static_zp_is_zero(ctx, node.inputs[7]) and mult.numel() in (1, N)
            and (bias is None or (bias.dtype == torch.int32
                                  and bias.numel() == N))):
        # the emitter's requant with y_zp = 0 is the kernel's epilogue
        y = qmatmul_int8_requant(a2, b, mult, bias, packed=packed)
        return (y.reshape(*a.shape[:-1], N),)
    acc = qmatmul_int8(a2, b, packed=packed).reshape(*a.shape[:-1], N)
    if bias is not None:
        acc = acc + bias
    return (_requant(acc, mult, y_zp),)


# --------------------------------------------------------------------------
# QLinearAdd / QLinearMul (ORT contrib)
# --------------------------------------------------------------------------
def _dq(x: torch.Tensor, s: torch.Tensor,
        zp: Optional[torch.Tensor]) -> torch.Tensor:
    """The JAX emitter's `_dq`: (x - zp) * s in f32."""
    xf = x.to(torch.float32)
    if zp is not None:
        xf = xf - zp.to(torch.float32)
    return xf * s.to(torch.float32)


def _q(xf: torch.Tensor, s: torch.Tensor, zp: Optional[torch.Tensor],
       dtype: torch.dtype) -> torch.Tensor:
    """The JAX emitter's `_q`: round(xf / s) half to even, + zp, saturated
    to `dtype`. s stays a tensor on xf's device and is divided by (a CPU
    scalar divisor would become a multiply by its reciprocal on the card,
    which moves ties by one step)."""
    info = torch.iinfo(dtype)
    y = torch.round(xf / s.to(torch.float32))
    if zp is not None:
        y = y + zp.to(torch.float32)
    return y.clamp(info.min, info.max).to(dtype)


def _qlinear_binary(fn):
    """dequantize both inputs, fn, requantize to the first input's dtype.
    Elementwise, so a channels-last input (the int8 conv kernels' output)
    gives a channels-last result and the next conv reads it uncopied."""
    def emit(ctx: LoweringContext, node: Node, ins):
        a, a_s, a_zp, b, b_s, b_zp, y_s = ins[:7]
        y_zp = ins[7] if len(ins) > 7 else None
        out = fn(_dq(a, a_s, a_zp), _dq(b, b_s, b_zp))
        return (_q(out, y_s, y_zp, a.dtype),)
    return emit


register("QLinearAdd", domain="com.microsoft")(_qlinear_binary(torch.add))
register("QLinearMul", domain="com.microsoft")(_qlinear_binary(torch.mul))


# --------------------------------------------------------------------------
# MatMulNBits (INT4 weight-only)
# --------------------------------------------------------------------------
@register("MatMulNBits", domain="com.microsoft")
def matmul_nbits(ctx: LoweringContext, node: Node, ins):
    """Weight-only INT4 matmul: activations stay floating, the packed
    nibbles are unpacked and block-dequantized inside the kernel."""
    a, packed, scales = ins[0], ins[1], ins[2]
    K = int(node.attr("K"))
    N = int(node.attr("N"))
    if int(node.attr("bits", 4)) != 4:
        raise UnsupportedOpError("MatMulNBits: only bits=4 supported")
    layout = node.attr("layout", "")
    if isinstance(layout, bytes):
        layout = layout.decode()
    lead = a.shape[:-1]
    # the kernels take f32 or bf16 A and f32 scales (bf16 under the bf16
    # Engine's policy: exactly widened, as the JAX kernel's f32 product
    # with a bf16 scale widens it)
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.to(torch.float32)
    a2 = a.reshape(-1, K).contiguous()
    scales = scales.to(torch.float32)
    if layout == "planar":
        out = qmatmul_int4_planar(a2, packed, scales,
                                  qblock=int(node.attr("block_size", K)), n=N)
        return (out.reshape(*lead, N).to(a.dtype),)
    # interleaved (ORT): quant.pack_int4's packed [Nw, K/2], scales [Nw, nb]
    if packed.dim() != 2 or scales.dim() != 2:
        raise UnsupportedOpError(
            f"MatMulNBits {node.name or node.outputs[0]!r}: packed "
            f"{tuple(packed.shape)}, scales {tuple(scales.shape)}; the port "
            f"takes the 2-D [N, K/2] form of quant.pack_int4 (ORT's 3-D "
            f"[N, blocks, blob] form is not ported)")
    try:
        interleaved_layout(K, packed.shape[1], scales.shape[1])
    except ValueError as e:
        raise UnsupportedOpError(
            f"MatMulNBits {node.name or node.outputs[0]!r}: {e}") from None
    out = qmatmul_int4_bf16(a2, packed, scales, n=N)
    return (out.reshape(*lead, N).to(a.dtype),)


# --------------------------------------------------------------------------
# MatMulInteger / DynamicQuantizeLinear (dynamic quantization)
# --------------------------------------------------------------------------
def _shifted(zp: Optional[torch.Tensor], shift: int):
    """shift - zp as int32 (a Python int where zp is absent, None where
    that is 0): the term that takes the kernel's operand back to the
    zero-point-corrected one."""
    if zp is None:
        return shift or None
    return shift - zp.to(torch.int32)


def _matmul_integer_zero_points(node: Node, a, b, a_zp, b_zp):
    """(alpha, beta) with a - a_zp = a' + alpha and b - b_zp = b' + beta
    for the kernel's int8 operands a' = a - s and b' = b - t (s, t = 128
    for uint8, else 0): alpha per row [..., M, 1] or per tensor, beta per
    column [N] or per tensor, None where 0 by construction. Raises for a
    zero point of any other shape."""
    name = node.name or node.outputs[0]
    N = b.shape[1]
    if a_zp is not None and a_zp.numel() > 1:
        rows = a.shape[-2] if a.dim() >= 2 else 1
        if a_zp.dim() == 1 and a_zp.numel() == rows:
            # ONNX: an M-element vector is per row of a 2-D a
            a_zp = a_zp.reshape(rows, 1)
        elif not (a_zp.dim() >= 2 and a_zp.shape[-1] == 1):
            raise UnsupportedOpError(
                f"MatMulInteger {name!r}: a_zero_point "
                f"{tuple(a_zp.shape)} with a {tuple(a.shape)} is neither "
                f"per tensor nor per row")
    if b_zp is not None:
        if b_zp.numel() not in (1, N):
            raise UnsupportedOpError(
                f"MatMulInteger {name!r}: b_zero_point {tuple(b_zp.shape)} "
                f"with b {tuple(b.shape)} is neither per tensor nor per "
                f"column")
        b_zp = b_zp.reshape(-1) if b_zp.numel() > 1 else b_zp.reshape(())
    return (_shifted(a_zp, 128 if a.dtype == torch.uint8 else 0),
            _shifted(b_zp, 128 if b.dtype == torch.uint8 else 0))


@register("MatMulInteger")
def matmul_integer(ctx: LoweringContext, node: Node, ins):
    """(a - a_zp) @ (b - b_zp) in exact int32. The kernel takes the int8
    operands a' and b' (`as_int8`); then sum_k (a' + alpha)(b' +
    beta) = a' @ b' + alpha * colsum(b') + beta * rowsum(a') + K * alpha *
    beta, three small broadcasts over the int32 result (each skipped
    where its term is 0 by construction)."""
    a, b = ins[0], ins[1]
    a_zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
    b_zp = ins[3] if len(ins) > 3 and ins[3] is not None else None
    name = node.name or node.outputs[0]
    if a.dtype not in (torch.int8, torch.uint8) \
            or b.dtype not in (torch.int8, torch.uint8):
        raise UnsupportedOpError(f"MatMulInteger {name!r}: {a.dtype} x "
                                 f"{b.dtype} (ONNX gives int8 or uint8)")
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise UnsupportedOpError(
            f"MatMulInteger {name!r}: a {tuple(a.shape)} @ b "
            f"{tuple(b.shape)} (the kernel takes a 2-D b [K, N])")
    alpha, beta = _matmul_integer_zero_points(node, a, b, a_zp, b_zp)
    ai, bi = as_int8(a), as_int8(b)
    bname = node.inputs[1]
    packed = ctx.packed.get(bname)
    if packed is None and a.device.type == "cuda":
        # a weight computed at run time: laid out for the kernel per call
        packed = pack_qmatmul_weight(bi)
    acc = matmul_integer_int8(ai, bi, packed=packed)
    if alpha is not None:
        colsum = ctx.packed.get(colsum_key(bname))
        if colsum is None:
            colsum = bi.sum(dim=0, dtype=torch.int32)
        acc = acc + alpha * colsum
    if beta is not None:
        acc = acc + beta * ai.sum(dim=-1, keepdim=True, dtype=torch.int32)
        if alpha is not None:
            acc = acc + b.shape[0] * alpha * beta
    return (acc,)


@register("DynamicQuantizeLinear")
def dynamic_quantize_linear(ctx: LoweringContext, node: Node, ins):
    """uint8 per-tensor quantization, the ONNX spec's arithmetic in x's
    dtype, as the JAX emitter: (y, scale f32, zero point uint8). The
    division by 255 runs as XLA runs the JAX emitter's division by that
    literal: a multiply by its reciprocal, rounded to x's dtype."""
    x = ins[0]
    x_min = torch.clamp_max(torch.amin(x), 0.0)
    x_max = torch.clamp_min(torch.amax(x), 0.0)
    inv = float(torch.tensor(1.0 / 255.0, dtype=x.dtype))
    scale = (x_max - x_min) * inv
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(0.0 - x_min / scale), 0.0, 255.0)
    # + an f32 zero point: f32 from here on, also for a bf16 x
    y = torch.add(*promote(torch.round(x / scale), zp.to(torch.float32)))
    y = torch.clamp(y, 0.0, 255.0)
    return (y.to(torch.uint8), scale.to(torch.float32), zp.to(torch.uint8))
