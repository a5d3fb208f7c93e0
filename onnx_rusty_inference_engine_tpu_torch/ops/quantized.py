"""Quantized ONNX op emitters: QuantizeLinear / DequantizeLinear /
QLinearConv / ConvInteger / QLinearMatMul / QGemm / MatMulNBits /
MatMulInteger / DynamicQuantizeLinear, and ONNX Runtime's QLinear contrib
ops.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/quantized.py
for the INT8 CNN (SqueezeNet, ResNet-50, MobileNetV2), BERT and ViT paths
and the INT4 decode paths.
Requant math (ONNX QLinear convention): y = saturate(round(acc * (x_s *
w_s / y_s)) + y_zp), rounding half to even.

Every form of ONNX Runtime's QOperator files runs on the hand-written
kernels: int8 or uint8 activations with zero points, int8 or uint8 weights
(zero point per tensor or per channel), int8 or uint8 outputs with zero
points. QLinearConv (1-D, 2-D and 3-D, any stride, padding and dilation)
and ConvInteger run group 1 on the implicit-GEMM kernel (ops/kernels/
qconv_int8.py; a uint8 x on its uint8-A build) and group > 1 on the grouped
kernel (ops/kernels/qconv_grouped_int8.py): the x zero point is the
padding's value and, as -zx * sum w, part of the int32 bias; the epilogue
adds the y zero point and saturates to y's type. A weight zero point needs
the window sums of x: the int32 output of the same kernel on the weight and
on an all-ones weight, corrected and requantized in PyTorch in the JAX
emitter's order. QLinearMatMul (an a of any rank, a 2-D or batched b) and
QGemm run on ops/kernels/qmatmul_int8.py: uint8 operands shifted into int8
(`as_int8`), a's zero point folded into the bias as -za * colsum(b), y's in
the requant epilogue; a b zero point takes the int32 epilogue and
MatMulInteger's corrections. Every result but QGemm's quantized form (at
most 1 LSB: its multiplier folds alpha and y_s) is the JAX emitter's value
bit for bit, and for a uint8 output the ONNX spec's (the JAX emitter
saturates every output to int8).

A zero point may be a graph constant or computed at run time (ONNX
Runtime's `quantize_dynamic` form of a conv net feeds each ConvInteger the
x zero point DynamicQuantizeLinear computes). A constant one reaches the
kernels as a launch argument, and its corrections are made once, when the
Engine is built (weights.prepack_int8_weights). A run-time one stays a
device tensor (`_zero_point`): the kernels read the pad value and y's zero
point from device memory, and the corrections (-zx * sum w, -za *
colsum(b), the weight and b zero points' terms) are computed in the graph,
so a captured CUDA graph replays with each run's values.

QLinearAdd, QLinearMul (the quantizer's residual adds), QLinearSigmoid,
QLinearLeakyRelu, QLinearGlobalAveragePool, QLinearAveragePool and
QLinearConcat dequantize, compute and requantize elementwise in PyTorch,
in the input's type, as the JAX emitters do.

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
from .kernels.qconv_grouped_int8 import (pack_qconv_grouped_weight,
                                         qconv_grouped_int8,
                                         qconv_grouped_int8_requant)
from .kernels.qconv_int8 import (pack_qconv_weight, qconv_int8,
                                 qconv_int8_requant)
from .kernels.qmatmul_int4 import (interleaved_layout, qmatmul_int4_bf16,
                                   qmatmul_int4_planar)
from .kernels.qmatmul_int8 import (QTYPES, _requant, as_int8, colsum_key,
                                   folded_bias_key, matmul_integer_int8,
                                   ones_key, pack_qmatmul_weight,
                                   qmatmul_int8, qmatmul_int8_requant)
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import _conv_padding, average_pool, promote


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
# zero points
# --------------------------------------------------------------------------
def _shift(dtype: torch.dtype) -> int:
    """What `as_int8` subtracts from a tensor of this dtype."""
    return 128 if dtype == torch.uint8 else 0


def _zero_point(ctx: LoweringContext, node: Node, ins, idx: int, what: str,
                t: Optional[torch.Tensor], per_tensor: bool = True):
    """Input idx's zero point as the kernels take it, less `_shift` of the
    operand `t` it belongs to. Known before the run (a constant or absent,
    absent being 0 less the shift): a Python int (per_tensor), else an
    int64 numpy array of 1 or N values. Computed at run time: an int32
    device tensor of 1 (per_tensor) or N values (`_zp_tensor`), which the
    kernels read from device memory."""
    name = node.inputs[idx] if len(node.inputs) > idx else ""
    shift = _shift(t.dtype) if t is not None else 0
    if not name:
        return -shift if per_tensor else np.asarray([-shift], np.int64)
    v = ctx.constant(name)
    if v is None:  # computed at run time: stays on the device
        v = ins[idx].to(torch.int32).reshape(-1) - shift
    else:
        v = np.asarray(v).astype(np.int64).reshape(-1) - shift
    n = v.numel() if isinstance(v, torch.Tensor) else v.size
    if per_tensor:
        if n != 1:
            raise UnsupportedOpError(
                f"{node.op_type} {node.name or node.outputs[0]!r}: "
                f"{what}_zero_point has {n} values (ONNX gives one)")
        return v if isinstance(v, torch.Tensor) else int(v[0])
    return v


def _nonzero(z) -> bool:
    """Whether a zero point from `_zero_point` may be other than 0: one
    computed at run time may be."""
    return isinstance(z, torch.Tensor) or bool(np.any(z))


def _out_dtype(y_zp: Optional[torch.Tensor], like: torch.Tensor):
    """ONNX: the output takes y_zero_point's type (the input's where there
    is none)."""
    return y_zp.dtype if y_zp is not None else like.dtype


def _zp_tensor(t: Optional[torch.Tensor], operand: torch.Tensor):
    """A zero point input on the device less `_shift` of its operand, as
    int32 (a Python int where the input is absent). Made from the input
    tensor, which the engine placed on the device before the run: a
    capture takes no host copy."""
    shift = _shift(operand.dtype)
    if t is None:
        return -shift
    return t.to(torch.int32).reshape(-1) - shift


# --------------------------------------------------------------------------
# QLinearConv / ConvInteger
# --------------------------------------------------------------------------
def _unsupported_qconv(x, w, spatial, group) -> Optional[str]:
    """Why the kernels cannot run this conv, or None."""
    if spatial not in (1, 2, 3) or w.dim() != x.dim():
        return (f"{spatial}-D spatial with w {tuple(w.shape)} (ONNX convs "
                f"over 1-3 spatial dims: the kernels take those)")
    if group < 1 or x.shape[1] != w.shape[1] * group \
            or w.shape[0] % group:
        return (f"group={group} with x {tuple(x.shape)} and w "
                f"{tuple(w.shape)} (channels do not split into the groups)")
    if x.dtype not in QTYPES or w.dtype not in QTYPES:
        return f"{x.dtype} x {w.dtype} operands (ONNX gives int8 or uint8)"
    return None


class _Conv:
    """One QLinearConv or ConvInteger as the kernels take it: 1-D convs as
    H = 1, 2-D and 3-D as they are, the weight as int8 (`as_int8`) with its
    zero point shifted to match, the packed weights from the Engine (or
    packed per call on the card for a weight computed at run time), each
    zero point known before the run or a device tensor (`_zero_point`)."""

    def __init__(self, ctx: LoweringContext, node: Node, ins, w_in: int,
                 zx_in: int, zw_in: int):
        x, w = ins[0], ins[w_in]
        name = node.name or node.outputs[0]
        spatial = x.dim() - 2
        self.group = int(node.attr("group", 1))
        why = _unsupported_qconv(x, w, spatial, self.group)
        if why is not None:
            raise UnsupportedOpError(f"{node.op_type} {name!r}: {why}")
        kernel = node.attr("kernel_shape", list(w.shape[2:]))
        strides = [int(s) for s in node.attr("strides", [1] * spatial)]
        dilations = [int(d) for d in node.attr("dilations", [1] * spatial)]
        padding = _conv_padding(node, x.shape[2:], kernel, strides,
                                dilations)
        self.flat = spatial == 1
        if self.flat:  # a 1-D conv as a 2-D one of height 1
            x, w = x.unsqueeze(2), w.unsqueeze(2)
            strides, dilations = [1] + strides, [1] + dilations
            padding = [(0, 0)] + list(padding)
        self.x, self.geom = x, dict(stride=strides, padding=padding,
                                    dilation=dilations)
        self.spatial = x.dim() - 2  # of the kernels' operands
        self.zx = _zero_point(ctx, node, ins, zx_in, "x", None)
        self.zw = _zero_point(ctx, node, ins, zw_in, "w", w,
                              per_tensor=False)
        self.zw_t = _zp_tensor(ins[zw_in] if len(ins) > zw_in else None, w)
        self.wname = node.inputs[w_in]
        self.packed = ctx.packed.get(self.wname)
        self.ctx = ctx
        self.w = w
        if self.packed is None and x.device.type == "cuda":
            # a weight computed at run time: laid out for the kernel per call
            self.packed = _pack_conv(as_int8(w), self.group)
        # the plain versions read the int8 values; the kernel, the layout
        self.wk = as_int8(w) if x.device.type == "cpu" else w

    def wsum(self) -> torch.Tensor:
        """The int8 weight's sums per output channel (int32 [O])."""
        s = self.ctx.packed.get(colsum_key(self.wname))
        if s is None:
            s = as_int8(self.w).sum(dim=tuple(range(1, self.w.dim())),
                                    dtype=torch.int32)
        return s

    def per_channel(self, t: torch.Tensor) -> torch.Tensor:
        """A per-output-channel (or one-value) tensor shaped to broadcast
        over the kernels' [B, O, spatial...] output."""
        return t.reshape((1, -1) + (1,) * self.spatial)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y.squeeze(2) if self.flat else y

    def sums(self) -> torch.Tensor:
        """The exact int32 sum_window (x - zx) * (w - zw) [B, O, OH, OW],
        padding taps holding zx: the kernel's int32 epilogue on x and w,
        then -zx * sum w, and where w has a zero point, -zw * sum_window x
        (the window sums of an all-ones weight, one per group, by the same
        kernel) + taps * zx * zw."""
        x, wk, zx, g = self.x, self.wk, self.zx, self.group
        if g == 1:
            acc = qconv_int8(x, wk, **self.geom, pad_value=zx,
                             packed=self.packed)
        else:
            acc = qconv_grouped_int8(x, wk, None, **self.geom, pad_value=zx,
                                     packed=self.packed)
        if _nonzero(zx):
            acc = acc - self.per_channel(zx * self.wsum())
        if _nonzero(self.zw):
            O, Cg = self.w.shape[:2]
            kernel = tuple(self.w.shape[2:])
            ones = torch.ones((g, Cg) + kernel, dtype=torch.int8,
                              device=x.device)
            packed = self.ctx.packed.get(ones_key(self.wname))
            if packed is None and x.device.type == "cuda":
                packed = _pack_conv(ones, g)
            conv = qconv_int8 if g == 1 else qconv_grouped_int8
            extra = {} if g == 1 else {"bias": None}
            xsum = conv(x, ones, **extra, **self.geom, pad_value=zx,
                        packed=packed)
            xsum = xsum.repeat_interleave(O // g, dim=1)
            zw = self.zw_t
            if isinstance(zw, torch.Tensor):
                zw = self.per_channel(zw)
            taps = Cg * int(np.prod(kernel))
            acc = acc - zw * xsum + (taps * zx) * zw
        return acc


def _pack_conv(w: torch.Tensor, group: int) -> torch.Tensor:
    """An int8 conv weight [O, C/group, KH, KW] (or [O, C/group, KD, KH,
    KW]) in its kernel's layout."""
    return (pack_qconv_weight if group == 1 else pack_qconv_grouped_weight)(w)


@register("QLinearConv")
def qlinear_conv(ctx: LoweringContext, node: Node, ins):
    """ONNX QLinearConv in every QOperator form: int8 or uint8 x and y with
    zero points (known before the run or computed in it), int8 or uint8 w
    with a zero point per tensor or per channel, any group, dilation, 1-D,
    2-D and 3-D. Where w's zero point is 0 (ONNX Runtime's symmetric
    weights) it is one launch: x's zero point is the pad value and, as
    -zx * sum w, part of the int32 bias; the epilogue adds y's zero point
    and saturates to y's type. Otherwise the int32 sums (`_Conv.sums`) get
    the bias and the JAX emitter's requant in PyTorch."""
    (x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    c = _Conv(ctx, node, ins, 3, 2, 5)
    zy = _zero_point(ctx, node, ins, 7, "y", None)
    y_dtype = _out_dtype(y_zp, x)
    # the multiplier in fp32 and in the JAX emitter's order
    mult = (x_s.to(torch.float32) * w_s.to(torch.float32)
            / y_s.to(torch.float32))
    if _nonzero(c.zw):
        return (c.out(_requant(c.sums(), mult, bias, channel_dim=1,
                               y_zp=zy, out_dtype=y_dtype)),)
    b = bias
    if _nonzero(c.zx):
        # folded at Engine build for a constant zx; in the graph otherwise
        b = (None if isinstance(c.zx, torch.Tensor)
             else ctx.packed.get(folded_bias_key(node.outputs[0])))
        if b is None:
            b = -c.zx * c.wsum()
            if bias is not None:
                b = b + bias.to(torch.int32)
    conv = qconv_int8_requant if c.group == 1 else qconv_grouped_int8_requant
    return (c.out(conv(c.x, c.wk, mult, b, **c.geom, pad_value=c.zx,
                       y_zp=zy, out_dtype=y_dtype, packed=c.packed)),)


def qlinear_conv_int32(ctx: LoweringContext, node: Node, ins):
    """A QLinearConv split at its int32 sums, for a row-parallel run
    (parallel/spmd.py) that sums them over ranks before the requant:
    (the exact int32 sums over this node's input channels, without the
    bias; `finish`, which adds the bias and requantizes them as the
    emitter's int32 form does)."""
    (x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    c = _Conv(ctx, node, ins, 3, 2, 5)
    zy = _zero_point(ctx, node, ins, 7, "y", None)
    y_dtype = _out_dtype(y_zp, x)
    mult = (x_s.to(torch.float32) * w_s.to(torch.float32)
            / y_s.to(torch.float32))

    def finish(acc: torch.Tensor) -> torch.Tensor:
        return c.out(_requant(acc, mult, bias, channel_dim=1, y_zp=zy,
                              out_dtype=y_dtype))

    return c.sums(), finish


@register("ConvInteger")
def conv_integer(ctx: LoweringContext, node: Node, ins):
    """ONNX ConvInteger: the exact int32 sum_window (x - x_zp)(w - w_zp),
    int8 or uint8 operands, w_zp per tensor or per output channel, either
    zero point a constant or computed at run time (ONNX Runtime's
    `quantize_dynamic` form: DynamicQuantizeLinear's), any group, 1-D, 2-D
    and 3-D, on the conv kernels' int32 output."""
    c = _Conv(ctx, node, ins, 1, 2, 3)
    return (c.out(c.sums()),)


# --------------------------------------------------------------------------
# QLinearMatMul / QGemm
# --------------------------------------------------------------------------
def _unsupported_qmatmul(a, b) -> Optional[str]:
    """Why the kernel cannot run this QLinearMatMul, or None."""
    if a.dtype not in QTYPES or b.dtype not in QTYPES:
        return f"{a.dtype} x {b.dtype} operands (ONNX gives int8 or uint8)"
    if b.dim() < 2 or a.dim() < 1 or a.shape[-1] != b.shape[-2] \
            or (b.dim() > 2 and a.dim() < 2):
        return f"a {tuple(a.shape)} @ b {tuple(b.shape)}"
    return None


def _int8_product(ctx: LoweringContext, bname: Optional[str], ai, b, za,
                  zb, zb_t, bias, mult, zy, y_dtype, packed):
    """One 2-D b [K, N] (int8 or uint8) against ai = as_int8(a) [..., K],
    a's zero point za and b's zb (`_zero_point`: known before the run, or
    device tensors; zb_t the same on the device, `_zp_tensor`) already less
    their `_shift`s: requantized to y_dtype (int8 or uint8) with y's zero
    point zy, or, where mult is None, the exact int32 (a - za)(b - zb) +
    bias.
    Where b has no zero point, -za * colsum(b) joins the bias and the
    kernel's requant epilogue does the rest; otherwise the int32 epilogue
    and the corrections of MatMulInteger, then the JAX emitter's requant."""
    K, N = b.shape
    a2 = ai.reshape(-1, K).contiguous()
    bi = as_int8(b) if packed is None or a2.device.type == "cpu" else b
    if packed is None and a2.device.type == "cuda":
        packed = pack_qmatmul_weight(bi)  # a weight computed at run time

    def colsum():
        s = ctx.packed.get(colsum_key(bname)) if bname else None
        return s if s is not None else as_int8(b).sum(dim=0,
                                                     dtype=torch.int32)

    if bias is not None:
        bias = bias.to(torch.int32)
    if mult is not None and not _nonzero(zb) and mult.numel() in (1, N):
        if _nonzero(za):
            b_f = -za * colsum()
            bias = b_f if bias is None else bias + b_f
        y = qmatmul_int8_requant(a2, bi, mult, bias, y_zp=zy,
                                 out_dtype=y_dtype, packed=packed)
        return y.reshape(*ai.shape[:-1], N)
    acc = qmatmul_int8(a2, bi, packed=packed)
    if _nonzero(za):
        acc = acc - za * colsum()
    if _nonzero(zb):
        acc = acc - zb_t * a2.sum(dim=-1, keepdim=True, dtype=torch.int32)
        if _nonzero(za):
            acc = acc + K * za * zb_t
    if bias is not None:
        acc = acc + bias
    acc = acc.reshape(*ai.shape[:-1], N)
    if mult is None:
        return acc
    return _requant(acc, mult, None, channel_dim=-1, y_zp=zy,
                    out_dtype=y_dtype)


@register("QLinearMatMul")
def qlinear_matmul(ctx: LoweringContext, node: Node, ins):
    """ONNX QLinearMatMul in every QOperator form: int8 or uint8 a, b and
    y, zero points on all three (b's per tensor or per column), an a of any
    rank, and a batched b (>= 3-D, one launch per batch entry), each zero
    point a constant or computed at run time. uint8 operands are shifted
    into int8 (`as_int8`) and the zero points moved with them; see
    `_int8_product`."""
    (a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    why = _unsupported_qmatmul(a, b)
    if why is not None:
        raise UnsupportedOpError(
            f"QLinearMatMul {node.name or node.outputs[0]!r}: {why}")
    za = _zero_point(ctx, node, ins, 2, "a", a)
    zb = _zero_point(ctx, node, ins, 5, "b", b, per_tensor=False)
    zb_t = _zp_tensor(b_zp, b)
    zy = _zero_point(ctx, node, ins, 7, "y", None)
    y_dtype = _out_dtype(y_zp, a)
    # in fp32 and in the JAX emitter's order, from tensors on the device (a
    # true division: a CPU scalar divisor becomes a reciprocal multiply on
    # the card); a 1-D b_s is per output column, broadcast over the last dim
    mult = (a_s.to(torch.float32) * b_s.to(torch.float32)
            / y_s.to(torch.float32))
    ai = as_int8(a)
    bname = node.inputs[3]
    if b.dim() == 2:
        return (_int8_product(ctx, bname, ai, b, za, zb, zb_t, bias, mult,
                              zy, y_dtype, ctx.packed.get(bname)),)
    # a batched b: one product per batch entry of the broadcast batch dims
    K, N = b.shape[-2:]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    M = a.shape[-2]
    ae = ai.expand(*batch, M, K).reshape(-1, M, K)
    be = b.expand(*batch, K, N).reshape(-1, K, N)
    out = torch.stack([_int8_product(ctx, None, ae[i], be[i], za, zb, zb_t,
                                     bias, mult, zy, y_dtype, None)
                       for i in range(ae.shape[0])])
    return (out.reshape(*batch, M, N),)


def qlinear_matmul_int32(ctx: LoweringContext, node: Node, ins):
    """A QLinearMatMul with a 2-D b split at its int32 sums, for a
    row-parallel run (parallel/spmd.py): (the exact int32 (a - za)(b - zb)
    over this node's K, without the bias; `finish`, which adds the bias
    and requantizes them as the emitter does)."""
    (a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp) = ins[:8]
    bias = ins[8] if len(ins) > 8 else None
    why = _unsupported_qmatmul(a, b) or (
        None if b.dim() == 2 else f"a batched b {tuple(b.shape)}")
    if why is not None:
        raise UnsupportedOpError(
            f"QLinearMatMul {node.name or node.outputs[0]!r}: {why}")
    za = _zero_point(ctx, node, ins, 2, "a", a)
    zb = _zero_point(ctx, node, ins, 5, "b", b, per_tensor=False)
    zy = _zero_point(ctx, node, ins, 7, "y", None)
    y_dtype = _out_dtype(y_zp, a)
    mult = (a_s.to(torch.float32) * b_s.to(torch.float32)
            / y_s.to(torch.float32))
    acc = _int8_product(ctx, node.inputs[3], as_int8(a), b, za, zb,
                        _zp_tensor(b_zp, b), None, None, zy, y_dtype,
                        ctx.packed.get(node.inputs[3]))

    def finish(acc: torch.Tensor) -> torch.Tensor:
        return _requant(acc, mult, bias, channel_dim=-1, y_zp=zy,
                        out_dtype=y_dtype)

    return acc, finish


@register("QGemm", domain="com.microsoft")
def qgemm(ctx: LoweringContext, node: Node, ins):
    """ONNX Runtime's QGemm: (alpha * (A - a_zp)(B - b_zp) + C) at scale
    a_s * b_s, transA / transB, an int32 bias C, requantized to y's type
    with y's zero point, or left in f32 where y_scale is absent (the JAX
    emitter's order: alpha * f32(acc + C) * (a_s * b_s)). The quantized
    form runs on the requant epilogue with mult = alpha * a_s * b_s / y_s,
    which rounds where the JAX emitter's f32 division by y_s may not: at
    most 1 LSB apart at a tie. Each zero point a constant or computed at
    run time."""
    (a, a_s, a_zp, b, b_s, b_zp) = ins[:6]
    bias = ins[6] if len(ins) > 6 else None
    y_s = ins[7] if len(ins) > 7 else None
    y_zp = ins[8] if len(ins) > 8 else None
    name = node.name or node.outputs[0]
    if a.dim() != 2 or b.dim() != 2:
        raise UnsupportedOpError(f"QGemm {name!r}: a {tuple(a.shape)}, b "
                                 f"{tuple(b.shape)} (ONNX gives 2-D)")
    alpha = float(node.attr("alpha", 1.0))
    if int(node.attr("transA", 0)):
        a = a.t().contiguous()
    if int(node.attr("transB", 0)):
        b = b.t()  # per-column b_s already follows the output dim
    why = _unsupported_qmatmul(a, b)
    if why is not None:
        raise UnsupportedOpError(f"QGemm {name!r}: {why}")
    za = _zero_point(ctx, node, ins, 2, "a", a)
    zb = _zero_point(ctx, node, ins, 5, "b", b, per_tensor=False)
    zb_t = _zp_tensor(b_zp, b)
    scale = a_s.to(torch.float32) * b_s.to(torch.float32)
    bname = node.inputs[3]
    packed = ctx.packed.get(bname)
    if y_s is None:  # the float output form
        acc = _int8_product(ctx, bname, as_int8(a), b, za, zb, zb_t, bias,
                            None, 0, None, packed)
        return (alpha * acc.to(torch.float32) * scale,)
    mult = alpha * scale / y_s.to(torch.float32)
    return (_int8_product(ctx, bname, as_int8(a), b, za, zb, zb_t, bias,
                          mult, _zero_point(ctx, node, ins, 8, "y", None),
                          _out_dtype(y_zp, a), packed),)


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
# the other QLinear contrib ops of ONNX Runtime's QOperator files: dequantize
# -> f32 op -> requantize elementwise in PyTorch, in the input's type, as the
# JAX emitters (which keep them outside Pallas)
# --------------------------------------------------------------------------
def _qlinear_unary(fn):
    def emit(ctx: LoweringContext, node: Node, ins):
        x, x_s, x_zp, y_s = ins[0], ins[1], ins[2], ins[3]
        y_zp = ins[4] if len(ins) > 4 else None
        return (_q(fn(node, _dq(x, x_s, x_zp)), y_s, y_zp, x.dtype),)
    return emit


register("QLinearSigmoid", domain="com.microsoft")(
    _qlinear_unary(lambda n, x: torch.sigmoid(x)))
register("QLinearLeakyRelu", domain="com.microsoft")(_qlinear_unary(
    lambda n, x: torch.where(x >= 0, x,
                             x * float(np.float32(n.attr("alpha", 0.01))))))


@register("QLinearGlobalAveragePool", domain="com.microsoft")
def qlinear_global_average_pool(ctx: LoweringContext, node: Node, ins):
    x, x_s, x_zp, y_s = ins[0], ins[1], ins[2], ins[3]
    y_zp = ins[4] if len(ins) > 4 else None
    spatial = tuple(range(2, x.dim()))
    if int(node.attr("channels_last", 0)):
        spatial = tuple(range(1, x.dim() - 1))
    out = _dq(x, x_s, x_zp).mean(dim=spatial, keepdim=True)
    return (_q(out, y_s, y_zp, x.dtype),)


@register("QLinearAveragePool", domain="com.microsoft")
def qlinear_average_pool(ctx: LoweringContext, node: Node, ins):
    x, x_s, x_zp, y_s = ins[0], ins[1], ins[2], ins[3]
    y_zp = ins[4] if len(ins) > 4 else None
    (out,) = average_pool(ctx, node, [_dq(x, x_s, x_zp)])
    return (_q(out, y_s, y_zp, x.dtype),)


@register("QLinearConcat", domain="com.microsoft")
def qlinear_concat(ctx: LoweringContext, node: Node, ins):
    y_s, y_zp = ins[0], ins[1]
    parts = [_dq(ins[i], ins[i + 1], ins[i + 2])
             for i in range(2, len(ins), 3)]
    out = torch.cat(parts, dim=int(node.attr("axis", 1)))
    return (_q(out, y_s, y_zp, ins[2].dtype),)


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
