"""fp32/generic ONNX op emitters -> PyTorch.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/standard.py,
with every op type it registers: the convolutions and pools, the
elementwise, activation and reduction families, the shape and index ops,
Pad, the norms, Resize, GridSample and Einsum. Shape, Size, Constant,
ConstantOfShape and Range have no emitter: `LoweringContext.run_nodes`
makes them static values (registry.STATIC_OPS). Each keeps the JAX
emitter's semantics (where that emitter departs from the ONNX spec, the
port follows the spec and says so in the emitter): NCHW layout,
ONNX pads as (lo, hi) pairs applied explicitly (so asymmetric pads and
ceil_mode follow the JAX package's arithmetic), opset < 13 Softmax
flattening, Gather's wrap-and-clamp of indices.

fp32 Conv, MatMul and Gemm run in full fp32, as the JAX package's
Precision.HIGHEST does: TF32 (cuDNN's default for convs) is switched off
around the call.

Operands of mixed float types promote as JAX promotes them (`promote`):
the JAX lowering closes over the graph's non-weight constants as strongly
typed arrays, so a bf16 activation times an f32 0-d constant is f32 there,
where PyTorch would keep bf16. Under the fp32 dtype policy nothing mixes.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import onnx_io
from ..graph import Node, _broadcast_expand, _resolve_reshape
from ..utils.fp32 import cudnn_fp32_exact as _fp32_exact
from ..utils.fp32 import matmul_fp32_exact  # noqa: F401  (re-exported)
from .registry import LoweringContext, UnsupportedOpError, register

Padding = List[Tuple[int, int]]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _onnx_pads_to_lax(pads: Sequence[int], spatial: int) -> Padding:
    """ONNX pads = [x1_begin, x2_begin, ..., x1_end, x2_end, ...] -> [(lo, hi)]."""
    return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]


def _auto_pad(auto_pad: str, in_spatial: Sequence[int],
              kernel: Sequence[int], strides: Sequence[int],
              dilations: Sequence[int]) -> Padding:
    """SAME_UPPER / SAME_LOWER / VALID padding per the ONNX spec."""
    if auto_pad == "VALID":
        return [(0, 0)] * len(in_spatial)
    out = []
    for size, k, s, d in zip(in_spatial, kernel, strides, dilations):
        eff_k = (k - 1) * d + 1
        out_size = -(-size // s)  # ceil
        total = max(0, (out_size - 1) * s + eff_k - size)
        lo = total // 2
        hi = total - lo
        if auto_pad == "SAME_LOWER":
            lo, hi = hi, lo
        out.append((lo, hi))
    return out


def _conv_padding(node: Node, in_spatial, kernel, strides, dilations
                  ) -> Padding:
    pads = node.attr("pads")
    auto_pad = node.attr("auto_pad", "NOTSET")
    # Per ONNX spec pads and auto_pad are mutually exclusive; some exporters
    # set both — explicit nonzero pads win.
    if pads is not None and (auto_pad in ("NOTSET", "") or any(pads)):
        return _onnx_pads_to_lax(pads, len(in_spatial))
    if auto_pad in ("NOTSET", "", None):
        return [(0, 0)] * len(in_spatial)
    return _auto_pad(auto_pad, in_spatial, kernel, strides, dilations)


def _pad(x: torch.Tensor, padding: Padding, value: float) -> torch.Tensor:
    """Pad the trailing len(padding) dims by (lo, hi) pairs."""
    if not any(lo or hi for lo, hi in padding):
        return x
    flat: List[int] = []
    for lo, hi in reversed(padding):  # F.pad lists the last dim first
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=value)


def promote(*xs):
    """The operands (tensors, or Python numbers, which are left as they
    are) cast to one dtype, the one `jnp.result_type` gives for strongly
    typed arrays: a 0-d tensor counts like any other, where PyTorch would
    let a dimensioned operand's dtype of the same kind win (bf16 [n] * f32
    0-d is bf16 in PyTorch, f32 in JAX). Only where the tensors' dtypes
    differ and one of them is floating; among floats, and for integers
    with floats, PyTorch's `promote_types` and JAX's lattice agree."""
    dts = [x.dtype for x in xs if isinstance(x, torch.Tensor)]
    if len(set(dts)) < 2 or not any(d.is_floating_point for d in dts):
        return xs
    dt = functools.reduce(torch.promote_types, dts)
    return tuple(x.to(dt) if isinstance(x, torch.Tensor) else x for x in xs)


def true_div(a, c: float):
    """a / c as a true division on every device: on the card PyTorch turns
    a division by a Python number into a multiply by its reciprocal, one
    rounding more, which moves a sample point or a bin boundary by an ulp
    against the CPU. Numpy arrays divide as they are."""
    if not isinstance(a, torch.Tensor):
        return a / c
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def _torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (bool, ints, floats)."""
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------
@register("Conv")
def conv(ctx: LoweringContext, node: Node, ins):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    spatial = x.dim() - 2
    if spatial not in _CONV:
        raise UnsupportedOpError(f"Conv: {spatial}-D spatial")
    kernel = node.attr("kernel_shape", list(w.shape[2:]))
    strides = [int(s) for s in node.attr("strides", [1] * spatial)]
    dilations = [int(d) for d in node.attr("dilations", [1] * spatial)]
    group = int(node.attr("group", 1))
    padding = _conv_padding(node, x.shape[2:], kernel, strides, dilations)
    with _fp32_exact():
        out = _CONV[spatial](_pad(x, padding, 0.0), w, b, stride=strides,
                             dilation=dilations, groups=group)
    return (out,)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("ConvTranspose")
def conv_transpose(ctx: LoweringContext, node: Node, ins):
    """The JAX emitter's arithmetic: the output of a transposed conv with
    no padding, (in - 1) * stride + (k - 1) * dilation + 1 long, then
    `pads` begin cut from the front and `pads` end less `output_padding`
    from the back (a negative cut is zeros, as the JAX emitter's wider
    padding gives). Weights [C_in, C_out / group, *k], as PyTorch's.
    `output_shape` and `auto_pad` are refused: the JAX emitter reads
    neither, and the port does not implement them."""
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    spatial = x.dim() - 2
    if spatial not in _CONV_T:
        raise UnsupportedOpError(f"ConvTranspose: {spatial}-D spatial")
    if node.attr("output_shape") is not None:
        raise UnsupportedOpError("ConvTranspose: output_shape is not ported")
    if _str(node.attr("auto_pad", "NOTSET")) not in ("NOTSET", ""):
        raise UnsupportedOpError("ConvTranspose: auto_pad is not ported")
    strides = [int(v) for v in node.attr("strides", [1] * spatial)]
    dilations = [int(v) for v in node.attr("dilations", [1] * spatial)]
    group = int(node.attr("group", 1))
    pads = [int(v) for v in node.attr("pads", [0] * (2 * spatial))]
    out_pads = [int(v) for v in node.attr("output_padding", [0] * spatial)]
    with _fp32_exact():
        y = _CONV_T[spatial](x, w, None, stride=strides, groups=group,
                             dilation=dilations)
    y = _pad(y, [(-pads[i], out_pads[i] - pads[i + spatial])
                 for i in range(spatial)], 0.0)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * spatial)
    return (y,)


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------
def _pool(node: Node, x: torch.Tensor):
    """Window geometry of a pooling node: (padding, kernel, strides,
    dilations), with ceil_mode folded into the end padding as the JAX
    package does, so the pooling itself always floors."""
    spatial = x.dim() - 2
    kernel = [int(k) for k in node.attr("kernel_shape")]
    strides = [int(s) for s in node.attr("strides", [1] * spatial)]
    dilations = [int(d) for d in node.attr("dilations", [1] * spatial)]
    ceil_mode = int(node.attr("ceil_mode", 0))
    padding = _conv_padding(node, x.shape[2:], kernel, strides, dilations)
    if ceil_mode:
        # extend end-padding so the last partial window is included
        new_pad = []
        for i, (lo, hi) in enumerate(padding):
            size = x.shape[2 + i]
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            out_ceil = -(-(size + lo + hi - eff_k) // strides[i]) + 1
            needed = (out_ceil - 1) * strides[i] + eff_k - (size + lo)
            new_pad.append((lo, max(hi, needed)))
        padding = new_pad
    return padding, kernel, strides, dilations


# integer types whose every value float32 holds exactly
_POOL_VIA_FLOAT = (torch.int8, torch.uint8, torch.int16)


@register("MaxPool")
def max_pool(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    if len([o for o in node.outputs if o]) > 1:
        raise UnsupportedOpError("MaxPool: the Indices output is not ported")
    spatial = x.dim() - 2
    if spatial not in _MAX_POOL:
        raise UnsupportedOpError(f"MaxPool: {spatial}-D spatial")
    padding, kernel, strides, dilations = _pool(node, x)
    if x.is_floating_point():
        xf, fill = x, float("-inf")
    elif x.dtype in _POOL_VIA_FLOAT:
        # PyTorch's CUDA max-pool takes no integers; float32 holds these
        # exactly. Pads take the type's min, as the JAX emitter's iinfo.min.
        xf, fill = x.to(torch.float32), float(torch.iinfo(x.dtype).min)
    else:
        raise UnsupportedOpError(f"MaxPool: {x.dtype} input")
    out = _MAX_POOL[spatial](_pad(xf, padding, fill), kernel, strides,
                             padding=0, dilation=dilations)
    return (out.to(x.dtype),)


_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


@register("AveragePool")
def average_pool(ctx: LoweringContext, node: Node, ins):
    """The JAX emitter's: each window's sum over x zero-padded (ceil_mode
    extends the end padding), divided by the kernel's size, or, with
    padding and count_include_pad 0, by the window's count of real
    elements. Dilated windows are not taken (ONNX added them in opset 19;
    the JAX emitter's reduce_window takes them)."""
    x = ins[0]
    spatial = x.dim() - 2
    if spatial not in (1, 2, 3):
        raise UnsupportedOpError(f"AveragePool: {spatial}-D spatial")
    padding, kernel, strides, dilations = _pool(node, x)
    if any(d != 1 for d in dilations):
        raise UnsupportedOpError(f"AveragePool: dilations {dilations}")

    def window_sum(t: torch.Tensor) -> torch.Tensor:
        t = _pad(t, padding, 0.0)
        if spatial == 1:
            return F.avg_pool2d(t.unsqueeze(2), (1, kernel[0]),
                                (1, strides[0]),
                                divisor_override=1).squeeze(2)
        return _AVG_POOL[spatial](t, kernel, strides, divisor_override=1)

    out = window_sum(x)
    if int(node.attr("count_include_pad", 0)) or not any(
            lo or hi for lo, hi in padding):
        # a true division by a tensor on x's device, as XLA divides
        return (out / torch.tensor(float(math.prod(kernel)),
                                   dtype=out.dtype, device=out.device),)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return (out / window_sum(ones),)


@register("GlobalMaxPool")
def global_max_pool(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    return (torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True),)


@register("MaxUnpool")
def max_unpool(ctx: LoweringContext, node: Node, ins):
    """Each value put at its flat index into a zero tensor of the output
    shape (the `output_shape` input, else the pooling arithmetic); the
    indices count over the whole tensor, as MaxPool's Indices do."""
    x, idx = ins[0], ins[1]
    if len(ins) > 2 and ins[2] is not None:
        out_shape = tuple(int(v) for v in ctx.require_constant(
            node.inputs[2], "MaxUnpool output_shape"))
    else:
        kh, kw = [int(k) for k in node.attr("kernel_shape")]
        sh, sw = [int(v) for v in node.attr("strides", [1, 1])]
        pads = [int(p) for p in node.attr("pads", [0, 0, 0, 0])]
        N, C, OH, OW = x.shape
        out_shape = (N, C, (OH - 1) * sh + kh - pads[0] - pads[2],
                     (OW - 1) * sw + kw - pads[1] - pads[3])
    flat = torch.zeros(math.prod(out_shape), dtype=x.dtype, device=x.device)
    flat[idx.reshape(-1).to(torch.int64)] = x.reshape(-1)
    return (flat.reshape(out_shape),)


@register("GlobalAveragePool")
def global_average_pool(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    return (x.mean(dim=tuple(range(2, x.dim())), keepdim=True),)


# --------------------------------------------------------------------------
# Elementwise / shape
# --------------------------------------------------------------------------
@register("Relu")
def relu(ctx: LoweringContext, node: Node, ins):
    return (torch.clamp_min(ins[0], 0),)


@register("Concat")
def concat(ctx: LoweringContext, node: Node, ins):
    return (torch.cat(ins, dim=int(node.attr("axis", 1))),)


@register("Dropout")
def dropout(ctx: LoweringContext, node: Node, ins):
    # Inference mode: identity; mask output (if requested) is all-true.
    outs = [ins[0]]
    if len(node.outputs) > 1 and node.outputs[1]:
        outs.append(torch.ones(ins[0].shape, dtype=torch.bool,
                               device=ins[0].device))
    return tuple(outs)


# --------------------------------------------------------------------------
# Softmax
# --------------------------------------------------------------------------
def _softmax_axis(ctx: LoweringContext, node: Node) -> int:
    default = 1 if ctx.opset < 13 else -1
    return int(node.attr("axis", default))


@register("Softmax")
def softmax(ctx: LoweringContext, node: Node, ins):
    # Opset <13 semantics: flatten to 2-D at `axis`, softmax over the tail.
    x = ins[0]
    axis = _softmax_axis(ctx, node)
    if ctx.opset < 13:
        ax = axis % x.dim()
        lead = math.prod(x.shape[:ax]) if ax else 1
        return (torch.softmax(x.reshape(lead, -1), dim=-1).reshape(x.shape),)
    return (torch.softmax(x, dim=axis),)


# --------------------------------------------------------------------------
# Matmul
# --------------------------------------------------------------------------
@register("MatMul")
def matmul(ctx: LoweringContext, node: Node, ins):
    """In the promoted dtype; the result takes a's dtype, as the JAX
    emitter casts it (bf16 x f32 is an f32 product, returned as bf16)."""
    dt = ins[0].dtype
    a, b = promote(*ins)
    with matmul_fp32_exact():
        return (torch.matmul(a, b).to(dt),)


@register("Gemm")
def gemm(ctx: LoweringContext, node: Node, ins):
    """alpha * A' @ B' + beta * C, A' and B' transposed where transA /
    transB say; C (1-D or any shape that broadcasts) is skipped when beta
    is 0, as the JAX emitter does."""
    a, b = ins[0], ins[1]
    c = ins[2] if len(ins) > 2 else None
    alpha = float(node.attr("alpha", 1.0))
    beta = float(node.attr("beta", 1.0))
    if int(node.attr("transA", 0)):
        a = a.T
    if int(node.attr("transB", 0)):
        b = b.T
    dt = a.dtype
    a, b = promote(a, b)
    with matmul_fp32_exact():
        out = alpha * torch.matmul(a, b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return (out.to(dt),)


# --------------------------------------------------------------------------
# Elementwise (binary, with numpy broadcasting)
# --------------------------------------------------------------------------
def _binary(fn):
    def emit(ctx, node, ins):
        return (fn(*promote(ins[0], ins[1])),)
    return emit


register("Add")(_binary(torch.add))
register("Sub")(_binary(torch.sub))
register("Mul")(_binary(torch.mul))
register("Div")(_binary(torch.true_divide))  # jnp.divide: true division
register("Pow")(_binary(torch.pow))
register("Equal")(_binary(torch.eq))
register("Greater")(_binary(torch.gt))
register("GreaterOrEqual")(_binary(torch.ge))
register("Less")(_binary(torch.lt))
register("LessOrEqual")(_binary(torch.le))
register("And")(_binary(torch.logical_and))
register("Or")(_binary(torch.logical_or))
register("Xor")(_binary(torch.logical_xor))
register("BitwiseAnd")(_binary(torch.bitwise_and))
register("BitwiseOr")(_binary(torch.bitwise_or))


# --------------------------------------------------------------------------
# Elementwise (single input, and Where / Cast)
# --------------------------------------------------------------------------
def _unary(fn):
    def emit(ctx, node, ins):
        return (fn(ins[0]),)
    return emit


register("Tanh")(_unary(torch.tanh))
register("Sigmoid")(_unary(torch.sigmoid))
register("Neg")(_unary(torch.neg))
register("Floor")(_unary(torch.floor))
register("Round")(_unary(torch.round))  # half to even, as jnp.round
register("Abs")(_unary(torch.abs))


def _variadic(fn):
    """Min / Max / Sum-style: fold fn over the inputs left to right, in
    the dtype all of them promote to."""
    def emit(ctx, node, ins):
        xs = promote(*ins)
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return (out,)
    return emit


register("Max")(_variadic(torch.maximum))
register("Min")(_variadic(torch.minimum))


@register("Clip")
def clip(ctx: LoweringContext, node: Node, ins):
    """Bounds from the min / max attributes (before opset 11) or the
    optional inputs; either may be absent."""
    x = ins[0]
    lo = node.attr("min")
    hi = node.attr("max")
    if lo is None and len(ins) > 1 and ins[1] is not None:
        lo = ins[1]
    if hi is None and len(ins) > 2 and ins[2] is not None:
        hi = ins[2]
    x, lo, hi = promote(x, lo, hi)
    if lo is not None:
        x = torch.clamp_min(x, lo)
    if hi is not None:
        x = torch.clamp_max(x, hi)
    return (x,)


@register("Gelu")
def gelu(ctx: LoweringContext, node: Node, ins):
    a = node.attr("approximate", "none")
    if isinstance(a, bytes):  # wire-parsed string attrs arrive as bytes
        a = a.decode()
    return (F.gelu(ins[0], approximate="tanh" if a == "tanh" else "none"),)


@register("Where")
def where(ctx: LoweringContext, node: Node, ins):
    return (torch.where(ins[0], *promote(ins[1], ins[2])),)


@register("Cast")
def cast(ctx: LoweringContext, node: Node, ins):
    to = onnx_io.DTYPE_TO_NUMPY[int(node.attr("to"))]
    return (ins[0].to(_torch_dtype(to)),)


@register("Identity")
def identity(ctx: LoweringContext, node: Node, ins):
    return (ins[0],)


@register("RMSNormalization", "SimplifiedLayerNormalization")
def rms_normalization(ctx: LoweringContext, node: Node, ins):
    """x * rsqrt(mean(x^2) + eps) * scale, the mean of squares in fp32 (or
    in float64 for a float64 x)."""
    x, scale = ins[0], ins[1]
    axis = int(node.attr("axis", -1))
    eps = float(node.attr("epsilon", 1e-5))
    dims = tuple(range(axis % x.dim(), x.dim()))
    ms = torch.square(x.to(torch.promote_types(x.dtype, torch.float32))
                      ).mean(dim=dims, keepdim=True)
    return ((x * torch.rsqrt(ms + eps).to(x.dtype)) * scale,)


@register("BatchNormalization")
def batch_norm(ctx: LoweringContext, node: Node, ins):
    """Inference mode: (x - mean) * (scale * rsqrt(var + eps)) + bias per
    channel (axis 1), in the JAX emitter's order. A BN that follows a Conv
    is folded into it at import (passes.fold_batchnorm); this runs the
    others."""
    x, scale, bias, mean, var = ins[:5]
    eps = float(node.attr("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var.to(torch.float32) + eps).to(x.dtype)
    return ((x - mean.reshape(shape)) * (scale * inv).reshape(shape)
            + bias.reshape(shape),)


@register("LayerNormalization")
def layer_norm(ctx: LoweringContext, node: Node, ins):
    x, scale = ins[0], ins[1]
    bias = ins[2] if len(ins) > 2 else None
    axis = int(node.attr("axis", -1))
    eps = float(node.attr("epsilon", 1e-5))
    dims = tuple(range(axis % x.dim(), x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return (out,)


# --------------------------------------------------------------------------
# Shape manipulation
# --------------------------------------------------------------------------
@register("Reshape")
def reshape(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    shape = ctx.require_constant(node.inputs[1], "Reshape shape")
    tgt = list(_resolve_reshape(x.shape, np.asarray(shape),
                                allowzero=int(node.attr("allowzero", 0))))
    # batch polymorphism, as the JAX emitter: exports bake the batch into
    # Reshape targets; when the element counts disagree and the tail
    # divides evenly, the leading dim follows the input
    total = math.prod(x.shape)
    if math.prod(tgt) != total and -1 not in tgt:
        tail = math.prod(tgt[1:])
        if tail > 0 and total % tail == 0:
            tgt[0] = total // tail
    return (x.reshape(tgt),)


@register("Flatten")
def flatten(ctx: LoweringContext, node: Node, ins):
    """2-D [prod(shape[:axis]), prod(shape[axis:])]; a negative axis counts
    from the end (axis -r is 0)."""
    x = ins[0]
    ax = int(node.attr("axis", 1)) % (x.dim() + 1)
    return (x.reshape(math.prod(x.shape[:ax]) if ax else 1, -1),)


@register("Unsqueeze")
def unsqueeze(ctx: LoweringContext, node: Node, ins):
    """Axes from the attribute (before opset 13) or a constant input,
    inserted in ascending order as the JAX emitter does."""
    x = ins[0]
    axes = node.attr("axes")
    if axes is None:
        axes = ctx.require_constant(node.inputs[1], "Unsqueeze axes").tolist()
    for ax in sorted(int(a) for a in axes):
        x = x.unsqueeze(ax if ax >= 0 else ax + x.dim() + 1)
    return (x,)


@register("Expand")
def expand(ctx: LoweringContext, node: Node, ins):
    """Broadcast to a constant shape (a view). Batch polymorphism as the
    JAX emitter: when the run's batch differs from the declared one
    (`ctx.batch_polymorphic`), ranks match and neither leading dim is 1, the
    leading dim follows the input."""
    x = ins[0]
    shape = np.asarray(ctx.require_constant(node.inputs[1], "Expand shape"))
    if (ctx.batch_polymorphic
            and len(shape) == x.dim() and x.shape[0] != 1 and shape[0] != 1
            and int(shape[0]) != x.shape[0]):
        shape = shape.copy()
        shape[0] = x.shape[0]
    return (x.expand(_broadcast_expand(tuple(x.shape), shape)),)


@register("Slice")
def slice_op(ctx: LoweringContext, node: Node, ins):
    """Constant starts / ends / axes / steps: operands from opset 10 on, the
    starts / ends / axes attributes before. Python slice semantics, as the
    JAX emitter indexes with Python slices: negative bounds count from the
    end, out-of-range ends clamp, and a negative step walks backwards."""
    x = ins[0]
    if ctx.opset >= 10 or len(node.inputs) > 1:
        starts = ctx.require_constant(node.inputs[1], "Slice starts").tolist()
        ends = ctx.require_constant(node.inputs[2], "Slice ends").tolist()
        axes = (ctx.require_constant(node.inputs[3], "Slice axes").tolist()
                if len(node.inputs) > 3 and node.inputs[3]
                else list(range(len(starts))))
        steps = (ctx.require_constant(node.inputs[4], "Slice steps").tolist()
                 if len(node.inputs) > 4 and node.inputs[4]
                 else [1] * len(starts))
    else:
        starts = [int(v) for v in node.attr("starts")]
        ends = [int(v) for v in node.attr("ends")]
        axes = [int(v) for v in (node.attr("axes") or range(len(starts)))]
        steps = [1] * len(starts)
    for ax, st, en, sp in zip(axes, starts, ends, steps):
        ax = int(ax) % x.dim()
        lo, hi, step = slice(int(st), int(en), int(sp)).indices(x.shape[ax])
        if step > 0:
            x = x[(slice(None),) * ax + (slice(lo, hi, step),)]
        else:  # PyTorch slices take no negative step: gather the indices
            x = torch.index_select(x, ax, torch.arange(
                lo, hi, step, dtype=torch.int64, device=x.device))
    return (x,)


@register("Transpose")
def transpose(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    perm = node.attr("perm", list(reversed(range(x.dim()))))
    return (x.permute([int(p) for p in perm]),)


@register("Split")
def split(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    axis = int(node.attr("axis", 0))
    # the `split` attribute is read at every opset, as the JAX emitter
    # does (the GPT-2 builder writes it at opset 17)
    sizes = node.attr("split")
    if sizes is None and len(ins) > 1 and ins[1] is not None:
        sizes = ctx.require_constant(node.inputs[1], "Split sizes").tolist()
    n_out = len(node.outputs)
    if sizes is None:
        sizes = [x.shape[axis] // n_out] * n_out
    return tuple(torch.split(x, [int(s) for s in sizes], dim=axis))


# --------------------------------------------------------------------------
# Reductions
# --------------------------------------------------------------------------
def _reduce(fn):
    """A Reduce* emitter: axes from the attribute (before opset 18) or a
    constant input; none reduces every axis, unless noop_with_empty_axes
    says to pass the input through. fn(x, dims, keepdim)."""
    def emit(ctx: LoweringContext, node: Node, ins):
        x = ins[0]
        axes = node.attr("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = ctx.require_constant(node.inputs[1],
                                        "Reduce axes").tolist()
        keepdims = bool(int(node.attr("keepdims", 1)))
        if axes is None:
            if int(node.attr("noop_with_empty_axes", 0)):
                return (x,)
            dims = tuple(range(x.dim()))
        else:
            dims = tuple(int(a) % x.dim() for a in axes)
        return (fn(x, dims, keepdims),)
    return emit


register("ReduceMax")(_reduce(
    lambda x, dims, keepdim: torch.amax(x, dim=dims, keepdim=keepdim)))


def _wrap_indices(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """ONNX negative-index wrap, then a clamp to [0, dim - 1]: an
    out-of-range index (undefined per the spec) takes the edge row, as the
    JAX emitter's mode="clip" does, instead of raising."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx).clamp(0, dim - 1)


@register("Gather")
def gather(ctx: LoweringContext, node: Node, ins):
    x, idx = ins
    axis = int(node.attr("axis", 0)) % x.dim()
    flat = _wrap_indices(idx, x.shape[axis]).reshape(-1)
    out = torch.index_select(x, axis, flat)
    return (out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                        + tuple(x.shape[axis + 1:])),)


# --------------------------------------------------------------------------
# The rest of the JAX module's op set: elementwise and activations,
# reductions, shape and index ops, Pad, norms, Resize, GridSample, Einsum
# --------------------------------------------------------------------------
# ONNX index outputs (ArgMax, ArgMin, TopK's indices) in the dtype the JAX
# Engine returns them: int32, JAX's index type with x64 off
INDEX_DTYPE = torch.int32

# integer types PyTorch keeps without shift, bitwise-not or remainder
# kernels (on the CPU and the card alike)
_SHELL_UINTS = (torch.uint16, torch.uint32, torch.uint64)


def repeat_each(t: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Each slice along `dim` repeated r times in place (jnp.repeat with an
    int count): a broadcast and a reshape, so that nothing of it reads the
    host inside a captured run."""
    dim %= t.dim()
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1).expand(shape[:dim + 1] + [r] + shape[dim + 1:])
    shape[dim] *= r
    return t.reshape(shape)


def _str(v) -> str:
    """A string attribute (wire-parsed ones arrive as bytes)."""
    return v.decode() if isinstance(v, bytes) else str(v)


def _no_shell_uint(op: str, *xs) -> None:
    for x in xs:
        if x.dtype in _SHELL_UINTS:
            raise UnsupportedOpError(
                f"{op}: PyTorch has no {op} kernel for {x.dtype}")


register("Exp")(_unary(torch.exp))
register("Log")(_unary(torch.log))
register("Sqrt")(_unary(torch.sqrt))
register("Ceil")(_unary(torch.ceil))
register("Sign")(_unary(torch.sign))
register("Erf")(_unary(torch.erf))
register("Not")(_unary(torch.logical_not))
register("Sin")(_unary(torch.sin))
register("Cos")(_unary(torch.cos))
register("IsNaN")(_unary(torch.isnan))
register("Reciprocal")(_unary(lambda x: 1.0 / x))
register("Softplus")(_unary(F.softplus))
register("Softsign")(_unary(lambda x: x / (1 + torch.abs(x))))
register("HardSwish")(_unary(
    lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)))
register("Mish")(_unary(lambda x: x * torch.tanh(F.softplus(x))))


@register("IsInf")
def is_inf(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    pos = bool(int(node.attr("detect_positive", 1)))
    neg = bool(int(node.attr("detect_negative", 1)))
    if pos and neg:
        return (torch.isinf(x),)
    if pos:
        return (torch.isposinf(x),)
    if neg:
        return (torch.isneginf(x),)
    return (torch.zeros_like(x, dtype=torch.bool),)


@register("LeakyRelu")
def leaky_relu(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    return (torch.where(x >= 0, x, float(node.attr("alpha", 0.01)) * x),)


@register("Elu")
def elu(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    a = float(node.attr("alpha", 1.0))
    return (torch.where(x > 0, x, a * torch.expm1(x)),)


@register("Selu")
def selu(ctx: LoweringContext, node: Node, ins):
    """gamma * (x > 0 ? x : alpha * (exp(x) - 1)) with the node's alpha and
    gamma (the ONNX defaults where absent). The JAX emitter ignores both
    attributes and always uses jax.nn.selu's constants."""
    x = ins[0]
    a = float(node.attr("alpha", 1.67326319217681884765625))
    g = float(node.attr("gamma", 1.05070102214813232421875))
    return (g * torch.where(x > 0, x, a * torch.expm1(x)),)


@register("HardSigmoid")
def hard_sigmoid(ctx: LoweringContext, node: Node, ins):
    a = float(node.attr("alpha", 0.2))
    b = float(node.attr("beta", 0.5))
    return (torch.clamp(a * ins[0] + b, 0.0, 1.0),)


@register("Celu")
def celu(ctx: LoweringContext, node: Node, ins):
    a = float(node.attr("alpha", 1.0))
    x = ins[0]
    return (torch.clamp_min(x, 0)
            + torch.clamp_max(a * (torch.exp(x / a) - 1), 0.0),)


@register("ThresholdedRelu")
def thresholded_relu(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    return (torch.where(x > float(node.attr("alpha", 1.0)), x,
                        torch.zeros((), dtype=x.dtype, device=x.device)),)


@register("Shrink")
def shrink(ctx: LoweringContext, node: Node, ins):
    lambd = float(node.attr("lambd", 0.5))
    bias = float(node.attr("bias", 0.0))
    x = ins[0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.where(x < -lambd, x + bias,
                        torch.where(x > lambd, x - bias, zero)),)


@register("PRelu")
def prelu(ctx: LoweringContext, node: Node, ins):
    x, slope = promote(*ins)
    return (torch.where(x >= 0, x, x * slope),)


@register("Mod")
def mod(ctx: LoweringContext, node: Node, ins):
    """fmod 1: C's fmod (the dividend's sign); fmod 0: the divisor's sign,
    as Python's %."""
    a, b = promote(*ins)
    _no_shell_uint("Mod", a)
    if int(node.attr("fmod", 0)):
        return (torch.fmod(a, b),)
    return (torch.remainder(a, b),)


@register("BitShift")
def bit_shift(ctx: LoweringContext, node: Node, ins):
    x, y = ins
    _no_shell_uint("BitShift", x)
    if _str(node.attr("direction", "LEFT")).upper() == "LEFT":
        return (torch.bitwise_left_shift(x, y),)
    return (torch.bitwise_right_shift(x, y),)


register("Sum")(_variadic(torch.add))


@register("Mean")
def op_mean(ctx: LoweringContext, node: Node, ins):
    (total,) = _variadic(torch.add)(ctx, node, ins)
    return (total / len(ins),)


@register("CastLike")
def cast_like(ctx: LoweringContext, node: Node, ins):
    return (ins[0].to(ins[1].dtype),)


@register("LogSoftmax")
def log_softmax(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    axis = _softmax_axis(ctx, node)
    if ctx.opset < 13:
        ax = axis % x.dim()
        lead = math.prod(x.shape[:ax]) if ax else 1
        return (torch.log_softmax(x.reshape(lead, -1), dim=-1)
                .reshape(x.shape),)
    return (torch.log_softmax(x, dim=axis),)


@register("Hardmax")
def hardmax(ctx: LoweringContext, node: Node, ins):
    """One-hot of the first maximum along `axis`. Before opset 13 the
    input is flattened to 2-D at `axis` first, as the spec says (and as
    Softmax is); the JAX emitter takes the axis as it is at every opset."""
    x = ins[0]
    axis = _softmax_axis(ctx, node)
    shape = x.shape
    if ctx.opset < 13:
        ax = axis % x.dim()
        x = x.reshape(math.prod(shape[:ax]) if ax else 1, -1)
        axis = 1
    out = F.one_hot(torch.argmax(x, dim=axis), x.shape[axis])
    return (torch.movedim(out, -1, axis % x.dim()).to(x.dtype)
            .reshape(shape),)


# --------------------------------------------------------------------------
# Reductions (the Reduce* axes forms of `_reduce`)
# --------------------------------------------------------------------------
def _all_dims(x, dims):
    """An empty axes list reduces every axis, as the spec says (with
    noop_with_empty_axes 0; `_reduce` passed the input through
    otherwise)."""
    return dims if dims else tuple(range(x.dim()))


def _prod(x, dims, keepdim):
    for d in sorted(_all_dims(x, dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _sum(x, dims, keepdim):
    return torch.sum(x, dim=_all_dims(x, dims), keepdim=keepdim)


register("ReduceMean")(_reduce(
    lambda x, dims, keepdim: torch.mean(x, dim=_all_dims(x, dims),
                                        keepdim=keepdim)))
register("ReduceSum")(_reduce(_sum))
register("ReduceMin")(_reduce(
    lambda x, dims, keepdim: torch.amin(x, dim=_all_dims(x, dims),
                                        keepdim=keepdim)))
register("ReduceProd")(_reduce(_prod))
register("ReduceL1")(_reduce(
    lambda x, dims, keepdim: _sum(torch.abs(x), dims, keepdim)))
register("ReduceL2")(_reduce(
    lambda x, dims, keepdim: torch.sqrt(_sum(x * x, dims, keepdim))))
register("ReduceSumSquare")(_reduce(
    lambda x, dims, keepdim: _sum(x * x, dims, keepdim)))
register("ReduceLogSum")(_reduce(
    lambda x, dims, keepdim: torch.log(_sum(x, dims, keepdim))))
register("ReduceLogSumExp")(_reduce(
    lambda x, dims, keepdim: torch.logsumexp(x, dim=_all_dims(x, dims),
                                             keepdim=keepdim)))


def _arg_reduce(fn):
    """ArgMax / ArgMin: the first extreme index, or with select_last_index
    the last (the reversed axis's first, mapped back)."""
    def emit(ctx: LoweringContext, node: Node, ins):
        x = ins[0]
        axis = int(node.attr("axis", 0)) % x.dim()
        keepdims = bool(int(node.attr("keepdims", 1)))
        if int(node.attr("select_last_index", 0)):
            out = x.shape[axis] - 1 - fn(torch.flip(x, (axis,)), dim=axis,
                                         keepdim=keepdims)
        else:
            out = fn(x, dim=axis, keepdim=keepdims)
        return (out.to(INDEX_DTYPE),)
    return emit


register("ArgMax")(_arg_reduce(torch.argmax))
register("ArgMin")(_arg_reduce(torch.argmin))


@register("TopK")
def topk(ctx: LoweringContext, node: Node, ins):
    """The k largest (or smallest) along `axis`, in order; equal values in
    ascending index order, as lax.top_k gives them: a stable sort, where
    torch.topk on the card promises no order among ties."""
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:
        k = int(ctx.require_constant(node.inputs[1], "TopK k").reshape(-1)[0])
    else:
        k = int(node.attr("k"))
    axis = int(node.attr("axis", -1)) % x.dim()
    largest = bool(int(node.attr("largest", 1)))
    v, i = torch.sort(x, dim=axis, descending=largest, stable=True)
    return (v.narrow(axis, 0, k), i.narrow(axis, 0, k).to(INDEX_DTYPE))


# --------------------------------------------------------------------------
# Shape ops (Squeeze also where static propagation does not reach; Shape,
# Size, Constant, ConstantOfShape and Range run only as static values)
# --------------------------------------------------------------------------
@register("Squeeze")
def squeeze(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    axes = node.attr("axes")
    if axes is None and len(ins) > 1 and node.inputs[1]:
        axes = ctx.require_constant(node.inputs[1], "Squeeze axes").tolist()
    if axes is None:
        return (x.reshape([d for d in x.shape if d != 1]),)
    drop = {int(a) % x.dim() for a in axes}
    return (x.reshape([d for i, d in enumerate(x.shape) if i not in drop]),)


@register("Tile")
def tile(ctx: LoweringContext, node: Node, ins):
    reps = ctx.require_constant(node.inputs[1], "Tile repeats")
    return (ins[0].repeat(tuple(int(r) for r in reps)),)


@register("EyeLike")
def eye_like(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    k = int(node.attr("k", 0))
    to = node.attr("dtype")
    dt = (_torch_dtype(onnx_io.DTYPE_TO_NUMPY[int(to)]) if to is not None
          else x.dtype)
    n, m = x.shape
    rows = torch.arange(n, device=x.device)[:, None]
    cols = torch.arange(m, device=x.device)[None, :]
    return ((cols - rows == k).to(dt),)


@register("Trilu")
def trilu(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    k = 0
    if len(node.inputs) > 1 and node.inputs[1]:
        k = int(ctx.require_constant(node.inputs[1], "Trilu k").reshape(()))
    if int(node.attr("upper", 1)):
        return (torch.triu(x, k),)
    return (torch.tril(x, k),)


@register("OneHot")
def one_hot(ctx: LoweringContext, node: Node, ins):
    """off + (on - off) * onehot in float32, cast to the values' dtype, as
    the JAX emitter computes it. A negative index counts from the end of
    the depth, as the spec says (the JAX emitter's jax.nn.one_hot gives an
    all-off row for it); out of [-depth, depth) the row is all off."""
    indices, _, values = ins
    d = int(ctx.require_constant(node.inputs[1],
                                 "OneHot depth").reshape(-1)[0])
    rank = indices.dim() + 1
    axis = int(node.attr("axis", -1)) % rank
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + d, idx).unsqueeze(axis)
    shape = [1] * rank
    shape[axis] = d
    hot = (idx == torch.arange(d, device=idx.device).reshape(shape))
    off, on = values[0], values[1]
    return ((hot.to(torch.float32) * (on - off) + off).to(values.dtype),)


@register("SpaceToDepth")
def space_to_depth(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    bs = int(node.attr("blocksize"))
    N, C, H, W = x.shape
    y = x.reshape(N, C, H // bs, bs, W // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return (y.reshape(N, C * bs * bs, H // bs, W // bs),)


@register("DepthToSpace")
def depth_to_space(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    bs = int(node.attr("blocksize"))
    N, C, H, W = x.shape
    if _str(node.attr("mode", "DCR")) == "DCR":
        y = x.reshape(N, bs, bs, C // (bs * bs), H, W)
        y = y.permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(N, C // (bs * bs), bs, bs, H, W)
        y = y.permute(0, 1, 4, 2, 5, 3)
    return (y.reshape(N, C // (bs * bs), H * bs, W * bs),)


# --------------------------------------------------------------------------
# Index ops
# --------------------------------------------------------------------------
def _wrap(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """A negative index counted from the end (no clamp)."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx)


@register("GatherElements")
def gather_elements(ctx: LoweringContext, node: Node, ins):
    x, idx = ins
    axis = int(node.attr("axis", 0)) % x.dim()
    return (torch.gather(x, axis, _wrap_indices(idx, x.shape[axis])),)


def _flat_index(idx: torch.Tensor, dims: Sequence[int],
                fix=_wrap_indices) -> torch.Tensor:
    """Row-major flat index of the tuples in idx [..., k] into `dims` (k
    long), each component put in range by `fix(component, dim)`: wrapped
    and clamped, as the JAX emitters' gathers clip, by default."""
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=idx.device)
    for j, d in enumerate(dims):
        flat = flat * d + fix(idx[..., j], d)
    return flat


@register("GatherND")
def gather_nd(ctx: LoweringContext, node: Node, ins):
    data, indices = ins
    b = int(node.attr("batch_dims", 0))
    k = indices.shape[-1]
    batch = tuple(data.shape[:b])
    nb = math.prod(batch)
    tail = tuple(data.shape[b + k:])
    d = data.reshape((nb, math.prod(data.shape[b:b + k])) + tail)
    flat = _flat_index(indices.reshape(nb, -1, k), data.shape[b:b + k])
    out = d[torch.arange(nb, device=d.device)[:, None], flat]
    return (out.reshape(tuple(indices.shape[:-1]) + tail),)


_SCATTER_REDUCE = {"add": "sum", "mul": "prod", "max": "amax",
                   "min": "amin"}


@register("ScatterND")
def scatter_nd(ctx: LoweringContext, node: Node, ins):
    """data with updates put (or added, multiplied, maxed, minned) at the
    index tuples. With reduction "none", duplicate indices leave which
    update lands undefined, as the spec does."""
    data, indices, updates = ins
    red = _str(node.attr("reduction", "none"))
    if red != "none" and red not in _SCATTER_REDUCE:
        raise UnsupportedOpError(f"ScatterND reduction {red!r}")
    k = indices.shape[-1]
    tail = tuple(data.shape[k:])
    out = data.reshape((math.prod(data.shape[:k]),) + tail).clone()
    flat = _flat_index(indices, data.shape[:k], _wrap).reshape(-1)
    upd = updates.reshape((-1,) + tail).to(data.dtype)
    if red == "none":
        out[flat] = upd
    else:
        idx = flat.reshape((-1,) + (1,) * len(tail)).expand(upd.shape)
        out.scatter_reduce_(0, idx, upd, _SCATTER_REDUCE[red],
                            include_self=True)
    return (out.reshape(data.shape),)


@register("ScatterElements")
def scatter_elements(ctx: LoweringContext, node: Node, ins):
    data, indices, updates = ins
    axis = int(node.attr("axis", 0)) % data.dim()
    red = _str(node.attr("reduction", "none"))
    if red != "none" and red not in _SCATTER_REDUCE:
        raise UnsupportedOpError(f"ScatterElements reduction {red!r}")
    idx = _wrap(indices, data.shape[axis])
    upd = updates.to(data.dtype)
    if red == "none":
        return (torch.scatter(data, axis, idx, upd),)
    return (torch.scatter_reduce(data, axis, idx, upd, _SCATTER_REDUCE[red],
                                 include_self=True),)


@register("CumSum")
def cumsum(ctx: LoweringContext, node: Node, ins):
    """The exclusive form is the inclusive sum less x, as the JAX emitter
    computes it."""
    x = ins[0]
    axis = int(ctx.require_constant(node.inputs[1],
                                    "CumSum axis").reshape(())) % x.dim()
    exclusive = int(node.attr("exclusive", 0))
    reverse = int(node.attr("reverse", 0))
    if reverse:
        x = torch.flip(x, (axis,))
    y = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if exclusive:
        y = y - x
    if reverse:
        y = torch.flip(y, (axis,))
    return (y,)


@register("ReverseSequence")
def reverse_sequence(ctx: LoweringContext, node: Node, ins):
    """Per-batch reversal of each sequence's valid prefix (the RNN
    emitters' _flip_valid, on the attribute axes)."""
    from .rnn import _flip_valid

    x, seq_lens = ins
    batch_axis = int(node.attr("batch_axis", 1))
    time_axis = int(node.attr("time_axis", 0))
    xm = torch.movedim(x, (time_axis, batch_axis), (0, 1))
    return (torch.movedim(_flip_valid(xm, seq_lens), (0, 1),
                          (time_axis, batch_axis)),)


# --------------------------------------------------------------------------
# Pad
# --------------------------------------------------------------------------
def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each position of an axis of length n padded by
    (lo, hi) in mode edge, wrap or reflect (numpy's reflect, which a
    pad wider than the axis repeats)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@register("Pad")
def pad(ctx: LoweringContext, node: Node, ins):
    """constant, reflect, edge and wrap; negative pads crop first (past
    the axis's length, to an empty axis). From opset 18 an `axes` input
    names the axes the pads are for; the JAX emitter reads pads as if
    they covered every axis and ignores `axes`."""
    x = ins[0]
    mode = _str(node.attr("mode", "constant"))
    if mode not in ("constant", "reflect", "edge", "wrap"):
        raise UnsupportedOpError(f"Pad mode {mode!r}")
    cval = None
    if ctx.opset >= 11 or len(node.inputs) > 1:
        pads = [int(p) for p in
                ctx.require_constant(node.inputs[1], "Pad pads").tolist()]
        if len(ins) > 2 and ins[2] is not None:
            c = ctx.constant(node.inputs[2])
            cval = float(np.asarray(c).reshape(-1)[0]) if c is not None \
                else ins[2]
    else:
        pads = [int(p) for p in node.attr("pads")]
        cval = float(node.attr("value", 0.0))
    n = x.dim()
    if len(ins) > 3 and ins[3] is not None:
        axes = [int(a) % n for a in
                ctx.require_constant(node.inputs[3], "Pad axes").tolist()]
    else:
        axes = list(range(n))
    width = [(0, 0)] * n
    for j, ax in enumerate(axes):
        width[ax] = (pads[j], pads[j + len(axes)])
    if any(lo < 0 or hi < 0 for lo, hi in width):
        sl = []
        for i, (lo, hi) in enumerate(width):
            start = min(max(0, -lo), x.shape[i])
            sl.append(slice(start, max(start, x.shape[i] - max(0, -hi))))
        x = x[tuple(sl)]
        width = [(max(0, lo), max(0, hi)) for lo, hi in width]
    if mode == "constant":
        if cval is None or isinstance(cval, float):
            return (_pad(x, width, 0.0 if cval is None else cval),)
        # a fill known only at run time: pad with zeros, then put the
        # fill where the mask of the input's own positions is off
        inside = _pad(torch.ones_like(x, dtype=torch.bool), width, False)
        return (torch.where(inside, _pad(x, width, 0.0),
                            cval.reshape(()).to(x.dtype)),)
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(
                x, ax, _pad_index(x.shape[ax], lo, hi, mode, x.device))
    return (x,)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
@register("InstanceNormalization")
def instance_norm(ctx: LoweringContext, node: Node, ins):
    x, scale, bias = ins
    eps = float(node.attr("epsilon", 1e-5))
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.square(x - mean).mean(dim=dims, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape),)


@register("LRN")
def lrn(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    size = int(node.attr("size"))
    alpha = float(node.attr("alpha", 1e-4))
    beta = float(node.attr("beta", 0.75))
    bias = float(node.attr("bias", 1.0))
    lo = (size - 1) // 2
    sq = _pad(torch.square(x).movedim(1, -1), [(lo, size - 1 - lo)], 0.0)
    sums = sq.unfold(-1, size, 1).sum(-1).movedim(-1, 1)
    return (x / torch.pow(bias + (alpha / size) * sums, beta),)


@register("MeanVarianceNormalization")
def mean_variance_normalization(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    dims = tuple(int(a) for a in node.attr("axes", [0, 2, 3]))
    mean = x.mean(dim=dims, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=dims, keepdim=True))
    return ((x - mean) / (std + 1e-9),)


@register("GroupNormalization")
def group_normalization(ctx: LoweringContext, node: Node, ins):
    """Statistics per (sample, group); scale and bias per channel (opset
    21), or per group where they hold num_groups values (opset 18)."""
    x, scale, bias = ins[0], ins[1], ins[2]
    eps = float(node.attr("epsilon", 1e-5))
    g = int(node.attr("num_groups"))
    N, C = x.shape[0], x.shape[1]
    xg = x.reshape((N, g, C // g) + tuple(x.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=dims, keepdim=True)
    var = torch.square(xg - mean).mean(dim=dims, keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    if scale.numel() == g:
        scale = repeat_each(scale, C // g, 0)
        bias = repeat_each(bias, C // g, 0)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return (xn * scale.reshape(shape) + bias.reshape(shape),)


# --------------------------------------------------------------------------
# Resize / Upsample
# --------------------------------------------------------------------------
def _resize_src(i, di: int, do: int, scale: float, coord: str):
    """Output index -> source coordinate per coordinate_transformation_mode
    (the spec's formulas, in terms of the scale; numpy or torch vectors)."""
    if coord == "align_corners":
        return i * ((di - 1) / max(do - 1, 1))
    if coord == "asymmetric":
        return i / scale
    if coord == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if do > 1 else i * 0.0
    if coord == "half_pixel":
        return (i + 0.5) / scale - 0.5
    if coord == "half_pixel_symmetric":
        adjustment = do / (scale * di)
        offset = di / 2 * (1 - adjustment)
        return offset + (i + 0.5) / scale - 0.5
    raise UnsupportedOpError(
        f"Resize: coordinate_transformation_mode {coord!r} not supported")


_NEAREST = {"floor": np.floor, "ceil": np.ceil,
            "round_prefer_ceil": lambda s: np.floor(s + 0.5),
            "round_prefer_floor": lambda s: np.ceil(s - 0.5)}


def _cubic_weights(t: torch.Tensor, a: float) -> torch.Tensor:
    """Keys' cubic convolution weights of the taps at offsets -1, 0, 1, 2
    from floor(src), t = src - floor(src): [..., 4]."""
    d = torch.stack([t + 1, t, 1 - t, 2 - t], dim=-1)
    near = ((a + 2) * d - (a + 3)) * d * d + 1
    far = ((a * d - 5 * a) * d + 8 * a) * d - 4 * a
    return torch.where(d <= 1, near, far)


def _resize_cubic_axis(x, ax: int, do: int, scale: float, coord: str,
                       a: float, exclude_outside: bool):
    """The spec's cubic along `ax`: four taps about each source coordinate,
    indices past the edge clamped to it, or with exclude_outside their
    weights dropped and the rest renormalized."""
    di = x.shape[ax]
    src = _resize_src(torch.arange(do, dtype=torch.float64,
                                   device=x.device), di, do, scale, coord)
    base = torch.floor(src)
    w = _cubic_weights(src - base, a)                         # [do, 4]
    taps = base.to(torch.int64)[:, None] + torch.arange(
        -1, 3, device=x.device)[None]                         # [do, 4]
    if exclude_outside:
        w = torch.where((taps >= 0) & (taps < di), w, 0.0)
        w = w / w.sum(-1, keepdim=True)
    taps = taps.clamp(0, di - 1)
    xm = torch.movedim(x, ax, -1)
    g = xm[..., taps.reshape(-1)].reshape(xm.shape[:-1] + (do, 4))
    return torch.movedim((g * w.to(x.dtype)).sum(-1), -1, ax)


@register("Resize", "Upsample")
def resize(ctx: LoweringContext, node: Node, ins):
    """Resize (opset 10+) / Upsample (opset 7-9), as the JAX emitter:
    output sizes from static scales or sizes; the coordinate transforms
    from the spec, in terms of the scale; nearest as a gather of the
    source indices the nearest_mode rounding gives (computed on the host
    in float64, as the JAX emitter does); linear as a per-axis gather and
    lerp in float32. The opset-10 Resize takes its scales from input 1,
    as the spec says. Cubic follows the spec (cubic_coeff_a, default
    -0.75, and exclude_outside) under any coordinate transform; the JAX
    emitter runs jax.image.resize, Keys' a = -0.5 with its out-of-range
    taps dropped, and half_pixel alone."""
    x = ins[0]
    mode = _str(node.attr("mode", "nearest"))
    coord = _str(node.attr("coordinate_transformation_mode", "half_pixel"))
    out_shape = None
    if node.op_type == "Upsample" or ctx.opset < 11:
        # Upsample, and the opset-10 Resize, whose scales are input 1 (the
        # JAX emitter looks for them at input 2, where opset 11 put them)
        scales = (node.attr("scales")
                  or ctx.require_constant(node.inputs[1], "Resize scales"))
        scales = np.asarray(scales, dtype=np.float64).reshape(-1)
    else:
        scales = None
        if len(node.inputs) > 2 and node.inputs[2]:
            sc = ctx.constant(node.inputs[2])
            if sc is not None and sc.size:
                scales = np.asarray(sc, np.float64).reshape(-1)
        if scales is None and len(node.inputs) > 3 and node.inputs[3]:
            sizes = ctx.require_constant(node.inputs[3], "Resize sizes")
            out_shape = tuple(int(v) for v in sizes.reshape(-1))
    if out_shape is None:
        if scales is None:
            raise UnsupportedOpError("Resize needs static scales or sizes")
        out_shape = tuple(int(np.floor(d * sc))
                          for d, sc in zip(x.shape, scales))
    axis_scales = (tuple(float(v) for v in scales) if scales is not None
                   else tuple(do / di for do, di in zip(out_shape, x.shape)))
    legacy = node.op_type == "Upsample" or ctx.opset < 11
    if legacy:
        coord = "asymmetric"
    if mode == "nearest":
        nm = "floor" if legacy else _str(
            node.attr("nearest_mode", "round_prefer_floor"))
        if nm not in _NEAREST:
            raise UnsupportedOpError(f"Resize nearest_mode {nm!r}")
        out = x
        for ax, (do, di) in enumerate(zip(out_shape, x.shape)):
            if do == di:
                continue

            def table(ax=ax, do=do, di=di):
                src = _resize_src(np.arange(do, dtype=np.float64), di, do,
                                  axis_scales[ax], coord)
                return np.clip(_NEAREST[nm](src), 0, di - 1).astype(np.int64)

            idx = ctx.device_constant(
                f"{node.outputs[0]}:nearest{ax}:{tuple(x.shape)}", table)
            out = torch.index_select(out, ax, idx)
        return (out,)
    if mode == "linear":
        out = x.to(torch.float32)
        for ax, (do, di) in enumerate(zip(out_shape, x.shape)):
            if do == di:
                continue
            src = _resize_src(torch.arange(do, dtype=torch.float32,
                                           device=x.device), di, do,
                              axis_scales[ax], coord)
            src = torch.clamp(src, 0.0, di - 1)
            lo = torch.floor(src).to(torch.int64)
            hi = torch.clamp_max(lo + 1, di - 1)
            shape = [1] * out.dim()
            shape[ax] = do
            w = (src - lo).reshape(shape)
            out = (torch.index_select(out, ax, lo) * (1 - w)
                   + torch.index_select(out, ax, hi) * w)
        return (out.to(x.dtype),)
    if mode == "cubic":
        a = float(node.attr("cubic_coeff_a", -0.75))
        excl = bool(int(node.attr("exclude_outside", 0)))
        out = x.to(torch.float32)
        for ax, (do, di) in enumerate(zip(out_shape, x.shape)):
            if do != di:
                out = _resize_cubic_axis(out, ax, do, axis_scales[ax],
                                         coord, a, excl)
        return (out.to(x.dtype),)
    raise UnsupportedOpError(f"Resize mode {mode!r}")


# --------------------------------------------------------------------------
# GridSample, Einsum
# --------------------------------------------------------------------------
@register("GridSample")
def grid_sample(ctx: LoweringContext, node: Node, ins):
    """2-D GridSample as the JAX emitter gathers it: bilinear or nearest
    (round half to even), zeros or border padding, align_corners. x
    [N, C, H, W], grid [N, Ho, Wo, 2] in [-1, 1] -> [N, C, Ho, Wo]."""
    x, grid = ins
    mode = _str(node.attr("mode", "linear"))
    pad = _str(node.attr("padding_mode", "zeros"))
    align = int(node.attr("align_corners", 0))
    if x.dim() != 4:
        raise UnsupportedOpError("GridSample: only 2-D (NCHW) supported")
    if mode in ("cubic", "bicubic") or pad == "reflection":
        raise UnsupportedOpError(
            f"GridSample: mode={mode}/padding={pad} not supported")
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(g, size):
        if align:
            return (g + 1) * (size - 1) / 2
        return ((g + 1) * size - 1) / 2

    ix, iy = unnorm(gx, W), unnorm(gy, H)
    n_idx = torch.arange(N, device=x.device).reshape(N, 1, 1)

    def fetch(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = x[n_idx, :, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        v = torch.movedim(v, -1, 1)                    # [N, C, Ho, Wo]
        if pad == "zeros":
            v = torch.where(inb[:, None], v, torch.zeros((), dtype=v.dtype,
                                                         device=v.device))
        return v

    if mode == "nearest":
        return (fetch(torch.round(iy).to(torch.int64),
                      torch.round(ix).to(torch.int64)),)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - x0)[:, None], (iy - y0)[:, None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    top = fetch(y0i, x0i) * (1 - wx) + fetch(y0i, x0i + 1) * wx
    bot = fetch(y0i + 1, x0i) * (1 - wx) + fetch(y0i + 1, x0i + 1) * wx
    return ((top * (1 - wy) + bot * wy).to(x.dtype),)


@register("Einsum")
def einsum(ctx: LoweringContext, node: Node, ins):
    with matmul_fp32_exact():
        return (torch.einsum(_str(node.attr("equation")), *ins),)
