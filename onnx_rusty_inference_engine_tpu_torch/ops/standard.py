"""fp32/generic ONNX op emitters -> PyTorch.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/standard.py,
holding the emitters SqueezeNet 1.0 needs in fp32 and in its INT8 form
(Conv, Relu, MaxPool, Concat, Dropout, GlobalAveragePool, Softmax), those
the GPT-2 graphs need (the binary elementwise family, MatMul, Gelu, Where,
Cast, Reshape, Transpose, Split, Gather, Identity, LayerNormalization),
those BERT adds (Tanh, Slice) and those the dynamic W8A8 rewrite adds (Abs,
Max, Min, ReduceMax). Each keeps the JAX emitter's semantics: NCHW layout,
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
    """x * rsqrt(mean(x^2) + eps) * scale, the mean of squares in fp32."""
    x, scale = ins[0], ins[1]
    axis = int(node.attr("axis", -1))
    eps = float(node.attr("epsilon", 1e-5))
    dims = tuple(range(axis % x.dim(), x.dim()))
    ms = torch.square(x.to(torch.float32)).mean(dim=dims, keepdim=True)
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
