"""Long-tail ONNX operators -> PyTorch: trig, bitwise, Det, the Lp
family, CenterCropPad, Col2Im, the windows, DFT / STFT / MelWeightMatrix,
the random ops, Scatter and AffineGrid.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/extra.py
(its ReduceLogSum is standard.py's here, as the JAX registry resolves it).
Values an emitter makes on the host (a mel filter bank, AffineGrid's base
grid, random draws) reach the device once per input signature through
`LoweringContext.device_constant`, so that a captured run copies nothing
from the host.

Random ops keep the JAX package's contract, not its values: the `seed`
attribute (or, where there is none, a salt from the node's first output
name) seeds the stream, so the same node gives the same tensor on every
run. The draws come from a seeded CPU `torch.Generator` when the node is
lowered, so an eager call, the first call and a replay agree; Bernoulli
and Multinomial compare their input with those fixed draws on the device
(a uniform draw below p; the Gumbel-max of the log-probabilities).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from ..onnx_io import DTYPE_TO_NUMPY
from .registry import LoweringContext, UnsupportedOpError, register
from .standard import (_CONV, _fp32_exact, _no_shell_uint, _pad, _pool,
                       _torch_dtype, _unary, matmul_fp32_exact,
                       scatter_elements)

# --- trig tail -------------------------------------------------------------
register("Tan")(_unary(torch.tan))
register("Asin")(_unary(torch.asin))
register("Acos")(_unary(torch.acos))
register("Atan")(_unary(torch.atan))
register("Sinh")(_unary(torch.sinh))
register("Cosh")(_unary(torch.cosh))
register("Asinh")(_unary(torch.asinh))
register("Acosh")(_unary(torch.acosh))
register("Atanh")(_unary(torch.atanh))


# --- bitwise tail ----------------------------------------------------------
@register("BitwiseNot")
def bitwise_not(ctx, node, ins):
    _no_shell_uint("BitwiseNot", ins[0])
    return (torch.bitwise_not(ins[0]),)


@register("BitwiseXor")
def bitwise_xor(ctx, node, ins):
    return (torch.bitwise_xor(ins[0], ins[1]),)


@register("Det")
def det(ctx, node, ins):
    """The determinant of each [n, n] matrix of x [..., n, n]: Gaussian
    elimination with partial pivoting (as LAPACK's getrf, behind the JAX
    emitter's jnp.linalg.det), in tensor ops only, so that no solver
    library reads the host inside a captured run; a zero pivot gives 0."""
    a = ins[0]
    n = a.shape[-1]
    lead = tuple(a.shape[:-2])
    a = a.reshape(-1, n, n).clone()
    rows = torch.arange(a.shape[0], device=a.device)
    out = torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    for k in range(n):
        p = torch.argmax(a[:, k:, k].abs(), dim=1) + k
        top, piv_row = a[:, k].clone(), a[rows, p].clone()
        a[:, k] = piv_row
        a[rows, p] = top
        out = torch.where(p != k, -out, out)
        piv = a[:, k, k]
        out = out * piv
        if k + 1 < n:
            f = a[:, k + 1:, k] / torch.where(piv == 0, 1.0, piv)[:, None]
            a[:, k + 1:, k:] -= f[..., None] * a[:, None, k, k:]
    return (out.reshape(lead),)


# --- Lp family -------------------------------------------------------------
@register("LpNormalization")
def lp_normalization(ctx, node, ins):
    x = ins[0]
    axis = int(node.attr("axis", -1))
    if int(node.attr("p", 2)) == 1:
        norm = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    else:
        norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return (x / norm,)


@register("GlobalLpPool")
def global_lp_pool(ctx, node, ins):
    x = ins[0]
    p = int(node.attr("p", 2))
    dims = tuple(range(2, x.dim()))
    if p == 1:
        return (torch.sum(torch.abs(x), dim=dims, keepdim=True),)
    if p == 2:
        return (torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True)),)
    return (torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True)
            ** (1.0 / p),)


@register("LpPool")
def lp_pool(ctx, node, ins):
    """(sum of |x|^p over each window)^(1/p), the windows as the pools'
    (`standard._pool`: pads, ceil_mode, dilations), summed by a
    per-channel convolution with a kernel of ones."""
    x = ins[0]
    p = int(node.attr("p", 2))
    spatial = x.dim() - 2
    if spatial not in _CONV:
        raise UnsupportedOpError(f"LpPool: {spatial}-D spatial")
    padding, kernel, strides, dilations = _pool(node, x)
    xp = _pad(torch.abs(x) ** p, padding, 0.0)
    N, C = x.shape[:2]
    ones = torch.ones((1, 1) + tuple(kernel), dtype=x.dtype, device=x.device)
    with _fp32_exact():
        s = _CONV[spatial](xp.reshape((N * C, 1) + tuple(xp.shape[2:])),
                           ones, stride=strides, dilation=dilations)
    return (s.reshape((N, C) + tuple(s.shape[2:])) ** (1.0 / p),)


# --- geometry --------------------------------------------------------------
@register("CenterCropPad")
def center_crop_pad(ctx, node, ins):
    x = ins[0]
    target = [int(v) for v in np.asarray(ctx.require_constant(
        node.inputs[1], "CenterCropPad shape")).reshape(-1)]
    axes = node.attr("axes")
    if axes is None:
        axes = list(range(len(target)))
    out = x
    for ax, t in zip((int(a) % x.dim() for a in axes), target):
        d = out.shape[ax]
        if d >= t:  # center crop
            out = out.narrow(ax, (d - t) // 2, t)
        else:       # center pad with zeros
            lo = (t - d) // 2
            width = [(0, 0)] * (out.dim() - ax)
            width[0] = (lo, t - d - lo)
            out = _pad(out, width, 0.0)
    return (out,)


@register("Col2Im")
def col2im(ctx, node, ins):
    """Column blocks back into an image, overlaps summed: an add into a
    strided slice of the padded image for each offset within a block, as
    the JAX emitter unrolls it."""
    x = ins[0]                                # [N, C*prod(block), L]
    image_shape = [int(v) for v in np.asarray(ctx.require_constant(
        node.inputs[1], "Col2Im image_shape")).reshape(-1)]
    block_shape = [int(v) for v in np.asarray(ctx.require_constant(
        node.inputs[2], "Col2Im block_shape")).reshape(-1)]
    nd = len(image_shape)
    dil = [int(v) for v in (node.attr("dilations") or [1] * nd)]
    pads = [int(v) for v in (node.attr("pads") or [0] * 2 * nd)]
    strides = [int(v) for v in (node.attr("strides") or [1] * nd)]
    N = x.shape[0]
    C = x.shape[1] // math.prod(block_shape)
    padded = [image_shape[d] + pads[d] + pads[nd + d] for d in range(nd)]
    n_blocks = [(padded[d] - dil[d] * (block_shape[d] - 1) - 1)
                // strides[d] + 1 for d in range(nd)]
    if math.prod(n_blocks) != x.shape[2]:
        raise UnsupportedOpError(
            f"Col2Im: {x.shape[2]} blocks, the shapes give "
            f"{math.prod(n_blocks)}")
    x = x.reshape((N, C) + tuple(block_shape) + tuple(n_blocks))
    out = torch.zeros((N, C) + tuple(padded), dtype=x.dtype,
                      device=x.device)
    for off in np.ndindex(*block_shape):
        idx = (slice(None), slice(None)) + tuple(
            slice(off[d] * dil[d],
                  off[d] * dil[d] + strides[d] * n_blocks[d], strides[d])
            for d in range(nd))
        out[idx] += x[(slice(None), slice(None)) + off]
    crop = (slice(None), slice(None)) + tuple(
        slice(pads[d], pads[d] + image_shape[d]) for d in range(nd))
    return (out[crop],)


# --- spectral --------------------------------------------------------------
def _window(name: str, ctx, node):
    size = int(np.asarray(ctx.require_constant(
        node.inputs[0], f"{node.op_type} size")).reshape(()))
    periodic = bool(int(node.attr("periodic", 1)))
    dt = _torch_dtype(DTYPE_TO_NUMPY[int(node.attr("output_datatype", 1))])
    if size == 1 and not periodic:
        # the symmetric one-sample window is [1.0] (numpy's convention);
        # the cosine formula would divide by size - 1 = 0
        return (torch.ones((1,), dtype=dt, device=ctx.device),)
    n = size if periodic else size - 1
    i = torch.arange(size, dtype=torch.float32, device=ctx.device)
    if name == "hann":
        w = 0.5 - 0.5 * torch.cos(2 * math.pi * i / n)
    elif name == "hamming":
        # the spec's coefficients (25/46)
        w = 25.0 / 46.0 - (21.0 / 46.0) * torch.cos(2 * math.pi * i / n)
    else:  # blackman
        w = (0.42 - 0.5 * torch.cos(2 * math.pi * i / n)
             + 0.08 * torch.cos(4 * math.pi * i / n))
    return (w.to(dt),)


@register("HannWindow")
def hann_window(ctx, node, ins):
    return _window("hann", ctx, node)


@register("HammingWindow")
def hamming_window(ctx, node, ins):
    return _window("hamming", ctx, node)


@register("BlackmanWindow")
def blackman_window(ctx, node, ins):
    return _window("blackman", ctx, node)


def _as_pairs(y: torch.Tensor) -> torch.Tensor:
    """A complex tensor as float32 [..., 2] (real, imaginary)."""
    return torch.view_as_real(y.to(torch.complex64)).contiguous()


@register("DFT")
def dft(ctx, node, ins):
    """DFT over one axis of a real [..., 1] or complex [..., 2] signal;
    output [..., 2]. The axis (attribute, or input from opset 20) counts
    in the input's rank, the trailing pair included, so -2 is the last
    signal axis, as the spec says; the JAX emitter takes a negative axis
    modulo the rank without the pair."""
    x = ins[0]
    inverse = bool(int(node.attr("inverse", 0)))
    onesided = bool(int(node.attr("onesided", 0)))
    if len(node.inputs) > 2 and node.inputs[2]:
        axis = int(np.asarray(ctx.require_constant(
            node.inputs[2], "DFT axis")).reshape(()))
    else:
        axis = int(node.attr("axis", 1))
    n = None
    if len(node.inputs) > 1 and node.inputs[1]:
        n = int(np.asarray(ctx.require_constant(
            node.inputs[1], "DFT dft_length")).reshape(()))
    if x.shape[-1] == 2:
        xc = torch.complex(x[..., 0].float(), x[..., 1].float())
    else:
        xc = x[..., 0].to(torch.complex64)
    if axis < 0:
        axis += x.dim()
    fn = torch.fft.ifft if inverse else torch.fft.fft
    y = fn(xc, n=n, dim=axis)
    if onesided:
        y = y.narrow(axis, 0, y.shape[axis] // 2 + 1)
    return (_as_pairs(y),)


@register("STFT")
def stft(ctx, node, ins):
    """Frames of the signal (a static hop and frame length), times the
    window where one is given, each transformed: [B, frames, bins, 2]."""
    x = ins[0]  # [B, L] or [B, L, 1]
    hop = int(np.asarray(ctx.require_constant(
        node.inputs[1], "STFT frame_step")).reshape(()))
    window = ins[2] if len(node.inputs) > 2 and node.inputs[2] else None
    if len(node.inputs) > 3 and node.inputs[3]:
        frame_len = int(np.asarray(ctx.require_constant(
            node.inputs[3], "STFT frame_length")).reshape(()))
    elif window is not None:
        frame_len = window.shape[-1]
    else:
        raise UnsupportedOpError("STFT needs frame_length or window")
    if x.dim() == 3:
        if x.shape[-1] != 1:
            raise UnsupportedOpError("STFT: complex input not supported")
        x = x[..., 0]
    frames = x.unfold(-1, frame_len, hop)          # [B, F, frame_len]
    if window is not None:
        frames = frames * window
    y = torch.fft.fft(frames, dim=-1)
    if bool(int(node.attr("onesided", 1))):
        y = y[..., : frame_len // 2 + 1]
    return (_as_pairs(y),)


def _mel_weights(n_mel: int, dft_len: int, sr: int, f_lo: float,
                f_hi: float) -> np.ndarray:
    """The JAX emitter's triangular mel filter bank [dft_len // 2 + 1,
    n_mel] (HTK mel scale; bins from floor((dft_len + 1) * hz / sr))."""
    n_bins = dft_len // 2 + 1

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(f_lo), hz_to_mel(f_hi), n_mel + 2)
    bins = np.floor((dft_len + 1) * mel_to_hz(mel_pts) / sr).astype(np.int64)
    out = np.zeros((n_bins, n_mel), np.float32)
    for m in range(n_mel):
        lo, c, hi = (int(v) for v in bins[m:m + 3])
        for k in range(lo, c):
            if 0 <= k < n_bins:
                out[k, m] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if 0 <= k < n_bins:
                out[k, m] = (hi - k) / (hi - c)
    return out


@register("MelWeightMatrix")
def mel_weight_matrix(ctx, node, ins):
    n_mel, dft_len, sr, f_lo, f_hi = [
        float(np.asarray(ctx.require_constant(
            i, "MelWeightMatrix input")).reshape(()))
        for i in node.inputs[:5]]
    dt = DTYPE_TO_NUMPY[int(node.attr("output_datatype", 1))]
    return (ctx.device_constant(node.outputs[0], lambda: _mel_weights(
        int(n_mel), int(dft_len), int(sr), f_lo, f_hi).astype(dt)),)


# --- random ----------------------------------------------------------------
def _seed(node) -> int:
    """The node's stream: its `seed` attribute's float32 bits, as the JAX
    emitter keys it, else a salt from its first output's name, so that
    distinct seedless nodes of one graph draw distinct streams."""
    seed = node.attr("seed")
    if seed is not None:
        return int(np.float32(seed).view(np.int32))
    return zlib.crc32(node.outputs[0].encode()) & 0x7FFFFFFF


def _draw(ctx, node, shape, kind: str):
    """`kind` ("normal", "uniform" or "gumbel") draws of `shape` from the
    node's seeded stream, made on the host and held on the device."""
    def make():
        g = torch.Generator().manual_seed(_seed(node))
        if kind == "normal":
            return torch.randn(shape, generator=g).numpy()
        u = torch.rand(shape, generator=g, dtype=torch.float64)
        if kind == "gumbel":
            u = -torch.log(-torch.log(u.clamp_min(1e-300)))
        return u.to(torch.float32).numpy()

    return ctx.device_constant(f"{node.outputs[0]}:{kind}:{tuple(shape)}",
                               make)


def _rand_shape_dtype(node, like=None):
    if like is not None:
        dt = node.attr("dtype")
        return tuple(like.shape), (_torch_dtype(DTYPE_TO_NUMPY[int(dt)])
                                   if dt is not None else like.dtype)
    return (tuple(int(v) for v in node.attr("shape")),
            _torch_dtype(DTYPE_TO_NUMPY[int(node.attr("dtype", 1))]))


@register("RandomNormal", "RandomNormalLike")
def random_normal(ctx, node, ins):
    shape, dt = _rand_shape_dtype(node, ins[0] if ins else None)
    mean = float(node.attr("mean", 0.0))
    scale = float(node.attr("scale", 1.0))
    return ((_draw(ctx, node, shape, "normal") * scale + mean).to(dt),)


@register("RandomUniform", "RandomUniformLike")
def random_uniform(ctx, node, ins):
    shape, dt = _rand_shape_dtype(node, ins[0] if ins else None)
    lo = float(node.attr("low", 0.0))
    hi = float(node.attr("high", 1.0))
    return ((_draw(ctx, node, shape, "uniform") * (hi - lo) + lo).to(dt),)


@register("Bernoulli")
def bernoulli(ctx, node, ins):
    x = ins[0]
    dt = node.attr("dtype")
    dt = _torch_dtype(DTYPE_TO_NUMPY[int(dt)]) if dt is not None else x.dtype
    u = _draw(ctx, node, tuple(x.shape), "uniform")
    return ((u < x.to(torch.float32)).to(dt),)


@register("Multinomial")
def multinomial(ctx, node, ins):
    """sample_size draws per row of unnormalized log-probabilities x
    [B, C]: each the argmax of x plus fixed Gumbel noise."""
    x = ins[0]
    n = int(node.attr("sample_size", 1))
    dt = _torch_dtype(DTYPE_TO_NUMPY[int(node.attr("dtype", 6))])
    g = _draw(ctx, node, (n,) + tuple(x.shape), "gumbel")
    return (torch.argmax(x.to(torch.float32) + g, dim=-1).T.to(dt),)


# --- deprecated alias ------------------------------------------------------
@register("Scatter")
def scatter(ctx, node, ins):
    """The opset-9/10 alias of ScatterElements."""
    return scatter_elements(ctx, node, ins)


@register("AffineGrid")
def affine_grid(ctx, node, ins):
    """The sampling grid of a batch of 2-D / 3-D affine transforms (opset
    20): theta [N, 2, 3] -> [N, H, W, 2]; theta [N, 3, 4] -> [N, D, H, W,
    3]. The base grid is made on the host from the static `size`, as the
    JAX emitter makes it; one small product per batch row is left."""
    theta = ins[0]
    dims = [int(v) for v in np.asarray(ctx.require_constant(
        node.inputs[1], "AffineGrid size")).reshape(-1)]
    if len(dims) not in (4, 5):
        raise UnsupportedOpError(
            f"AffineGrid: size must have 4 or 5 elements, got {len(dims)}")
    align = int(node.attr("align_corners", 0))
    N, spatial = dims[0], dims[2:]
    nd = len(spatial)

    def base():
        def axis(s):
            if align:
                return np.linspace(-1.0, 1.0, s) if s > 1 else np.zeros(1)
            return (2.0 * np.arange(s) + 1.0) / s - 1.0

        coords = np.meshgrid(*[axis(s) for s in reversed(spatial)],
                             indexing="ij")
        coords = [c.transpose(*reversed(range(nd))) for c in coords]
        b = np.stack(coords + [np.ones(tuple(spatial))], axis=-1)
        return b.reshape(-1, nd + 1).astype(np.float32)

    b = ctx.device_constant(f"{node.outputs[0]}:{dims}:{align}", base)
    with matmul_fp32_exact():
        g = torch.einsum("pk,nok->npo", b.to(theta.dtype), theta)
    return (g.reshape((N, *spatial, nd)),)
