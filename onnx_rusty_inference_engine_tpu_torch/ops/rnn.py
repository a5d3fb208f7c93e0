"""Recurrent op emitters: LSTM / GRU / RNN. The port's counterpart of
onnx_rusty_inference_engine_tpu/ops/rnn.py.

The input projection of all T steps is one matmul before the time loop
([T*B, I] x [I, G*H]); the loop over T is Python, so a captured CUDA graph
holds its steps unrolled: per step one [B, H] x [H, G*H] matmul and the
gate math. A bidirectional node runs its two directions one after the
other over the same weights.

ONNX semantics, as in JAX: gate orders iofc (LSTM) / zrh (GRU), layout 0
([T,B,...]) and 1 ([B,T,...]), forward/reverse/bidirectional, optional
bias / initial states / peepholes (LSTM) / sequence_lens (per-batch
masking: the state freezes and Y is zero past each length; a reverse
direction reads each sequence's valid prefix back to front),
linear_before_reset (GRU), clip. Activation lists other than the defaults
(sigmoid/tanh, what real exports use) raise UnsupportedOpError.
"""

from __future__ import annotations

import torch

from ..graph import Node
from .registry import LoweringContext, UnsupportedOpError, register

_DEFAULT_ACTS = {
    "LSTM": [b"Sigmoid", b"Tanh", b"Tanh"],
    "GRU": [b"Sigmoid", b"Tanh"],
    "RNN": [b"Tanh"],
}


def _check_activations(node: Node, op: str, n_dirs: int):
    acts = node.attr("activations")
    if acts is None:
        return
    acts = [a if isinstance(a, bytes) else str(a).encode() for a in acts]
    want = _DEFAULT_ACTS[op] * n_dirs
    if [a.lower() for a in acts] != [w.lower() for w in want]:
        raise UnsupportedOpError(
            f"{op}: only default activations supported, got {acts}")


def _clip_fn(node: Node):
    c = node.attr("clip")
    if c is None:
        return lambda x: x
    c = float(c)
    return lambda x: torch.clamp(x, -c, c)


def _opt(ins, i):
    return ins[i] if len(ins) > i and ins[i] is not None else None


def _prep(node: Node, ins, n_gates: int):
    """Common unpacking: (x [T,B,I], W, R, B, seq_lens, init_h, n_dirs, H,
    direction, layout)."""
    x = ins[0]
    layout = int(node.attr("layout", 0))
    if layout == 1:
        x = x.transpose(0, 1)
    W, R = ins[1], ins[2]  # [D, G*H, I], [D, G*H, H]
    n_dirs = W.shape[0]
    H = W.shape[1] // n_gates
    direction = node.attr("direction", b"forward")
    direction = (direction.decode() if isinstance(direction, bytes)
                 else str(direction)).lower()
    init_h = _opt(ins, 5)
    if layout == 1 and init_h is not None:
        init_h = init_h.transpose(0, 1)
    return (x, W, R, _opt(ins, 3), _opt(ins, 4), init_h, n_dirs, H,
            direction, layout)


def _project(xs, Wd, bias=None):
    """xs [T,B,I] x Wd [G*H, I]^T (+ bias): every step's input projection
    as one matmul."""
    T, B, _ = xs.shape
    g = torch.matmul(xs.reshape(T * B, -1), Wd.t()).reshape(T, B, -1)
    return g if bias is None else g + bias


def _mask_scan(step, carry, gx, seq_lens):
    """Run `step(carry, gx_t) -> (carry, y_t)` over t, with optional
    per-batch length masking: past a sequence's length the carry freezes
    and y is zero (ORT's behavior). Returns (ys [T,B,H], final carry)."""
    ys = []
    for t in range(gx.shape[0]):
        new_carry, y = step(carry, gx[t])
        if seq_lens is not None:
            alive = (seq_lens > t)[:, None]  # [B, 1]
            new_carry = tuple(torch.where(alive, n, c)
                              for n, c in zip(new_carry, carry))
            y = torch.where(alive, y, torch.zeros_like(y))
        carry = new_carry
        ys.append(y)
    return torch.stack(ys), carry


def _flip_valid(x, seq_lens):
    """Per-sequence time reversal of the VALID prefix: frame t of sequence
    b maps to len_b-1-t for t < len_b and stays in place past the length
    (ONNX reverse semantics with sequence_lens). Its own inverse, so the
    same transform un-reverses the outputs. x: [T, B, ...]."""
    T = x.shape[0]
    t = torch.arange(T, device=x.device)[:, None]          # [T, 1]
    lens = seq_lens.to(torch.int64)[None, :]               # [1, B]
    idx = torch.where(t < lens, lens - 1 - t, t)           # [T, B]
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 0, idx)


def _run_directions(x, n_dirs, direction, run_one, seq_lens=None):
    """run_one(xs, d) -> (ys [T,B,H], finals tuple). Returns stacked
    [T, D, B, H] and per-state [D, B, H]."""
    outs, finals = [], []

    def flip(v):
        return (_flip_valid(v, seq_lens) if seq_lens is not None
                else torch.flip(v, (0,)))

    for d in range(n_dirs):
        rev = (direction == "reverse") or (
            direction == "bidirectional" and d == 1)
        xs = flip(x) if rev else x
        ys, fin = run_one(xs, d)
        if rev:
            ys = flip(ys)
        outs.append(ys)
        finals.append(fin)
    y = torch.stack(outs, dim=1)  # [T, D, B, H]
    states = [torch.stack([f[i] for f in finals]) for i in
              range(len(finals[0]))]
    return y, states


def _finish(y, states, layout):
    if layout == 1:  # [T,D,B,H] -> [B,T,D,H]; states [D,B,H] -> [B,D,H]
        y = y.permute(2, 0, 1, 3)
        states = [s.transpose(0, 1) for s in states]
    return (y, *states)


def _zeros(x, B, H):
    return torch.zeros((B, H), dtype=x.dtype, device=x.device)


@register("LSTM")
def lstm(ctx: LoweringContext, node: Node, ins):
    x, W, R, Bb, seq_lens, init_h, n_dirs, H, direction, layout = _prep(
        node, ins, 4)
    _check_activations(node, "LSTM", n_dirs)
    clip = _clip_fn(node)
    init_c, P = _opt(ins, 6), _opt(ins, 7)  # P: [D, 3H]
    if layout == 1 and init_c is not None:
        init_c = init_c.transpose(0, 1)
    Bt = x.shape[1]

    def run_one(xs, d):
        Rd = R[d].t()  # [H, 4H]
        bias = (Bb[d, :4 * H] + Bb[d, 4 * H:]) if Bb is not None else None
        h0 = init_h[d] if init_h is not None else _zeros(x, Bt, H)
        c0 = init_c[d] if init_c is not None else _zeros(x, Bt, H)
        pi, po, pf = ((P[d, :H], P[d, H:2 * H], P[d, 2 * H:])
                      if P is not None else (0.0, 0.0, 0.0))

        def step(carry, gx_t):
            h, c = carry
            g = gx_t + h @ Rd
            g = clip(g if bias is None else g + bias)  # [B, 4H], iofc
            i = torch.sigmoid(g[:, :H] + pi * c)
            o_pre = g[:, H:2 * H]
            f = torch.sigmoid(g[:, 2 * H:3 * H] + pf * c)
            c_new = f * c + i * torch.tanh(g[:, 3 * H:])
            o = torch.sigmoid(o_pre + po * c_new)
            h_new = o * torch.tanh(c_new)
            return (h_new, c_new), h_new

        return _mask_scan(step, (h0, c0), _project(xs, W[d]), seq_lens)

    y, states = _run_directions(x, n_dirs, direction, run_one, seq_lens)
    return _finish(y, states, layout)


@register("GRU")
def gru(ctx: LoweringContext, node: Node, ins):
    x, W, R, Bb, seq_lens, init_h, n_dirs, H, direction, layout = _prep(
        node, ins, 3)
    _check_activations(node, "GRU", n_dirs)
    clip = _clip_fn(node)
    lbr = int(node.attr("linear_before_reset", 0))
    Bt = x.shape[1]

    def run_one(xs, d):
        Rd = R[d].t()  # [H, 3H]
        wb = Bb[d, :3 * H] if Bb is not None else None
        rb = Bb[d, 3 * H:] if Bb is not None else None
        h0 = init_h[d] if init_h is not None else _zeros(x, Bt, H)

        def step(carry, gx):            # gx: x_t Wd + wb, gate order zrh
            (h,) = carry
            gh = h @ Rd
            if rb is not None:
                gh = gh + rb
            z = torch.sigmoid(clip(gx[:, :H] + gh[:, :H]))
            r = torch.sigmoid(clip(gx[:, H:2 * H] + gh[:, H:2 * H]))
            if lbr:
                hh = torch.tanh(clip(gx[:, 2 * H:] + r * gh[:, 2 * H:]))
            else:
                rh = (r * h) @ Rd[:, 2 * H:]
                hh = torch.tanh(clip(gx[:, 2 * H:] + (
                    rh if rb is None else rh + rb[2 * H:])))
            h_new = (1 - z) * hh + z * h
            return (h_new,), h_new

        return _mask_scan(step, (h0,), _project(xs, W[d], wb), seq_lens)

    y, states = _run_directions(x, n_dirs, direction, run_one, seq_lens)
    return _finish(y, states, layout)


@register("RNN")
def rnn(ctx: LoweringContext, node: Node, ins):
    x, W, R, Bb, seq_lens, init_h, n_dirs, H, direction, layout = _prep(
        node, ins, 1)
    _check_activations(node, "RNN", n_dirs)
    clip = _clip_fn(node)
    Bt = x.shape[1]

    def run_one(xs, d):
        Rd = R[d].t()
        bias = (Bb[d, :H] + Bb[d, H:]) if Bb is not None else None
        h0 = init_h[d] if init_h is not None else _zeros(x, Bt, H)

        def step(carry, gx_t):
            (h,) = carry
            g = gx_t + h @ Rd
            h_new = torch.tanh(clip(g if bias is None else g + bias))
            return (h_new,), h_new

        return _mask_scan(step, (h0,), _project(xs, W[d]), seq_lens)

    y, states = _run_directions(x, n_dirs, direction, run_one, seq_lens)
    return _finish(y, states, layout)
