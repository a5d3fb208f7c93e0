"""Sequence and Optional ops (ONNX sequence<tensor> / optional<T> types).
The port's counterpart of onnx_rusty_inference_engine_tpu/ops/sequences.py.

A sequence is a Python list of device tensors: its length (its structure)
is known when the graph runs, its elements' values live on the device. The
same rules as in the JAX package follow, with its messages:
  * positions (SequenceAt / Insert / Erase) must be known before the run,
    but for SequenceAt over a homogeneous sequence, which picks a run-time
    position on the device (the sequence stacked, one index_select);
  * a Loop whose state carries a sequence unrolls (control_flow.py), so
    the "append to a sequence in a Loop" export pattern works.
Optionals are the same idea one level up: presence is known before the
run, the payload lives on the device. `OptionalValue(None)` is the empty
optional. Values the run knows in advance (a length, a presence) are
static values (LoweringContext.put_static): on the card they are made once
per input signature, not copied from the host on every run.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..graph import Node
from .registry import LoweringContext, UnsupportedOpError, register

__all__ = ["OptionalValue", "is_sequence"]


class OptionalValue:
    """ONNX optional<tensor|sequence>: presence known before the run."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value

    @property
    def has(self) -> bool:
        return self.value is not None

    def __repr__(self):
        return f"OptionalValue({'empty' if self.value is None else 'set'})"


def is_sequence(v) -> bool:
    return isinstance(v, list)


def _require_sequence(v, op: str) -> List:
    if not is_sequence(v):
        raise UnsupportedOpError(
            f"{op}: expected a sequence value (trace-time list), got "
            f"{type(v).__name__} — sequence structure must be static under "
            f"XLA; a sequence produced by data-dependent control flow "
            f"cannot be lowered")
    return v


def _static_pos(ctx: LoweringContext, node: Node, idx: int,
                length: int, op: str, default: Optional[int] = None
                ) -> Optional[int]:
    """Position input known before the run, negatives wrapped once; None
    when the input is present but known only at run time (the caller
    decides whether that is legal)."""
    if idx >= len(node.inputs) or not node.inputs[idx]:
        if default is None:
            raise UnsupportedOpError(f"{op}: position input required")
        return default
    c = ctx.constant(node.inputs[idx])
    if c is None:
        return None
    p = int(np.asarray(c).reshape(()))
    if p < 0:
        p += length
    return p


# --------------------------------------------------------------------------
# construction / destructuring
# --------------------------------------------------------------------------
@register("SequenceEmpty")
def sequence_empty(ctx: LoweringContext, node: Node, ins):
    return ([],)


@register("SequenceConstruct")
def sequence_construct(ctx: LoweringContext, node: Node, ins):
    return (list(ins),)


@register("SequenceLength")
def sequence_length(ctx: LoweringContext, node: Node, ins):
    seq = _require_sequence(ins[0], "SequenceLength")
    return (ctx.put_static(node.outputs[0], np.int64(len(seq))),)


@register("SequenceAt")
def sequence_at(ctx: LoweringContext, node: Node, ins):
    seq = _require_sequence(ins[0], "SequenceAt")
    if not seq:
        raise UnsupportedOpError("SequenceAt on an empty sequence")
    p = _static_pos(ctx, node, 1, len(seq), "SequenceAt")
    if p is not None:
        if not 0 <= p < len(seq):
            raise UnsupportedOpError(
                f"SequenceAt: position {p} out of range for length {len(seq)}")
        return (seq[p],)
    # run-time position: legal when every element agrees in shape and
    # dtype; the pick happens on the device, as lax.switch's in JAX
    shapes = {(tuple(v.shape), str(v.dtype)) for v in seq}
    if len(shapes) != 1:
        raise UnsupportedOpError(
            "SequenceAt: dynamic position over a heterogeneous sequence "
            f"(element shapes/dtypes {sorted(map(str, shapes))}) has no "
            "static-shape lowering; make the position a constant")
    n = len(seq)
    pos = ins[1].reshape(1).to(torch.int64)
    pos = torch.clamp(torch.where(pos < 0, pos + n, pos), 0, n - 1)
    return (torch.index_select(torch.stack(seq), 0, pos)[0],)


@register("SequenceInsert")
def sequence_insert(ctx: LoweringContext, node: Node, ins):
    seq = _require_sequence(ins[0], "SequenceInsert")
    p = _static_pos(ctx, node, 2, len(seq), "SequenceInsert",
                    default=len(seq))
    if p is None:
        raise UnsupportedOpError(
            "SequenceInsert: position must be a trace-time constant — a "
            "dynamic insert position changes which static slot each element "
            "occupies")
    if not 0 <= p <= len(seq):
        raise UnsupportedOpError(
            f"SequenceInsert: position {p} out of range for length {len(seq)}")
    out = list(seq)
    out.insert(p, ins[1])
    return (out,)


@register("SequenceErase")
def sequence_erase(ctx: LoweringContext, node: Node, ins):
    seq = _require_sequence(ins[0], "SequenceErase")
    if not seq:
        raise UnsupportedOpError("SequenceErase on an empty sequence")
    p = _static_pos(ctx, node, 1, len(seq), "SequenceErase",
                    default=len(seq) - 1)
    if p is None:
        raise UnsupportedOpError(
            "SequenceErase: position must be a trace-time constant")
    if not 0 <= p < len(seq):
        raise UnsupportedOpError(
            f"SequenceErase: position {p} out of range for length {len(seq)}")
    out = list(seq)
    del out[p]
    return (out,)


# --------------------------------------------------------------------------
# tensor <-> sequence
# --------------------------------------------------------------------------
@register("SplitToSequence")
def split_to_sequence(ctx: LoweringContext, node: Node, ins):
    x = ins[0]
    axis = int(node.attrs.get("axis", 0)) % max(x.dim(), 1)
    n = x.shape[axis]
    if len(node.inputs) > 1 and node.inputs[1]:
        split = np.asarray(ctx.require_constant(
            node.inputs[1], "SplitToSequence split sizes"))
        if split.ndim == 0:
            k = int(split)
            if k <= 0:
                raise UnsupportedOpError(
                    f"SplitToSequence: split size {k} must be positive")
            sizes = [k] * (n // k) + ([n % k] if n % k else [])
        else:
            sizes = [int(s) for s in split.tolist()]
            if sum(sizes) != n:
                raise UnsupportedOpError(
                    f"SplitToSequence: split sizes {sizes} do not sum to "
                    f"dim {n}")
        return (list(torch.split(x, sizes, dim=axis)),)
    # no split input: one element per slice; keepdims sets the rank
    if int(node.attrs.get("keepdims", 1)):
        return (list(torch.split(x, 1, dim=axis)),)
    return (list(torch.unbind(x, dim=axis)),)


@register("ConcatFromSequence")
def concat_from_sequence(ctx: LoweringContext, node: Node, ins):
    seq = _require_sequence(ins[0], "ConcatFromSequence")
    if not seq:
        raise UnsupportedOpError("ConcatFromSequence on an empty sequence")
    axis = int(node.attrs["axis"])
    if int(node.attrs.get("new_axis", 0)):
        return (torch.stack(seq, dim=axis % (seq[0].dim() + 1)),)
    return (torch.cat(seq, dim=axis % seq[0].dim()),)


@register("SequenceMap")
def sequence_map(ctx: LoweringContext, node: Node, ins):
    """Apply the body subgraph to every element (unrolled). Additional
    inputs that are themselves sequences zip per element; plain tensors go
    to every call, per the spec."""
    body = node.attrs.get("body")
    if body is None:
        raise UnsupportedOpError("SequenceMap: missing body subgraph")
    seq = _require_sequence(ins[0], "SequenceMap")
    extras = list(ins[1:])
    for e in extras:
        if is_sequence(e) and len(e) != len(seq):
            raise UnsupportedOpError(
                f"SequenceMap: additional sequence input of length {len(e)} "
                f"!= mapped length {len(seq)}")
    outs: List[List] = [[] for _ in body.outputs]
    for i, elem in enumerate(seq):
        call = [elem] + [e[i] if is_sequence(e) else e for e in extras]
        for col, y in zip(outs, ctx.eval_subgraph(body, call)):
            col.append(y)
    return tuple(outs)


# --------------------------------------------------------------------------
# optionals
# --------------------------------------------------------------------------
@register("Optional")
def optional_construct(ctx: LoweringContext, node: Node, ins):
    if node.inputs and node.inputs[0]:
        return (OptionalValue(ins[0]),)
    return (OptionalValue(None),)


@register("OptionalHasElement")
def optional_has_element(ctx: LoweringContext, node: Node, ins):
    # opset 18: the input itself is optional; absent input -> False. A
    # non-optional tensor/sequence input is trivially present.
    if not node.inputs or not node.inputs[0] or ins[0] is None:
        has = False
    elif isinstance(ins[0], OptionalValue):
        has = ins[0].has
    else:
        has = True
    return (ctx.put_static(node.outputs[0], np.bool_(has)),)


@register("OptionalGetElement")
def optional_get_element(ctx: LoweringContext, node: Node, ins):
    v = ins[0]
    if isinstance(v, OptionalValue):
        if not v.has:
            raise UnsupportedOpError(
                "OptionalGetElement on a statically-empty optional")
        return (v.value,)
    if v is None:
        raise UnsupportedOpError("OptionalGetElement: input is absent")
    return (v,)  # opset 18 allows a plain tensor/sequence passthrough
