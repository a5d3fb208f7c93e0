"""Control-flow emitters: If / Scan / Loop. The port's counterpart of
onnx_rusty_inference_engine_tpu/ops/control_flow.py.

Subgraphs close over the outer scope through
LoweringContext.eval_subgraph (registry.py) and run inline, eagerly: a Scan
or a Loop is a Python loop over its static trip count, so a captured CUDA
graph holds it unrolled. Nothing here reads a value of the device on the
host: an If on a predicate computed at run time runs both branches and
selects each output with `torch.where` (as `lax.cond` both branches must
agree in shapes and dtypes), and a Loop that may exit early runs all of its
M trips and freezes its state with `torch.where` once the body's condition
goes false.

ONNX Loop's fully dynamic form (a trip count known only at run time, or
per-trip scan outputs under a condition computed at run time) has a result
shape that depends on the data; the emitter raises UnsupportedOpError for
it, with the JAX package's messages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import Node
from .registry import LoweringContext, UnsupportedOpError, register
from .sequences import OptionalValue, is_sequence


def _select(pred: torch.Tensor, a, b, what: str):
    """`a` where pred else `b`, for tensors or sequences of tensors of
    equal shapes and dtypes (the form lax.cond requires of its branches)."""
    if is_sequence(a) or is_sequence(b):
        if not (is_sequence(a) and is_sequence(b) and len(a) == len(b)):
            raise UnsupportedOpError(
                f"{what}: the branches give sequences of different lengths")
        return [_select(pred, x, y, what) for x, y in zip(a, b)]
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise UnsupportedOpError(
            f"{what}: a run-time predicate selects tensors or sequences, got "
            f"{type(a).__name__} and {type(b).__name__}")
    if a.shape != b.shape or a.dtype != b.dtype:
        raise UnsupportedOpError(
            f"{what}: the branches give {tuple(a.shape)} {a.dtype} and "
            f"{tuple(b.shape)} {b.dtype}; with a predicate known only at run "
            f"time they must agree in shape and dtype")
    return torch.where(pred, a, b)


@register("If")
def if_op(ctx: LoweringContext, node: Node, ins):
    then_g = node.attr("then_branch")
    else_g = node.attr("else_branch")
    if then_g is None or else_g is None:
        raise UnsupportedOpError("If: missing then/else branch subgraph")

    # constant predicate: lower only the taken branch (dead-branch pruning)
    p_static = ctx.constant(node.inputs[0])
    if p_static is not None:
        g = then_g if bool(np.asarray(p_static).reshape(())) else else_g
        return tuple(ctx.eval_subgraph(g, []))

    pred = ins[0].reshape(()).to(torch.bool)
    then_out = ctx.eval_subgraph(then_g, [])
    else_out = ctx.eval_subgraph(else_g, [])
    if len(then_out) != len(else_out):
        raise UnsupportedOpError(
            f"If: the branches give {len(then_out)} and {len(else_out)} "
            f"outputs")
    return tuple(_select(pred, a, b, f"If {node.name or node.outputs[0]}")
                 for a, b in zip(then_out, else_out))


@register("Scan")
def scan(ctx: LoweringContext, node: Node, ins):
    body = node.attr("body")
    n_scan = int(node.attr("num_scan_inputs"))
    n_state = len(ins) - n_scan
    states = list(ins[:n_state])
    xs = list(ins[n_state:])

    in_axes = [int(a) for a in node.attr("scan_input_axes", [0] * n_scan)]
    in_dirs = [int(d) for d in node.attr("scan_input_directions",
                                         [0] * n_scan)]
    k_out = len(body.outputs) - n_state
    out_axes = [int(a) for a in node.attr("scan_output_axes", [0] * k_out)]
    out_dirs = [int(d) for d in node.attr("scan_output_directions",
                                          [0] * k_out)]

    # every scan input iterates over its leading axis: a view, no copy;
    # a reverse input is read from its end
    norm = [torch.movedim(x, ax % x.dim(), 0) for x, ax in zip(xs, in_axes)]
    T = norm[0].shape[0] if norm else 0
    if any(x.shape[0] != T for x in norm):
        raise UnsupportedOpError(
            f"Scan: scan inputs disagree in length: "
            f"{[x.shape[0] for x in norm]}")
    ys = [[] for _ in range(k_out)]
    for t in range(T):
        slices = [x[T - 1 - t] if d else x[t] for x, d in zip(norm, in_dirs)]
        outs = ctx.eval_subgraph(body, states + slices)
        states = list(outs[:n_state])
        for j, y in enumerate(outs[n_state:]):
            ys[j].append(y)
    # one stack per scan output (one copy kernel each), on its output axis
    final = list(states)
    for y, ax, d in zip(ys, out_axes, out_dirs):
        if not y:
            raise UnsupportedOpError("Scan: zero iterations give scan "
                                     "outputs of unknown shape")
        if d:
            y = y[::-1]
        final.append(torch.stack(y, dim=ax % (y[0].dim() + 1)))
    return tuple(final)


def _body_cond_is_passthrough_or_true(body) -> bool:
    """True when the Loop body's first output (cond_out) is statically the
    incoming condition: an Identity chain from the body's cond input, or a
    constant-true initializer."""
    producers = {o: n for n in body.nodes for o in n.output if o}
    name = body.outputs[0].name
    while name in producers and producers[name].op_type == "Identity":
        name = producers[name].input[0]
    if len(body.inputs) > 1 and name == body.inputs[1].name:
        return True  # passthrough of the incoming cond
    const = body.initializers.get(name)
    return const is not None and bool(np.asarray(const).reshape(()))


def _static_true_start(ctx: LoweringContext, cond_name: str) -> bool:
    """The Loop's initial condition is absent or a constant true."""
    if not cond_name:
        return True
    c = ctx.constant(cond_name)
    return c is not None and bool(np.asarray(c).reshape(()))


@register("Loop")
def loop(ctx: LoweringContext, node: Node, ins):
    body = node.attr("body")
    m_name, cond_name = node.inputs[0], node.inputs[1]
    v_init = list(ins[2:])
    n_state = len(v_init)
    k_scan = len(body.outputs) - 1 - n_state

    trip = ctx.constant(m_name) if m_name else None
    if trip is None:
        raise UnsupportedOpError(
            "Loop: trip count must be statically known for XLA lowering "
            f"(tensor {m_name!r} is dynamic)")
    M = int(np.asarray(trip).reshape(()))
    dev = ctx.device
    # the iteration counters, made on the device (no copy from the host)
    it_dtype = ins[0].dtype if isinstance(ins[0], torch.Tensor) \
        else torch.int64
    iters = torch.arange(M, dtype=it_dtype, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    # sequence/optional state (the "append to a sequence in a Loop" export
    # pattern): its structure is known before the run, so the loop unrolls
    # with the condition held true; a dynamic early exit would make the
    # final structure depend on the data
    if any(is_sequence(v) or isinstance(v, OptionalValue) for v in v_init):
        if not (_static_true_start(ctx, cond_name)
                and _body_cond_is_passthrough_or_true(body)):
            raise UnsupportedOpError(
                "Loop: sequence-valued state with a dynamic exit condition "
                "implies a data-dependent sequence length; make the trip "
                "count static and the body condition a passthrough/constant")
        states = list(v_init)
        ys_acc = [[] for _ in range(k_scan)]
        for i in range(M):
            outs = ctx.eval_subgraph(body, [iters[i], true] + states)
            states = list(outs[1:1 + n_state])
            for j, y in enumerate(outs[1 + n_state:]):
                ys_acc[j].append(y)
        return tuple(states) + tuple(torch.stack(col) for col in ys_acc)

    if k_scan and not (_static_true_start(ctx, cond_name)
                       and _body_cond_is_passthrough_or_true(body)):
        # scan outputs under any dynamic early exit would have a length
        # that depends on the data; a constant-false start would need
        # zero-length ones
        raise UnsupportedOpError(
            "Loop: per-iteration scan outputs with a dynamic exit "
            "condition imply dynamic shapes; make the trip count static "
            "and the body condition a passthrough/constant instead")

    alive = ins[1].reshape(()).to(torch.bool) if cond_name else true
    states = list(v_init)
    ys = [[] for _ in range(k_scan)]
    # exactly M trips; once the body's cond goes false the state freezes
    for i in range(M):
        outs = ctx.eval_subgraph(body, [iters[i], alive] + states)
        states = [torch.where(alive, n, s)
                  for n, s in zip(outs[1:1 + n_state], states)]
        alive = torch.logical_and(alive, outs[0].reshape(()).to(torch.bool))
        for j, y in enumerate(outs[1 + n_state:]):
            ys[j].append(y)
    if k_scan and M == 0:
        raise UnsupportedOpError("Loop: zero trips give scan outputs of "
                                 "unknown shape")
    return tuple(states) + tuple(torch.stack(y) for y in ys)
