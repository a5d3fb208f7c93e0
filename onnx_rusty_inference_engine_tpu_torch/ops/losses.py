"""Loss ops: NegativeLogLikelihoodLoss and SoftmaxCrossEntropyLoss.

The port's counterpart of onnx_rusty_inference_engine_tpu/ops/losses.py.
The JAX package picks `input[n, target[n], d...]` as a one-hot
multiply-sum over the class axis, because an index gather is slow on its
chip; a gather is cheap on the card, so the port gathers, and a target out
of [0, C) (an ignore_index such as -100) picks 0, as the one-hot row of
the JAX form does. The mean is the spec's weighted mean: the denominator
is the summed per-position weight, ignored positions weighing 0.
"""

from __future__ import annotations

import torch

from ..graph import Node
from .registry import LoweringContext, UnsupportedOpError, register


def _pick(values: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """values [N, C, d...] at target [N, d...] along the class axis ->
    [N, d...]; an out-of-range target picks 0."""
    n_classes = values.shape[1]
    t = target.long()
    inside = (t >= 0) & (t < n_classes)
    picked = torch.gather(values, 1, t.clamp(0, n_classes - 1).unsqueeze(1))
    return torch.where(inside, picked.squeeze(1),
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


def _nll_core(node: Node, logp, target, weight):
    """The NLL shared by both ops: per-position loss and weight, then the
    reduction."""
    reduction = node.attr("reduction", "mean")
    ignore_index = node.attr("ignore_index")
    picked = -_pick(logp, target)                        # [N, d...]
    if weight is not None:
        shape = (1, weight.shape[0]) + (1,) * (picked.dim() - 1)
        w_t = _pick(weight.reshape(shape).expand(
            (picked.shape[0], weight.shape[0]) + tuple(picked.shape[1:])),
            target)
    else:
        w_t = torch.ones_like(picked)
    if ignore_index is not None:
        keep = target.long() != int(ignore_index)
        w_t = torch.where(keep, w_t, 0)
        picked = torch.where(keep, picked, 0)
    loss = picked * w_t
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        denom = w_t.sum()
        return loss.sum() / torch.where(denom == 0, 1, denom)
    raise UnsupportedOpError(
        f"{node.op_type}: unknown reduction {reduction!r}")


@register("NegativeLogLikelihoodLoss")
def negative_log_likelihood_loss(ctx: LoweringContext, node: Node, ins):
    weight = ins[2] if len(ins) > 2 else None
    return (_nll_core(node, ins[0], ins[1], weight),)


@register("SoftmaxCrossEntropyLoss")
def softmax_cross_entropy_loss(ctx: LoweringContext, node: Node, ins):
    weight = ins[2] if len(ins) > 2 else None
    # over the class axis moved last: along dim 1 of [N, C, d...] PyTorch
    # takes its strided path, ~100x slower on the card at [8, 50257, 128]
    logp = torch.log_softmax(ins[0].movedim(1, -1), dim=-1).movedim(-1, 1)
    loss = _nll_core(node, logp, ins[1], weight)
    if len(node.outputs) > 1 and node.outputs[1]:
        return (loss, logp)
    return (loss,)
