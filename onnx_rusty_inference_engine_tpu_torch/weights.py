"""Weights on the device.

The JAX package keeps weights as numpy `graph.constants` and lets jit place
them; here they become torch tensors on the engine's device once, at
`Engine` build, and the QLinearConv, ConvInteger, QLinearMatMul, QGemm and
MatMulInteger weights are also re-laid once into the layouts their int8
kernels read, with the sums and folded biases their zero points need (the
JAX package re-lays conv weights inside jit on every call,
ops/kernels/qmatmul.py:172).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .graph import Graph
from .ops.kernels.qconv_grouped_int8 import pack_qconv_grouped_weight
from .ops.kernels.qconv_int8 import pack_qconv_weight, stem_s2d
from .ops.kernels.qmatmul_int8 import (as_int8, colsum_key, folded_bias_key,
                                       ones_key, pack_qmatmul_weight)

__all__ = ["as_device_tensor", "params_from_numpy", "prepack_int8_weights"]


def as_device_tensor(v, device) -> torch.Tensor:
    """One input (array, scalar or tensor) as a tensor on `device`. A
    read-only numpy array is copied first: a CPU tensor would share it."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def params_from_numpy(arrays: Mapping[str, np.ndarray], device,
                      float32_as: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """name -> numpy array (or numpy scalar, or tensor) => name -> tensor on
    `device`, shape kept, dtype kept but for f32, which becomes
    `float32_as` (rounded to nearest even on the host, before the copy)."""
    out: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):  # bf16 constants decode to torch
            t = a
        else:
            a = np.array(a, copy=True, order="C")
            if a.dtype == object:
                raise TypeError(f"{name}: string tensors have no device form")
            t = torch.from_numpy(a)
        if t.dtype == torch.float32:
            t = t.to(float32_as)
        out[name] = t.to(device)
    return out


_QTYPES = (torch.int8, torch.uint8)


def _conv4(w: torch.Tensor) -> torch.Tensor:
    """A 1-D conv weight [O, C, K] as the 2-D one of height 1 the kernels
    run; a 2-D or 3-D one as it is."""
    return w.unsqueeze(2) if w.dim() == 3 else w


def _packer(node):
    """(the index of the node's weight input, the ranks it may have, the
    function that lays its int8 form (`as_int8`) out for its kernel, and
    the one that sums that form per output), or None for a node no int8
    kernel reads."""
    op = node.op_type
    if op in ("QLinearMatMul", "MatMulInteger", "QGemm"):
        trans = op == "QGemm" and int(node.attr("transB", 0))

        def logical(w):  # [K, N]
            return as_int8(w.t() if trans else w)

        return ((1 if op == "MatMulInteger" else 3), (2,),
                lambda w: pack_qmatmul_weight(logical(w)),
                lambda w: logical(w).sum(dim=0, dtype=torch.int32))
    if op in ("QLinearConv", "ConvInteger"):
        pack = _conv_pack(node)
        return ((3 if op == "QLinearConv" else 1), (3, 4, 5),
                lambda w: pack(as_int8(_conv4(w))),
                lambda w: as_int8(w).sum(dim=tuple(range(1, w.dim())),
                                         dtype=torch.int32))
    return None


def _conv_pack(node):
    """The function that lays a conv node's int8 weight (4-D or 5-D) out
    for its kernel: `pack_qconv_grouped_weight` for group > 1, else
    `pack_qconv_weight` at the node's stride and dilation (a stem's weight
    in its space-to-depth layout; a 1-D conv's stride of one never is)."""
    if int(node.attr("group", 1)) != 1:
        return pack_qconv_grouped_weight
    stride, dilation = node.attr("strides", None), node.attr("dilations",
                                                             None)
    return lambda w: pack_qconv_weight(w, stride, dilation)


def _const_int(graph: Graph, node, idx: int) -> Optional[np.ndarray]:
    """A zero-point input known before the run, as int64 (None: absent or
    computed at run time)."""
    name = node.inputs[idx] if len(node.inputs) > idx else ""
    v = graph.constants.get(name) if name else None
    return None if v is None else np.asarray(v).astype(np.int64).reshape(-1)


def _x_zero_point(graph: Graph, node) -> bool:
    """Whether the node's activation has a zero point its correction needs
    the weight's sums for: a MatMulInteger's a_zero_point input (constant
    or not); a conv's or QLinear product's zero point computed at run time,
    or a constant one, less 128 for a uint8 QLinearMatMul or QGemm operand
    (which `as_int8` shifts), other than 0."""
    present = len(node.inputs) > 2 and bool(node.inputs[2])
    if node.op_type == "MatMulInteger":
        return present
    z = _const_int(graph, node, 2)
    if z is None:
        return present
    name = node.inputs[2]
    shift = (128 if node.op_type in ("QLinearMatMul", "QGemm")
             and np.asarray(graph.constants[name]).dtype == np.uint8 else 0)
    return bool(np.any(z - shift))


def _conv_extras(graph: Graph, node, name: str, w: torch.Tensor,
                 colsum: torch.Tensor, params, packed: dict) -> None:
    """What a QLinearConv's or ConvInteger's zero points need ahead of the
    run: with a weight zero point (or one computed at run time), the packed
    all-ones weight of the window sums (`ones_key`); for a QLinearConv with
    a constant x zero point and none on the weight, its bias with -zx *
    sum w folded in (`folded_bias_key`; a run-time zx is folded in the
    graph)."""
    qlinear = node.op_type == "QLinearConv"
    zx = _const_int(graph, node, 2)
    zw_idx = 5 if qlinear else 3
    zw = _const_int(graph, node, zw_idx)
    zw_runtime = (zw is None and len(node.inputs) > zw_idx
                  and bool(node.inputs[zw_idx]))
    shift = 128 if w.dtype == torch.uint8 else 0
    w_zero = not zw_runtime and ((zw is None and not shift) or (
        zw is not None and not np.any(zw - shift)))
    if not w_zero:
        group = int(node.attr("group", 1))
        ones = torch.ones((group, w.shape[1]) + tuple(_conv4(w).shape[2:]),
                          dtype=torch.int8, device=w.device)
        packed[ones_key(name)] = _conv_pack(node)(ones)
    elif qlinear and colsum is not None and zx is not None and zx.size == 1:
        b = -int(zx[0]) * colsum
        bname = node.inputs[8] if len(node.inputs) > 8 else ""
        if bname:
            if bname not in params:
                return  # the emitter folds it per call
            b = b + params[bname].to(torch.int32)
        packed[folded_bias_key(node.outputs[0])] = b


def prepack_int8_weights(graph: Graph, params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Weight name -> kernel layout (`pack_qconv_weight`,
    `pack_qconv_grouped_weight` for group > 1, `pack_qmatmul_weight`) for
    every QLinearConv, ConvInteger, QLinearMatMul, QGemm and MatMulInteger
    whose weight (int8 or uint8, taken as int8 by `as_int8`; 2-D, and 3-D,
    4-D or 5-D for a conv) sits in `params` on a CUDA device. A weight whose
    node's activation has a zero point (`_x_zero_point`) also keeps the
    int32 sums of its int8 form per output under `colsum_key(name)`, which
    that zero point's correction reads, and a conv what `_conv_extras`
    adds. A conv weight is laid out for its node's stride (a stem's in its
    space-to-depth layout), so two convs that share one must agree on it.
    On the CPU the plain versions read the weights as they are, and
    nothing is packed."""
    packed: Dict[str, torch.Tensor] = {}
    layout: Dict[str, bool] = {}
    for node in graph.nodes:
        packer = _packer(node)
        if packer is None:
            continue
        idx, ranks, pack, sums = packer
        if len(node.inputs) <= idx:
            continue
        name = node.inputs[idx]
        w = params.get(name)
        if (w is None or w.device.type != "cuda" or w.dtype not in _QTYPES
                or w.dim() not in ranks):
            continue
        if name not in packed:
            packed[name] = pack(w)
        if node.op_type in ("QLinearConv", "ConvInteger"):
            stem = int(node.attr("group", 1)) == 1 and stem_s2d(
                w.shape[1], tuple(_conv4(w).shape[2:]),
                node.attr("strides", None) or (), node.attr("dilations",
                                                            None))
            if layout.setdefault(name, stem) != stem:
                raise ValueError(
                    f"{node.op_type} {node.name!r}: weight {name!r} is "
                    f"shared by a stem (space-to-depth layout) and a conv "
                    f"that is not one; its kernel layout is one")
        if colsum_key(name) not in packed and _x_zero_point(graph, node):
            packed[colsum_key(name)] = sums(w)
        if node.op_type in ("QLinearConv", "ConvInteger"):
            _conv_extras(graph, node, name, w, packed.get(colsum_key(name)),
                         params, packed)
    return packed
