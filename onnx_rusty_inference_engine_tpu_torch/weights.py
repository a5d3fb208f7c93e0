"""Weights on the device.

The JAX package keeps weights as numpy `graph.constants` and lets jit place
them; here they become torch tensors on the engine's device once, at
`Engine` build, and the QLinearConv, QLinearMatMul and MatMulInteger
weights are also re-laid once into the layouts their int8 kernels read (the
JAX package re-lays conv weights inside jit on every call,
ops/kernels/qmatmul.py:172).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .graph import Graph
from .ops.kernels.qconv_grouped_int8 import pack_qconv_grouped_weight
from .ops.kernels.qconv_int8 import pack_qconv_weight
from .ops.kernels.qmatmul_int8 import as_int8, colsum_key, pack_qmatmul_weight

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


def _packer(node):
    """(the index of the node's int8 weight input, its rank, the dtypes it
    may have, and the function that lays it out for its kernel), or None
    for a node no int8 kernel reads."""
    if node.op_type == "QLinearMatMul":
        return 3, 2, (torch.int8,), pack_qmatmul_weight
    if node.op_type == "MatMulInteger":
        return 1, 2, (torch.int8, torch.uint8), \
            lambda w: pack_qmatmul_weight(as_int8(w))
    if node.op_type == "QLinearConv":
        if int(node.attr("group", 1)) == 1:
            return 3, 4, (torch.int8,), pack_qconv_weight
        return 3, 4, (torch.int8,), pack_qconv_grouped_weight
    return None


def prepack_int8_weights(graph: Graph, params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Weight name -> kernel layout (`pack_qconv_weight`,
    `pack_qconv_grouped_weight` for group > 1, `pack_qmatmul_weight`) for
    every QLinearConv, QLinearMatMul and MatMulInteger whose weight (int8,
    and for MatMulInteger also uint8, taken as int8 by `as_int8`), 4-D and
    2-D respectively, sits in `params` on a CUDA device. The weight of a
    MatMulInteger with an a_zero_point also keeps the int32 column sums of
    its int8 form under `colsum_key(name)`, which that zero point's
    correction reads (a uint8 A without one sums them per call). On the CPU
    the plain versions read the weights as they are, and nothing is
    packed."""
    packed: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        packer = _packer(node)
        if packer is None:
            continue
        idx, rank, dtypes, pack = packer
        if len(node.inputs) <= idx:
            continue
        name = node.inputs[idx]
        w = params.get(name)
        if (w is not None and w.device.type == "cuda"
                and w.dtype in dtypes and w.dim() == rank
                and name not in packed):
            packed[name] = pack(w)
            if node.op_type == "MatMulInteger" and len(node.inputs) > 2 \
                    and node.inputs[2]:
                packed[colsum_key(name)] = as_int8(w).sum(
                    dim=0, dtype=torch.int32)
    return packed
