"""Weights on the device.

The JAX package keeps weights as numpy `graph.constants` and lets jit place
them; here they become torch tensors on the engine's device once, at
`Engine` build, and the QLinearConv and QLinearMatMul weights are also
re-laid once into the layouts their int8 kernels read (the JAX package
re-lays conv weights inside jit on every call, ops/kernels/qmatmul.py:172).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .graph import Graph
from .ops.kernels.qconv_grouped_int8 import pack_qconv_grouped_weight
from .ops.kernels.qconv_int8 import pack_qconv_weight
from .ops.kernels.qmatmul_int8 import pack_qmatmul_weight

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


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """name -> numpy array (or numpy scalar, or tensor) => name -> tensor on
    `device`, dtype and shape kept."""
    out: Dict[str, torch.Tensor] = {}
    for name, a in arrays.items():
        if isinstance(a, torch.Tensor):  # bf16 constants decode to torch
            out[name] = a.to(device)
            continue
        a = np.array(a, copy=True, order="C")
        if a.dtype == object:
            raise TypeError(f"{name}: string tensors have no device form")
        out[name] = torch.from_numpy(a).to(device)
    return out


def _packer(node):
    """(the rank of the node's int8 weight, input 3, and the function that
    lays it out for its kernel), or None for a node no int8 kernel reads."""
    if node.op_type == "QLinearMatMul":
        return 2, pack_qmatmul_weight
    if node.op_type == "QLinearConv":
        if int(node.attr("group", 1)) == 1:
            return 4, pack_qconv_weight
        return 4, pack_qconv_grouped_weight
    return None


def prepack_int8_weights(graph: Graph, params: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Weight name -> kernel layout (`pack_qconv_weight`,
    `pack_qconv_grouped_weight` for group > 1, `pack_qmatmul_weight`) for
    every QLinearConv and QLinearMatMul whose int8 weight, 4-D and 2-D
    respectively, sits in `params` on a CUDA device. On the CPU the plain
    versions read the weights as they are, and nothing is packed."""
    packed: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        packer = _packer(node)
        if packer is None or len(node.inputs) < 4:
            continue
        rank, pack = packer
        w = params.get(node.inputs[3])
        if (w is not None and w.device.type == "cuda"
                and w.dtype == torch.int8 and w.dim() == rank
                and node.inputs[3] not in packed):
            packed[node.inputs[3]] = pack(w)
    return packed
