"""Weights on the device.

The JAX package keeps weights as numpy `graph.constants` and lets jit place
them; here they become torch tensors on the engine's device once, at
`Engine` build, and the QLinearConv weights are also re-laid once into the
layout the int8 kernel reads (the JAX package re-lays them inside jit on
every call, ops/kernels/qmatmul.py:172).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .graph import Graph
from .ops.kernels.qconv_int8 import pack_qconv_weight

__all__ = ["as_device_tensor", "params_from_numpy", "prepack_qconv_weights"]


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


def prepack_qconv_weights(graph: Graph, params: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Weight name -> kernel layout (`pack_qconv_weight`) for every
    QLinearConv whose 4-D int8 weight sits in `params` on a CUDA device. On
    the CPU the plain version reads the weight as it is, and nothing is
    packed."""
    packed: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        if node.op_type != "QLinearConv" or len(node.inputs) < 4:
            continue
        w = params.get(node.inputs[3])
        if (w is not None and w.device.type == "cuda"
                and w.dtype == torch.int8 and w.dim() == 4
                and node.inputs[3] not in packed):
            packed[node.inputs[3]] = pack_qconv_weight(w)
    return packed
