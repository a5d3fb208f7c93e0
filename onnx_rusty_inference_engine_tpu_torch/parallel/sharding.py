"""Sharding rules: how weights and activations map onto the mesh.

The port's counterpart of onnx_rusty_inference_engine_tpu/parallel/
sharding.py, with the same rules under the same conditions. A rule is a
callable `fn(name, array) -> placements`: a tuple of
`torch.distributed.tensor` `Shard(d)` / `Replicate()`, one per mesh dim,
where JAX returns a `NamedSharding`. The Engine (engine.py, spmd.py) takes
`param_sharding_fn` and `input_sharding_fn`; this module gives the
standard policies:

- activations: the batch dim over "data" (data parallelism), or dim 1 (the
  L axis) over "seq" for sequence-parallel prefill;
- CNN weights: the output-channel dim over "model" where it divides
  (tensor parallelism);
- small tensors (biases, scales): replicated.

`spec_of` reads placements back as a JAX PartitionSpec reads: one mesh
dim name (or None) per tensor dim.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
try:
    from torch.distributed.tensor import Replicate, Shard
except ImportError:  # torch < 2.4 keeps them private
    from torch.distributed._tensor import Replicate, Shard

from .mesh import axis_size

__all__ = ["replicated", "placements", "spec_of", "data_input_sharding",
           "seq_input_sharding", "cnn_param_sharding", "shard_params",
           "local_slice", "Shard", "Replicate"]


def replicated(mesh: DeviceMesh) -> tuple:
    """Every mesh dim Replicate()."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def placements(mesh: DeviceMesh, spec: Dict[str, int]) -> tuple:
    """Placements from {mesh dim name: tensor dim}: Shard(d) on the named
    mesh dims, Replicate() on the others."""
    return tuple(Shard(spec[a]) if a in spec else Replicate()
                 for a in mesh.mesh_dim_names)


def spec_of(mesh: DeviceMesh, placed, ndim: int) -> Tuple[Optional[str], ...]:
    """The placements as a PartitionSpec reads: for each tensor dim the
    mesh dim it is sharded over, or None (None placements: replicated)."""
    spec = [None] * ndim
    for axis, p in zip(mesh.mesh_dim_names, placed or ()):
        if isinstance(p, Shard):
            d = p.dim % ndim if ndim else p.dim
            if spec[d] is not None:
                raise ValueError(f"tensor dim {d} sharded over two mesh dims "
                                 f"({spec[d]}, {axis})")
            spec[d] = axis
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p!r}: only Shard and Replicate")
    return tuple(spec)


def data_input_sharding(mesh: DeviceMesh, axis: str = "data") -> Callable:
    """Shard the leading (batch) dim of every input over the data axis."""

    def fn(name: str, arr) -> tuple:
        if arr.ndim >= 1 and axis in mesh.mesh_dim_names:
            n = axis_size(mesh, axis)
            if arr.shape[0] % n == 0 and arr.shape[0] >= n:
                return placements(mesh, {axis: 0})
        return replicated(mesh)

    return fn


def seq_input_sharding(mesh: DeviceMesh, axis: str = "seq",
                       data_axis: str = "data") -> Callable:
    """Sequence parallelism for prefill: dim 1 (the L axis of [B, L]
    token inputs) over `axis`, with the batch over `data_axis` on dim 0.
    The Engine runs position-local nodes on the local positions and
    gathers L before the first node that reads across positions."""

    def fn(name: str, arr) -> tuple:
        spec: Dict[str, int] = {}
        if arr.ndim >= 1 and data_axis in mesh.mesh_dim_names:
            n = axis_size(mesh, data_axis)
            if n > 1 and arr.shape[0] % n == 0:
                spec[data_axis] = 0
        if arr.ndim >= 2 and axis in mesh.mesh_dim_names:
            n = axis_size(mesh, axis)
            if n > 1 and arr.shape[1] % n == 0:
                spec[axis] = 1
        return placements(mesh, spec)

    return fn


def cnn_param_sharding(mesh: DeviceMesh, axis: str = "model") -> Callable:
    """Tensor-shard conv kernels (O I kh kw) and matmul weights on the
    output-feature dim when it divides the model axis; replicate the rest."""

    def fn(name: str, arr) -> tuple:
        if axis not in mesh.mesh_dim_names:
            return replicated(mesh)
        n = axis_size(mesh, axis)
        if n == 1 or arr.ndim < 2:
            return replicated(mesh)
        if arr.ndim == 4 and arr.shape[0] % n == 0:  # conv OIHW: shard O
            return placements(mesh, {axis: 0})
        if arr.ndim == 2 and arr.shape[-1] % n == 0:  # matmul (in,out): out
            return placements(mesh, {axis: 1})
        return replicated(mesh)

    return fn


def local_slice(mesh: DeviceMesh, placed, arr):
    """This rank's part of `arr` (numpy or tensor) under `placed`: for each
    mesh dim that shards tensor dim d, the block of d at this rank's
    coordinate along it. The shards are equal; a dim that does not divide
    raises."""
    spec = spec_of(mesh, placed, arr.ndim)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
        if arr.shape[d] % n:
            raise ValueError(f"dim {d} of size {arr.shape[d]} does not "
                             f"divide over {axis}={n}")
        k = arr.shape[d] // n
        idx = [slice(None)] * arr.ndim
        idx[d] = slice(r * k, (r + 1) * k)
        arr = arr[tuple(idx)]
    return arr


def shard_params(params: Dict[str, torch.Tensor], mesh: DeviceMesh,
                 rule: Callable) -> Dict[str, torch.Tensor]:
    """name -> this rank's shard of each tensor under `rule`."""
    return {k: local_slice(mesh, rule(k, v), v).contiguous()
            for k, v in params.items()}
