"""The mesh's collectives as `oriet::` operators.

A sharded Engine (spmd.py) moves data between ranks with three operators,
defined like the hand kernels' (ops/kernels/_ops.py), so that a CUDA graph
captures them (NCCL collectives inside the graph) and torch.export records
them by name in a sharded artifact (export_aot.py):

    dist_all_gather(x, dim, group)  the group's shards of x, concatenated
                                    along `dim` in rank order
    dist_all_reduce(x, group)       the sum of the group's x
    dist_shard(x, dim, group)       this rank's block of `dim` (no data
                                    moves; a copy, read at run time, so an
                                    exported program holds no rank)

`group` is a key, "<mesh dims>/<dim name>" (e.g. "data=2,model=2/model"),
that `register_mesh` maps to the process group of that mesh dim on this
rank: an artifact names the mesh it was exported on, and loading it
registers the loader's mesh under the same key.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..ops.kernels._ops import define
from .mesh import axis_size

__all__ = ["register_mesh", "mesh_key", "group_key", "all_gather",
           "all_reduce", "shard", "group_size"]

# group key -> (process group, its size, this rank's index in it)
_GROUPS: Dict[str, Tuple[object, int, int]] = {}


def mesh_key(mesh) -> str:
    """The mesh's dims and sizes, "data=2,model=2"."""
    return ",".join(f"{a}={axis_size(mesh, a)}" for a in mesh.mesh_dim_names)


def group_key(mesh, axis: str) -> str:
    return f"{mesh_key(mesh)}/{axis}"


def register_mesh(mesh) -> str:
    """Map each mesh dim's key to its process group on this rank; the
    mesh's key."""
    for a in mesh.mesh_dim_names:
        _GROUPS[group_key(mesh, a)] = (mesh.get_group(a), axis_size(mesh, a),
                                       mesh.get_local_rank(a))
    return mesh_key(mesh)


def group_size(key: str) -> int:
    return _lookup(key)[1]


def _lookup(key: str):
    hit = _GROUPS.get(key)
    if hit is None:
        raise RuntimeError(f"no mesh registered for collective group {key!r}"
                           f" (register_mesh, or load_exported(mesh=...))")
    return hit


def _gather_flat(out: torch.Tensor, inp: torch.Tensor, pg) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        fn(out, inp, group=pg)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (gloo and NCCL reduce no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _order(x: torch.Tensor) -> list:
    """x's dims from outermost to innermost in memory: a permutation under
    which x is contiguous (the identity where there is none). A collective
    keeps it, so that its output lies as its input does (the int8 convs'
    channels-last outputs stay channels-last) and what follows sums in
    the same order as in the unsharded run."""
    perm = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return perm if x.permute(perm).is_contiguous() else list(range(x.dim()))


def _inverse(perm: list) -> list:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


def _like(x: torch.Tensor, shape) -> torch.Tensor:
    """An empty tensor of `shape` laid out in x's dim order."""
    perm = _order(x)
    return x.new_empty([shape[p] for p in perm]).permute(_inverse(perm))


def _all_gather(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    pg, n, _ = _lookup(group)
    perm = _order(x)
    d = perm.index(dim % x.dim())
    xt = _wire(x).permute(perm).movedim(d, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _gather_flat(out, xt, pg)
    return out.to(x.dtype).movedim(0, d).contiguous().permute(_inverse(perm))


def _all_gather_fake(x, dim, group):
    shape = list(x.shape)
    shape[dim % x.dim()] *= _lookup(group)[1]
    return _like(x, shape)


def _all_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    pg = _lookup(group)[0]
    perm = _order(x)
    out = x.permute(perm).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=pg)
    return out.permute(_inverse(perm))


def _shard(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    _, n, r = _lookup(group)
    dim = dim % x.dim()
    k = x.shape[dim] // n
    out = _like(x, [k if i == dim else s for i, s in enumerate(x.shape)])
    return out.copy_(x.narrow(dim, r * k, k))


def _shard_fake(x, dim, group):
    shape = list(x.shape)
    shape[dim % x.dim()] //= _lookup(group)[1]
    return _like(x, shape)


_ALL_GATHER = define("dist_all_gather(Tensor x, int dim, str group) -> Tensor",
                     _all_gather, _all_gather, _all_gather_fake)
_ALL_REDUCE = define("dist_all_reduce(Tensor x, str group) -> Tensor",
                     _all_reduce, _all_reduce,
                     lambda x, group: torch.empty_like(x))
_SHARD = define("dist_shard(Tensor x, int dim, str group) -> Tensor",
                _shard, _shard, _shard_fake)


def all_gather(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """The group's shards of x concatenated along `dim`, in rank order."""
    return _ALL_GATHER(x, int(dim), group)


def all_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    """The sum of the group's x."""
    return _ALL_REDUCE(x, group)


def shard(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """This rank's block of `dim` of a whole tensor (the dim divides)."""
    if x.shape[dim] % group_size(group):
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"over {group}")
    return _SHARD(x, int(dim), group)
