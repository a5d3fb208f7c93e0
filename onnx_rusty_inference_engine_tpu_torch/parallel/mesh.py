"""Device meshes and multi-process bring-up on torch.distributed.

The port's counterpart of onnx_rusty_inference_engine_tpu/parallel/mesh.py.
A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims and
one rank (one process) per device: on the card its process group is NCCL,
and it is gloo only where the caller asks for the CPU (`device="cpu"`, as
the tests do). A mesh of one rank is what one card gives; its collectives
run over a group of one.

`make_mesh` makes the process group where none exists: from the
torchrun-style environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)
where it is set, else a world of one process on a free localhost port.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["initialize_distributed", "make_mesh", "local_mesh", "backend_for",
           "axis_size"]


def backend_for(device) -> str:
    """The process-group backend of a device type: NCCL on the card, gloo
    on the CPU, and nothing else (no gloo for a CUDA mesh)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}")


def _select_card(device) -> None:
    """Bind this process to its card before NCCL sees it: the local rank
    (LOCAL_RANK, else the global rank) modulo the cards present."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh asked for but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    torch.cuda.set_device(rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout: Optional[float] = None,
) -> None:
    """Multi-process bring-up: one process group over `num_processes`
    processes (read from ORIET_NUM_PROCESSES when not given), rendezvous at
    `coordinator_address` ("host:port"). NCCL on the card, gloo on the CPU.
    `timeout` (seconds) bounds every collective, so a dead peer fails the
    survivors' calls instead of hanging them.

    Does nothing when running as one process (the common path)."""
    if num_processes is None:
        num_processes = int(os.environ.get("ORIET_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed: more than one process "
                         "needs coordinator_address and process_id")
    _select_card(device)
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend_for(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kw)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_group(device) -> None:
    """A process group for `device`'s backend: the existing one (which must
    be of that backend), the environment's, or a world of one."""
    backend = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have).split(":")[-1].split(","):
            raise ValueError(f"the process group's backend is {have!r}; a "
                             f"{torch.device(device).type} mesh needs "
                             f"{backend!r}")
        return
    _select_card(device)
    if all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                     "WORLD_SIZE")):
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh dim named `axis`."""
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None,
              *, device="cuda") -> DeviceMesh:
    """A DeviceMesh with named dims, e.g. {"data": 2, "model": 2}, over
    the global ranks `devices` (default: every rank, in order), one rank a
    device. Raises when the mesh wants more ranks than exist. Put the most
    communication-heavy dim ("model") innermost, as in the JAX package."""
    _ensure_group(device)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = int(np.prod(list(axes.values())))
    if n > len(ranks):
        raise ValueError(f"mesh wants {n} devices, have {len(ranks)}")
    mesh = torch.tensor(ranks[:n], dtype=torch.int64).reshape(
        tuple(int(v) for v in axes.values()))
    return DeviceMesh(torch.device(device).type, mesh,
                      mesh_dim_names=tuple(axes))


def local_mesh(model_parallel: int = 1, *, device="cuda") -> DeviceMesh:
    """Every rank: data-parallel outer, model-parallel inner."""
    _ensure_group(device)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    return make_mesh({"data": n // model_parallel, "model": model_parallel},
                     device=device)
