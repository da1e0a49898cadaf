"""Process groups for data-parallel training (counterpart of
`dgn_tpu/parallel/mesh.py`).

dgn_tpu runs one process per host, which drives every device of the host
through a jax Mesh; on a pod `jax.distributed.initialize` joins the hosts
first.  The port follows the PyTorch idiom instead: one process per GPU
(one rank per device), joined by `torch.distributed`.  Its flags map so:

  * `--n_devices N` on one host: N ranks, rank r on `cuda:r` (NCCL), or N
    gloo ranks on the CPU with `--device cpu` (dgn_tpu: one process, a
    mesh of N local devices);
  * `--multihost --coordinator_address H:P --num_processes W --process_id
    R`: this process is rank R of a world of W, on `cuda:<local rank>`
    (dgn_tpu: host R of W, driving all its devices).  Without the three
    arguments the torchrun environment (`MASTER_ADDR`, `MASTER_PORT`,
    `WORLD_SIZE`, `RANK`, `LOCAL_RANK`) gives them, as a TPU pod's
    metadata gives them to dgn_tpu.

A `Mesh` holds the group (the world group: one data-parallel axis), its
size, this rank and this rank's device; the layers and trainers take it
explicitly and pass its group to every collective.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: str = "cuda") -> tuple:
    """Join the multi-host world (`run --multihost`); must run before any
    collective.  coordinator_address is rank 0's 'host:port'.  With all
    three arguments omitted the torchrun environment variables give them
    (init_method "env://").  Returns (rank, world size)."""
    kwargs = {"backend": backend_for(device)}
    if coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(**kwargs)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return kwargs.get("rank", 0), kwargs.get("world_size", 1)


def local_device(device: str, rank: int) -> torch.device:
    """This rank's device: `cuda:<LOCAL_RANK>` (else rank modulo the
    visible GPUs) for device "cuda", the CPU for "cpu"."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


@dataclasses.dataclass
class Mesh:
    """One data-parallel axis: the process group, its size, this rank and
    this rank's device."""
    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: Optional[int], device) -> Mesh:
    """The mesh of the initialised world group, this rank on device.
    n_devices, when given, must equal the world's size: a rank cannot
    drive a subset of the world here, unlike a jax Mesh over the first n
    devices of a host."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} ranks")
    return Mesh(dist.group.WORLD, size, dist.get_rank(), torch.device(device))
