"""Multi-process execution: one process per device, across hosts.

Counterpart of ``myraytracer_tpu/parallel/distributed.py``. The scaling
axis is pure ray data parallelism: the scene is replicated on every
rank, ray batches are split over one 1-D mesh spanning every rank of
every host (parallel/mesh.py), the forward does no communication, and a
training step sums the loss and the scene-parameter gradients with one
``all_reduce``.

Launch, one process per device, with either

    MRT_COORDINATOR=host0:8476 MRT_NUM_PROCESSES=8 MRT_PROCESS_ID=$i \\
        LOCAL_RANK=$local python your_script.py

or ``MRT_DISTRIBUTED=1 torchrun --nproc-per-node=4 your_script.py`` (the
variables that torchrun or SLURM set: MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK), and the script calling
:func:`initialize_from_env` before its first collective. These
variables are launch configuration, read once by
:func:`initialize_from_env`, with the same names as the reference's; the
port reads no environment variable as a run-time knob.

``python -m myraytracer_tpu_torch.parallel.dryrun`` runs a sharded
training step on spawned ranks and holds its loss to the single-process
one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, SceneData
from myraytracer_tpu_torch.parallel.mesh import (TIMEOUT, make_mesh,
                                                 mesh_device, mesh_rank,
                                                 ray_sharding, replicated)


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        backend: Optional[str] = None) -> bool:
    """Initialise the default process group from the arguments or the
    MRT_* environment variables.

    The arguments come first, then MRT_COORDINATOR=host:port,
    MRT_NUM_PROCESSES and MRT_PROCESS_ID (``init_method="tcp://..."``);
    MRT_DISTRIBUTED=1 alone uses ``init_method="env://"``, the variables
    torchrun or SLURM set. ``backend`` None picks NCCL when CUDA is
    available and gloo otherwise. Returns True when a group was
    initialised, False when nothing is configured (the process stays
    single). The rendezvous and every collective time out after
    ``mesh.TIMEOUT``.
    """
    coordinator = coordinator or os.environ.get("MRT_COORDINATOR")
    if num_processes is None and os.environ.get("MRT_NUM_PROCESSES"):
        num_processes = int(os.environ["MRT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MRT_PROCESS_ID"):
        process_id = int(os.environ["MRT_PROCESS_ID"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs MRT_NUM_PROCESSES and "
                             "MRT_PROCESS_ID (or the arguments)")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=TIMEOUT)
        return True
    if os.environ.get("MRT_DISTRIBUTED") == "1":
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
        return True
    return False


def global_ray_mesh(device="cuda") -> DeviceMesh:
    """1-D ray mesh over every rank of every process."""
    return make_mesh(None, device)


def make_global(mesh: DeviceMesh, x, spec) -> torch.Tensor:
    """This rank's part of ``x``, which every rank passes in full, on
    this rank's device.

    ``spec`` is :func:`ray_sharding` (this rank's contiguous slice of the
    leading axis, which must already be padded to a multiple of the mesh
    size: shard_render._pad_rays) or :func:`replicated` (the whole
    tensor, checked bit for bit against mesh rank 0's copy by one
    broadcast; raises ValueError when they differ).
    """
    (place,) = spec
    x = torch.as_tensor(x)
    dev = mesh_device(mesh)
    if isinstance(place, Shard) and place.dim == 0:
        size, rank = mesh.size(), mesh_rank(mesh)
        if x.shape[0] % size:
            raise ValueError(f"{x.shape[0]} rows do not split over {size} "
                             "ranks: pad them first")
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n].contiguous().to(dev)
    if not isinstance(place, Replicate):
        raise ValueError(f"unsupported placement {spec}")
    x = x.contiguous().to(dev)
    if x.numel():
        mine = x.reshape(-1).view(torch.uint8)
        first = mine.clone()
        dist.broadcast(first, src=int(mesh.mesh.reshape(-1)[0]),
                       group=mesh.get_group())
        if not torch.equal(first, mine):
            raise ValueError("replicate_global: this rank's data differs "
                             "from mesh rank 0's")
    return x


def shard_rays_global(mesh: DeviceMesh, *arrays):
    """This rank's slices of ray-major arrays (leading axis), which must
    be padded to a multiple of the mesh size."""
    return tuple(make_global(mesh, a, ray_sharding(mesh)) for a in arrays)


def replicate_global(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` (a tensor, a dict of tensors or a
    SceneData) on this rank's device, checked equal on every rank."""
    if isinstance(tree, SceneData):
        return dataclasses.replace(tree, **{
            f: make_global(mesh, getattr(tree, f), replicated(mesh))
            for f in ARRAY_FIELDS})
    if isinstance(tree, dict):
        return {k: replicate_global(mesh, v) for k, v in tree.items()}
    return make_global(mesh, tree, replicated(mesh))
