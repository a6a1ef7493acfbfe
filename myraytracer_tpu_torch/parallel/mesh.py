"""Device mesh for ray-parallel rendering (torch.distributed).

Counterpart of ``myraytracer_tpu/parallel/mesh.py``. The only
parallelism a Whitted renderer needs across devices is data parallelism
over rays: the scene is replicated on every device, ray batches are
split over a 1-D mesh, the forward needs no communication, and only the
scene-parameter gradients are summed across devices in a training step.

PyTorch runs one process per device, so the mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the first ``n`` ranks
of the default process group, with the dimension name ``"rays"``. Each
rank's device is explicit: ``cuda:{LOCAL_RANK % device_count}`` (the
global rank when LOCAL_RANK is unset), or the CPU when the caller asks
for ``device="cpu"``. Collectives run on plain tensors through the
mesh's process group: the kernels are ctypes launches, which DTensor
cannot dispatch, so :func:`ray_sharding` and :func:`replicated` are
descriptors only. Every collective of the sharded entry points is one
:func:`all_reduce`.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from myraytracer_tpu_torch.ops import graphs

#: the single mesh axis rays are split over
RAY_AXIS = "rays"

#: rendezvous and collective timeout of every process group this package
#: creates: a rank that never arrives fails the others within it
TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device_type: str) -> str:
    """The collective backend for a device type: NCCL on CUDA, gloo on
    the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the
    CPU for ``device="cpu"``. Raises without a CUDA device when CUDA is
    asked for."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: no {kind} device; pass device='cpu' "
                           "to run the ranks on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """1-D ray mesh over the first ``n_devices`` ranks (default: all).

    Every rank of the process group must call it (a mesh smaller than
    the group creates a subgroup). In a process with no process group it
    first creates a one-rank group on a free localhost port, so
    ``make_mesh(1)`` works without a launcher. Raises ValueError when
    ``n_devices`` exceeds the group's size.
    """
    have = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and not 1 <= n_devices <= have:
        raise ValueError(f"need {n_devices} devices, have {have}")
    dev = rank_device(device)
    if dev.type == "cuda":
        # the mesh keeps a device that is set and initialised: it would
        # otherwise pick one from LOCAL_RANK without the modulo
        torch.cuda.set_device(dev)
        torch.cuda.init()
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev.type),
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0, timeout=TIMEOUT)
    n = have if n_devices is None else n_devices
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(RAY_AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on for ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the mesh; raises when it is not in it."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the ray mesh")
    return coord[0]


def all_reduce(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``mesh``; returns it.

    Captured into a sharded entry point's CUDA graph on NCCL
    (ops/graphs.py). Raises :class:`graphs.GraphCaptureError` while an IF
    node's body is being recorded: the body runs or not by a value that
    each rank holds for itself, and a rank that skipped it would leave
    the others waiting in the collective.
    """
    site = graphs.if_body_site()
    if site is not None:
        raise graphs.GraphCaptureError(
            f"{site}: a collective inside an IF node's body would hang the "
            f"ranks that skip it; all_reduce belongs after the trace")
    dist.all_reduce(t, group=mesh.get_group())
    return t


def ray_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Placement of a flat ray/pixel-major array: leading axis split."""
    return [Shard(0)]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    """Placement of the scene: a full copy on every rank."""
    return [Replicate()]
