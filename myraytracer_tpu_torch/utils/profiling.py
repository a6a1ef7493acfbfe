"""Timing, tracing and per-render metrics.

Counterpart of ``myraytracer_tpu/utils/profiling.py``:

  * Timer                  host-clock bracket; ``timed`` synchronises the
                           devices of the result's tensors
  * profile_trace          torch.profiler over a block, with a Chrome
                           trace written to a directory
  * scene_footprint_bytes  bytes of a SceneData's tensors
  * render_metrics         per-render metrics for structured logging
  * device_line, gpu_line  the device a number was taken on: the card's
                           name and power limit as nvidia-smi reports them
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
from typing import Any, Dict, Optional

import torch

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS


def gpu_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    for the first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_line(device) -> str:
    """What to record as the device of a measurement on ``device``: the
    card's :func:`gpu_line` for a CUDA device, else the device type."""
    device = torch.device(device)
    return gpu_line() if device.type == "cuda" else device.type


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out`` (a tensor,
    or tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


@dataclasses.dataclass
class Timer:
    """Host-clock bracket (``with Timer() as t: ...; t.elapsed``). The
    block must end in a synchronise for a device time; :meth:`timed`
    does that for a call."""

    name: str = ""
    elapsed: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @staticmethod
    def timed(fn, *args, sync: bool = True, **kwargs):
        """Run fn and wait for the devices of its result's tensors;
        returns (result, seconds)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            _synchronize(out)
        return out, time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where there is a
    device); yields the profiler, whose ``key_averages()`` sum time by
    op and kernel, and writes its Chrome trace to ``log_dir/trace.json``
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def scene_footprint_bytes(scene) -> int:
    """Bytes of the packed scene's tensors (one copy on its device)."""
    return sum(getattr(scene, f).nbytes for f in ARRAY_FIELDS)


def render_metrics(
    scene,
    width: int,
    height: int,
    render_s: float,
    build_s: Optional[float] = None,
    spp: float = 1.0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Structured per-render metrics, under the reference's keys; ``device``
    is :func:`device_line` of the scene's device."""
    n_rays = int(width * height * spp)
    m = {
        "resolution": f"{width}x{height}",
        "spp": spp,
        "rays": n_rays,
        "render_s": round(render_s, 4),
        "rays_per_s": round(n_rays / render_s, 1) if render_s > 0 else None,
        "n_tris": scene.n_tris,
        "n_spheres": scene.n_spheres,
        "n_planes": scene.n_planes,
        "n_cylinders": scene.n_cylinders,
        "n_lights": scene.n_lights,
        "bvh_nodes": scene.n_nodes,
        "max_depth": scene.max_depth,
        "scene_bytes": scene_footprint_bytes(scene),
        "device": device_line(scene.device),
    }
    if build_s is not None:
        m["build_s"] = round(build_s, 4)
    if extra:
        m.update(extra)
    return m
