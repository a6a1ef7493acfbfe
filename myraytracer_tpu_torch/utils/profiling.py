"""Timing, tracing and per-render metrics.

Counterpart of ``myraytracer_tpu/utils/profiling.py``:

  * span                   a host span ``mrt.<name>``: a profiler range
                           while a profiler records, else one shared
                           no-op
  * mark, PHASES           a device phase mark: an empty kernel
                           ``mrt_mark<P>`` (csrc/mark.cu) that opens phase
                           ``PHASES[P]`` on the device clock, inside a
                           CUDA graph too
  * phase_of               the phase a profiled kernel's name marks
  * Timer                  host-clock bracket; ``timed`` synchronises the
                           devices of the result's tensors
  * profile_trace          torch.profiler over a block, with a Chrome
                           trace written to a directory
  * scene_footprint_bytes  bytes of a SceneData's tensors
  * render_metrics         per-render metrics for structured logging
  * device_line, gpu_line  the device a number was taken on: the card's
                           name and power limit as nvidia-smi reports them

Spans time the host's work around the CUDA graphs' replays (the entry
points, ``ops/graphs.run``'s key, stage, launch and clone, the fit
loop); none sits inside a captured region, where it would run only at
the capture. Marks split the device time inside a replay, which no host
span can: a mark opens a phase that lasts until the next mark, each
captured region ends with the mark ``end`` (after which no phase is
open), and a mark inside an IF node's body runs only when the body runs.
The phases of a trace (:data:`TRACE_PHASES`) subdivide the stage that
the last other mark opened (``rays``, ``aa.select``, ``fit.replay``,
...).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import subprocess
import time
from typing import Any, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from myraytracer_tpu_torch.kernels import _build

#: the device phases, in the order of csrc/mark.cu's kernels: a mark of
#: PHASES[P] launches ``mrt_mark<P>``. ``rays``: the primary rays and the
#: scene's packed tables; ``segment``: a Whitted segment's start (and its
#: glue); ``analytic``: the dense sphere/plane/cylinder tests, closest
#: and occlusion; ``tri``: a triangle query (K2 + K1/K1', K7 or the
#: brute oracle) of a trace's first segment, closest hit and shadows;
#: ``shade``: K3, K4, K5 or K10;
#: ``aa.select``, ``aa.apply``: the AA refine's pixel selection and
#: subrays, and its average into the image; ``refit``, ``topology``,
#: ``replay``, ``backward``: the training step's stages
#: (ops/render._loss_grad_tiled); ``fit.*``: the fit step's
#: (inverse.InverseRenderer._step_body); ``end``: a captured region's end;
#: ``tri.bounce``: a triangle query of a later segment (reflected rays and
#: their shadows); ``shade.autograd``: the autograd replay's forward
#: (``shade.resolve_hit``'s row gathers and the lighting). A new phase goes
#: at the end, so that every mark keeps its index
PHASES = ("rays", "segment", "analytic", "tri", "shade", "aa.select",
          "aa.apply", "refit", "topology", "replay", "backward",
          "fit.topology", "fit.replay", "fit.backward", "fit.adam", "end",
          "tri.bounce", "shade.autograd")

#: the phases inside a trace: each subdivides the stage that the last
#: mark of another phase opened
TRACE_PHASES = ("segment", "analytic", "tri", "shade", "tri.bounce",
                "shade.autograd")

_PHASE_INDEX = {p: i for i, p in enumerate(PHASES)}

#: what :func:`span` returns while no profiler records
_NOOP = contextlib.nullcontext()

#: the range a span opens while a profiler records: a RecordFunction, as
#: ``torch.profiler.record_function`` opens, without its dispatcher ops
#: (2 us a span under a profiler against 40 us on one CPU core)
_RANGE = torch._C._profiler._RecordFunctionFast

#: a mark's kernel as a profile names it, e.g. "void mrt_mark<3>()"
_MARK_NAME = re.compile(r"\bmrt_mark<[^0-9>]*([0-9]+)")


def span(name: str, what: Optional[str] = None):
    """A host span ``mrt.<name>`` (``mrt.<name> <what>`` with ``what``,
    e.g. the entry point a graph launch replays): a profiler range
    (:data:`_RANGE`) while a profiler records, a host event on the clock
    of the profile's device events. Else the one shared no-op context:
    one flag test, nothing allocated, no profiler op entered."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _RANGE(f"mrt.{name}" if what is None else f"mrt.{name} {what}")


def mark(phase: str, device: torch.device) -> None:
    """Open the device phase ``phase`` (one of :data:`PHASES`) on
    ``device``'s current stream: launch the empty kernel ``mrt_mark<P>``,
    which a graph capture records as a node. Nothing for a device other
    than CUDA, and nothing while the autograd engine runs a backward (the
    forward code that a checkpoint recomputes, a conditional segment's
    VJP): the phase open before the backward holds all of it. A mark is
    not counted in ``kernels.LAUNCHES``. Raises KeyError for a phase not
    in the table."""
    index = _PHASE_INDEX[phase]
    if device.type == "cuda" and torch._C._current_autograd_node() is None:
        _launch_mark(index, device)


def _launch_mark(index: int, device: torch.device) -> None:
    """Launch ``mrt_mark<index>`` on ``device``'s current stream."""
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.mrt_mark(index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"mark {PHASES[index]}: CUDA error {err}: "
                           f"{lib.mrt_error_string(err).decode()}")


def phase_of(kernel: str) -> Optional[str]:
    """The phase that a profiled kernel named ``kernel`` opens, or None
    for a kernel that is no mark."""
    m = _MARK_NAME.search(kernel)
    return PHASES[int(m.group(1))] if m else None


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
    from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS

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
