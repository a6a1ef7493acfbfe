"""CUDA-graph replay of the entry points: the port's counterpart of jax.jit.

The reference compiles each entry point once per (scene shapes, camera
size, config) and replays the program (``myraytracer_tpu/ops/render.py``:
``render``, the AA refine, the training step behind ``_MirrorAwareJit``;
``myraytracer_tpu/inverse.py``: the fit step with its optimizer update).
Inside those programs ``lax.cond`` decides on the device whether a
segment runs. The port captures each entry point's launches once per key
as a ``torch.cuda.CUDAGraph`` and replays them (:func:`run`):

  key       the entry point's name; its static arguments (the scene's
            static fields, ``live_depth`` among them, ``cfg``, ``tile``,
            the camera's size, ...); shape, dtype, stride, device and
            address of every tensor it reads in place; shape and dtype of
            every staged input.
  held      the cache holds every tensor a graph reads in place, so no
            address in a key is reused by another tensor while the graph
            lives. A replay reads them as they are then: a parameter that
            the optimizer changes in place is followed, as a jit argument
            would be.
  staged    inputs whose values change from call to call at a fixed size
            (a camera, the AA refine's pass-1 image) are copied into a
            buffer of the entry, one copy each, before every call: a new
            camera of the same size reuses the graph, as a new camera
            array reuses the jit.
  calls     the first call of a key runs eagerly on a side stream: the
            warm-up that capture needs (PyTorch's whole-network recipe),
            and a one-shot call (the CLI's ``render``) pays no capture.
            The second call captures and replays; later calls replay.
  outputs   cloned before they are returned, so two results that a caller
            keeps never alias (jit returns fresh arrays).
  launches  ``kernels/_build.LAUNCHES`` gains, per replay, the launches
            that the capture recorded; the capture itself adds none.
  size      at most :data:`MAX_GRAPHS` keys; the least recently used is
            evicted first and its graph and memory pool released.

:func:`disable_graphs` runs every entry point eagerly, the counterpart of
``jax.disable_jit()``; it is the only eager switch for CUDA tensors.
Tensors on the CPU always run eagerly. A capture that fails raises
:class:`GraphCaptureError`, naming the entry point and the line that
failed; no call is retried eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import traceback
from typing import Any, Callable, Dict, Sequence

import torch

from myraytracer_tpu_torch.kernels import _build

#: graphs kept at once. Eight holds every key of one office
#: configuration and triangle method: ``render``, ``render_aa``'s refine,
#: the training step, the fit step, and the keys that a fresh
#: optimizer's first step and a changed AA budget leave behind. Each
#: graph keeps its private memory pool (the peak of its region, about
#: 1 to 2 GB for an office 1920x1080 entry point), so eight stay well
#: inside the card's 80 GB beside the eager working set.
MAX_GRAPHS = 8

class GraphCaptureError(RuntimeError):
    """A graph capture failed: the region made a call that a capture
    cannot hold (a host read, a pageable copy, an uncapturable step)."""


@dataclasses.dataclass
class _Entry:
    held: tuple                         # tensors read in place
    staged: tuple                       # device buffers of staged inputs
    graph: Any = None                   # torch.cuda.CUDAGraph once captured
    outputs: Any = None                 # the graph's static outputs
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


_CACHE: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
#: calls of :func:`run` on a CUDA device so far, by what they did: the
#: eager warm-up of a new key, a capture (followed by its first replay),
#: a replay (captures included)
COUNTS = {"warm_ups": 0, "captures": 0, "replays": 0}
_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_disabled = 0


@contextlib.contextmanager
def disable_graphs():
    """Run every entry point eagerly inside the block (nests)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def graphs_enabled() -> bool:
    """False inside :func:`disable_graphs`."""
    return _disabled == 0


def cache_size() -> int:
    """Keys in the cache (with or without a captured graph)."""
    return len(_CACHE)


def captured() -> int:
    """Keys in the cache whose graph has been captured."""
    return sum(e.graph is not None for e in _CACHE.values())


def clear() -> None:
    """Drop every key, releasing its graph and pool."""
    while _CACHE:
        _release(_CACHE.popitem(last=False)[1])


def _release(entry: _Entry) -> None:
    if entry.graph is not None:
        entry.graph.reset()
    entry.graph = entry.outputs = None


def tensor_key(t: torch.Tensor) -> tuple:
    """What a key records of a tensor read in place."""
    return (tuple(t.shape), t.dtype, t.stride(), t.device, t.data_ptr())


def scene_inputs(scene) -> tuple:
    """(static fields, tensors) of a SceneData: the static part of a key
    (``live_depth`` among it) and the tensors a graph reads in place."""
    static, tensors = [], []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        else:
            static.append((f.name, v))
    return tuple(static), tensors


def make_key(name: str, static, held: Sequence[torch.Tensor],
             staged: Sequence[torch.Tensor]) -> tuple:
    """The cache key of a call of :func:`run` (see the module docstring)."""
    return (name, static, tuple(tensor_key(t) for t in held),
            tuple((tuple(s.shape), s.dtype) for s in staged))


def run(name: str, fn: Callable, device, static=(),
        held: Sequence[torch.Tensor] = (),
        staged: Sequence[torch.Tensor] = ()):
    """``fn(*staged)`` on ``device``, replayed from a CUDA graph.

    ``fn`` reads the tensors of ``held`` in place (it closes over them)
    and the ``staged`` inputs through its arguments, and returns a
    tensor or a tuple, list or dict of tensors (None and numbers pass
    through). ``static`` is the hashable rest of the key. On the CPU and
    inside :func:`disable_graphs`, ``fn`` runs eagerly with the staged
    inputs moved to ``device``.
    """
    device = torch.device(device)
    if device.type != "cuda" or _disabled:
        return fn(*(s.to(device) for s in staged))
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = make_key(name, static, held, staged)
    entry = _CACHE.get(key)
    if entry is None:
        entry = _Entry(held=tuple(held), staged=tuple(
            torch.empty(s.shape, dtype=s.dtype, device=device)
            for s in staged))
        _stage(entry, staged)
        out = _warm_up(fn, entry, device)
        COUNTS["warm_ups"] += 1
        while len(_CACHE) >= MAX_GRAPHS:
            _release(_CACHE.popitem(last=False)[1])
        _CACHE[key] = entry
        return out
    _CACHE.move_to_end(key)
    _stage(entry, staged)
    if entry.graph is None:
        _capture(name, fn, entry)
        COUNTS["captures"] += 1
    entry.graph.replay()
    COUNTS["replays"] += 1
    for k, n in entry.launches.items():
        _build.LAUNCHES[k] += n
    return _clone(entry.outputs)


def _stage(entry: _Entry, staged) -> None:
    """Copy each staged input into its buffer, on the current stream
    (ordered after the last replay that read the buffer)."""
    for buf, src in zip(entry.staged, staged):
        buf.copy_(src, non_blocking=True)


def _warm_up(fn: Callable, entry: _Entry, device: torch.device):
    """The eager first call of a key, on a side stream."""
    cur = torch.cuda.current_stream(device)
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*entry.staged)
    cur.wait_stream(side)
    return out


def _failure_site(exc: BaseException) -> str:
    """Where a failed capture stopped: the innermost line outside the
    torch package of the first exception in ``exc``'s chain (a capture
    whose region read the host fails again when the capture ends), and
    that exception."""
    while exc.__context__ is not None:
        exc = exc.__context__
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames
           if not f.filename.startswith(os.path.dirname(torch.__file__))]
    f = (own or frames or [None])[-1]
    at = (f"{os.path.basename(f.filename)}:{f.lineno} in {f.name} "
          f"({(f.line or '').strip()})" if f else "an unknown line")
    return f"{at}: {type(exc).__name__}: {exc}"


def _capture(name: str, fn: Callable, entry: _Entry) -> None:
    """Capture ``fn`` into the entry's graph; the launches its kernel
    wrappers count during the capture become the count of one replay."""
    before = dict(_build.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn(*entry.staged)
    except Exception as e:
        raise GraphCaptureError(
            f"graph capture of {name} failed at {_failure_site(e)}. The "
            f"region must not read device values on the host, copy from "
            f"pageable host memory or step an optimizer built without "
            f"capturable=True; run it under disable_graphs() to run it "
            f"eagerly") from e
    finally:
        counted = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        _build.LAUNCHES.update(before)
    entry.graph, entry.outputs = graph, out
    entry.launches = {k: v for k, v in counted.items() if v}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x
