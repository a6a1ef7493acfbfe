"""CUDA-graph replay of the entry points: the port's counterpart of jax.jit.

The reference compiles each entry point once per (scene shapes, camera
size, config) and replays the program (``myraytracer_tpu/ops/render.py``:
``render``, the AA refine, the training step behind ``_MirrorAwareJit``;
``myraytracer_tpu/inverse.py``: the fit step with its optimizer update).
Inside those programs ``lax.cond`` decides on the device whether a
segment runs. The port captures each entry point's launches once per key
as a ``torch.cuda.CUDAGraph`` and replays them (:func:`run`), with each
conditional segment under a CUDA-graph IF node (:func:`if_node`):

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
            that the capture recorded outside IF nodes; the capture
            itself adds none. An IF node's body runs or not by a value
            on the card that the replay does not read, so its launches
            are added by :func:`count_bodies`, after a synchronise, for
            the bodies that ran in the last replay of each key: call it
            after a replay whose launches you count, never on a replay's
            path.
  size      at most :data:`MAX_GRAPHS` keys; the least recently used is
            evicted first and its graph and memory pool released.
  group     a sharded entry point (parallel/) passes its mesh's process
            group: the key holds the backend, this rank's index, the
            group's size and the group object itself (a new group over
            the same ranks never replays a graph made with the old
            communicator; a name could repeat after
            ``dist.destroy_process_group``). Only NCCL collectives can be
            captured: a group of any other backend (gloo stages CUDA
            tensors through the host) runs eagerly, by rule, decided
            before the call (:func:`runs_eagerly`). Call :func:`clear`
            before a captured group is destroyed. Every rank makes the
            same calls in the same order, so every rank warms up,
            captures and evicts the same keys at the same call. No
            collective may run inside an IF node's body (a rank that
            skips the body would hang the others): the port's one
            all-reduce raises there (:func:`if_body_site`).

  autograd  a call that records autograd (``render(clamp=False)`` on a
            scene or camera whose tensors require grad, with grad mode
            on) runs eagerly, by rule: a replay returns copies of the
            graph's output buffers, which carry no autograd graph. The
            caller decides it from its arguments before the call
            (``records_grad``, :func:`runs_eagerly`), so such a call never
            makes a key or a cache entry.

:func:`disable_graphs` runs every entry point eagerly, the counterpart of
``jax.disable_jit()``; it is the only eager switch for CUDA tensors
apart from the backend and autograd rules above. Tensors on the CPU
always run eagerly. A capture that fails raises
:class:`GraphCaptureError`, naming the entry point and the line that
failed; no call is retried eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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
class _Body:
    """The body of one IF node of a captured graph."""

    pred: torch.Tensor                  # 0-d bool, written by each replay
    launches: Dict[str, int]            # kernel launches the body holds
    site: str = ""                      # what the body runs (if_node's)


@dataclasses.dataclass
class _Recording:
    """What a capture in progress gives :func:`if_node`."""

    device: torch.device
    pool: Optional[tuple] = None        # the bodies' memory pool, if any
    bodies: List[_Body] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Entry:
    held: tuple                         # tensors read in place
    staged: tuple                       # device buffers of staged inputs
    graph: Any = None                   # torch.cuda.CUDAGraph once captured
    outputs: Any = None                 # the graph's static outputs
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    bodies: List[_Body] = dataclasses.field(default_factory=list)
    body_pool: Optional[tuple] = None   # the IF nodes' bodies' memory


_CACHE: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
#: calls of :func:`run` on a CUDA device so far, by what they did: the
#: eager warm-up of a new key, a capture (followed by its first replay),
#: a replay (captures included); the IF nodes that the captures made
#: (one per conditional segment); and the IF nodes' bodies that ran and
#: that were skipped in the last replay of each key that
#: :func:`count_bodies` counted
COUNTS = {"warm_ups": 0, "captures": 0, "replays": 0, "if_nodes": 0,
          "bodies_run": 0, "bodies_skipped": 0}
_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
#: the streams that IF nodes' bodies are captured on
_BODY_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
#: the capture in progress in :func:`run`, else None
_RECORDING: Optional[_Recording] = None
#: keys replayed since :func:`count_bodies` last ran, whose graphs hold
#: IF nodes
_UNCOUNTED: Dict[int, _Entry] = {}
#: the sites of the IF nodes whose bodies are being recorded, innermost
#: last
_BODY_SITES: List[str] = []
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
    if entry.body_pool is not None:
        torch._C._cuda_releasePool(entry.bodies[0].pred.device.index,
                                   entry.body_pool)
    entry.graph = entry.outputs = entry.body_pool = None
    entry.bodies = []
    _UNCOUNTED.pop(id(entry), None)


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
             staged: Sequence[torch.Tensor], group=None) -> tuple:
    """The cache key of a call of :func:`run` (see the module docstring);
    of a process group it records the backend, this rank's index, the
    size and the group object."""
    return (name, static, tuple(tensor_key(t) for t in held),
            tuple((tuple(s.shape), s.dtype) for s in staged),
            None if group is None else (
                dist.get_backend(group), dist.get_rank(group),
                dist.get_world_size(group), group))


def runs_eagerly(device, group=None, records_grad: bool = False) -> bool:
    """Does :func:`run` call its region eagerly? On the CPU, inside
    :func:`disable_graphs`, for a process group whose backend is not
    NCCL (its collectives cannot be captured), and for a call that
    records autograd (a replay's outputs carry no autograd graph)."""
    return (torch.device(device).type != "cuda" or _disabled > 0
            or (group is not None and dist.get_backend(group) != "nccl")
            or records_grad)


def run(name: str, fn: Callable, device, static=(),
        held: Sequence[torch.Tensor] = (),
        staged: Sequence[torch.Tensor] = (), group=None,
        records_grad: bool = False):
    """``fn(*staged)`` on ``device``, replayed from a CUDA graph.

    ``fn`` reads the tensors of ``held`` in place (it closes over them)
    and the ``staged`` inputs through its arguments, and returns a
    tensor or a tuple, list or dict of tensors (None and numbers pass
    through). ``static`` is the hashable rest of the key; ``group`` the
    process group of the collectives ``fn`` makes, if any;
    ``records_grad`` whether the caller's autograd records the call.
    Where :func:`runs_eagerly` holds, ``fn`` runs eagerly with the staged
    inputs moved to ``device``.
    """
    device = torch.device(device)
    if runs_eagerly(device, group, records_grad):
        return fn(*(s.to(device) for s in staged))
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = make_key(name, static, held, staged, group)
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
        _capture(name, fn, entry, device, group is not None)
        COUNTS["captures"] += 1
    entry.graph.replay()
    COUNTS["replays"] += 1
    for k, n in entry.launches.items():
        _build.LAUNCHES[k] += n
    if entry.bodies:
        _UNCOUNTED[id(entry)] = entry
    return _clone(entry.outputs)


def count_bodies() -> Tuple[int, int]:
    """Add to ``LAUNCHES`` the launches of the IF nodes' bodies that ran
    in the last replay of each key replayed since the last call, and
    return how many bodies ran and were skipped there (also added to
    :data:`COUNTS`). It synchronises the card and reads each body's
    condition, so it is never called on a replay's path."""
    ran = skipped = 0
    for entry in _UNCOUNTED.values():
        torch.cuda.synchronize(entry.bodies[0].pred.device)
        taken = torch.stack([b.pred for b in entry.bodies]).tolist()
        for body, took in zip(entry.bodies, taken):
            if took:
                for k, n in body.launches.items():
                    _build.LAUNCHES[k] += n
        ran += sum(taken)
        skipped += len(taken) - sum(taken)
    _UNCOUNTED.clear()
    COUNTS["bodies_run"] += ran
    COUNTS["bodies_skipped"] += skipped
    return ran, skipped


def body_sites(name: Optional[str] = None) -> List[Tuple[str, bool]]:
    """(site, ran) of every IF node's body in the last replay of each
    captured key (of the entry point ``name`` only, if given), in capture
    order. It synchronises the card and reads each body's condition, so
    it is never called on a replay's path."""
    out = []
    for key, entry in _CACHE.items():
        if entry.graph is not None and entry.bodies and (
                name is None or key[0] == name):
            torch.cuda.synchronize(entry.bodies[0].pred.device)
            taken = torch.stack([b.pred for b in entry.bodies]).tolist()
            out += [(b.site, took) for b, took in zip(entry.bodies, taken)]
    return out


def _stage(entry: _Entry, staged) -> None:
    """Copy each staged input into its buffer, on the current stream
    (ordered after the last replay that read the buffer)."""
    for buf, src in zip(entry.staged, staged):
        buf.copy_(src, non_blocking=True)


def _stream(streams: dict, device: torch.device) -> torch.cuda.Stream:
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _warm_up(fn: Callable, entry: _Entry, device: torch.device):
    """The eager first call of a key, on a side stream."""
    cur = torch.cuda.current_stream(device)
    side = _stream(_SIDE_STREAMS, device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*entry.staged)
    cur.wait_stream(side)
    return out


def _failure_site(exc: BaseException) -> str:
    """Where a failed capture stopped: the innermost line outside the
    torch package of the first exception in ``exc``'s chain (a capture
    whose region read the host fails again when the capture ends), and
    that exception. An exception raised ``from`` another (a
    :class:`GraphCaptureError` of :func:`if_node`, which names its
    segment) ends the walk."""
    while exc.__context__ is not None and not exc.__suppress_context__:
        exc = exc.__context__
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames
           if not f.filename.startswith(os.path.dirname(torch.__file__))]
    f = (own or frames or [None])[-1]
    at = (f"{os.path.basename(f.filename)}:{f.lineno} in {f.name} "
          f"({(f.line or '').strip()})" if f else "an unknown line")
    return f"{at}: {type(exc).__name__}: {exc}"


def _capture(name: str, fn: Callable, entry: _Entry, device: torch.device,
             collective: bool = False) -> None:
    """Capture ``fn`` into the entry's graph; the launches its kernel
    wrappers count during the capture outside IF nodes become the count
    of one replay, those inside each node its body's count. A region with
    a ``collective`` is captured in the thread-local mode: the process
    group's watchdog thread queries the events of eager collectives (a
    warm-up's all-reduce, a checkpoint's barrier), which under the global
    mode could invalidate the capture from that thread."""
    global _RECORDING
    before = dict(_build.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    rec = _RECORDING = _Recording(device)
    try:
        with torch.cuda.graph(graph, capture_error_mode=(
                "thread_local" if collective else "global")):
            out = fn(*entry.staged)
    except Exception as e:
        if rec.pool is not None:
            torch._C._cuda_releasePool(rec.device.index, rec.pool)
        raise GraphCaptureError(
            f"graph capture of {name} failed at {_failure_site(e)}. The "
            f"region must not read device values on the host, copy from "
            f"pageable host memory or step an optimizer built without "
            f"capturable=True; run it under disable_graphs() to run it "
            f"eagerly") from e
    finally:
        _RECORDING = None
        counted = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        _build.LAUNCHES.update(before)
    entry.graph, entry.outputs = graph, out
    entry.launches = {k: v for k, v in counted.items() if v}
    entry.bodies, entry.body_pool = rec.bodies, rec.pool
    COUNTS["if_nodes"] += len(rec.bodies)


def if_body_site() -> Optional[str]:
    """The site of the IF node whose body is being recorded (the
    innermost), or None outside every body."""
    return _BODY_SITES[-1] if _BODY_SITES else None


@contextlib.contextmanager
def recording_body(site: str):
    """Marks the block as the body of the IF node ``site``
    (:func:`if_node` records each body inside it)."""
    _BODY_SITES.append(site)
    try:
        yield
    finally:
        _BODY_SITES.pop()


def capturing(device) -> bool:
    """Is the current stream of the CUDA ``device`` capturing a graph?
    (False for any other device.)"""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def if_node(pred: torch.Tensor, body: Callable[[], Any], site: str) -> None:
    """Capture ``body()`` under a CUDA-graph IF node on the 0-d bool
    ``pred``: the counterpart of ``lax.cond`` inside a captured region.

    A replay runs the body's launches only where ``pred`` holds when the
    node is reached; else the tensors that the body writes in place keep
    what they held. The body may launch kernels, copies and fills on
    device memory, and allocate: its blocks come from a pool of its own,
    which the bodies of one graph share and which lives as long as the
    graph, so it must copy every result that later nodes read into a
    tensor allocated before the node. Its launches are counted apart
    (:func:`count_bodies`). The node is made by ``csrc/graph_cond.cu``
    (``cudaGraphAddNode`` of a conditional node, set on the device by
    ``cudaGraphSetConditional``). Any failure raises
    :class:`GraphCaptureError` naming ``site``: a capture that cannot
    branch is never made with the branch's body run unconditionally. It
    may be called from the autograd engine's device thread (a backward
    inside the captured region): the recording is read by every thread,
    and the body's allocations are routed by the calling thread.
    """
    rec = _RECORDING
    if rec is None:
        raise GraphCaptureError(
            f"{site}: an IF node is captured only inside graphs.run")
    if not (pred.is_cuda and pred.dtype == torch.bool and pred.dim() == 0):
        raise GraphCaptureError(
            f"{site}: an IF node's condition is a 0-d bool tensor on the "
            f"card, not {pred.dtype} {tuple(pred.shape)} on {pred.device}")
    lib = _build.library()
    device = pred.device
    body_stream = _stream(_BODY_STREAMS, device)
    with torch.cuda.device(device):
        err = lib.mrt_if_node_begin(
            pred.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
            body_stream.cuda_stream)
    if err:
        raise GraphCaptureError(f"{site}: CUDA refused the IF node: "
                                f"{lib.mrt_error_string(err).decode()}")
    before = dict(_build.LAUNCHES)
    # the capture's own pool routes only its stream's allocations; the
    # body's stream gets the bodies' pool, whose first reference the
    # recording keeps (released with the graph)
    pool = rec.pool or torch.cuda.graph_pool_handle()
    try:
        torch._C._cuda_beginAllocateCurrentThreadToPool(device.index, pool)
        try:
            with torch.cuda.stream(body_stream), recording_body(site):
                body()
        finally:
            torch._C._cuda_endAllocateToPool(device.index, pool)
            if rec.pool is None:
                rec.pool = pool
            else:
                torch._C._cuda_releasePool(device.index, pool)
    except Exception as e:
        raise GraphCaptureError(f"{site}: {_failure_site(e)}") from e
    finally:
        end = lib.mrt_if_node_end(body_stream.cuda_stream)
    if end:
        raise GraphCaptureError(f"{site}: the IF node's body could not be "
                                f"captured: "
                                f"{lib.mrt_error_string(end).decode()}")
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v != before[k]}
    _build.LAUNCHES.update(before)
    rec.bodies.append(_Body(pred, launched, site))


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
