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
  tallies   host-side counts a region keeps of what it chose
            (:func:`tally`, e.g. the training replay's route per
            segment) go to :data:`TALLIES`: a call run eagerly adds them
            as it runs, a captured graph the counts its capture made, at
            each replay (:func:`tallies` gives them), as the launches
            below. A tally inside an IF node's body counts as if the
            body ran.
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
  counters  a region may keep counts on the device (:func:`counter`):
            small int64 tensors that its kernels add to in place. Each
            key's own are made at its warm-up, so its graphs add to them
            on every replay with no node of their own; the calls run
            eagerly keep one set per entry point's name. They are read
            on the host (:func:`counters`) after a synchronise, never on
            a call's path; an evicted key's go with it.
  tracing   host spans (``utils/profiling.span``) around a call's work,
            each carrying the entry point's name: ``mrt.graphs.key``
            (the key and the cache lookup), ``.stage``, ``.launch`` (a
            graph's replay and its launch count; a differentiable
            region's backward ``<name> (backward)``), ``.clone``, and in
            set-up ``.warm_up``, ``.capture``, ``.evict``. A captured
            region ends with the device mark ``end``; :func:`nodes` gives
            a captured graph's nodes, :data:`SECONDS` the set-up's host
            seconds, :data:`COUNTS` what the calls did.
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
            on; the caller says so: ``records_grad``) replays two graphs,
            the counterparts of the reference's compiled forward and its
            compiled transpose: the forward, whose autograd residuals stay
            in the entry's memory, and the backward,
            ``torch.autograd.grad`` of the forward's outputs, given their
            cotangents, with respect to every staged and held input that
            requires grad. One autograd Function joins them, so the
            caller's own loss and optimizer run between them, eagerly.
            The key holds which staged and held inputs require grad (an
            optimizer's in-place update keeps it, a new set of leaves
            makes another). The warm-up returns an ordinary autograd
            result; the second call captures the forward, then the
            backward in the forward's memory pool (IF nodes' bodies of
            both draw on one pool that lives as long as the entry), and
            replays the forward. Three rules, decided before each call:
            (a) pending: a forward of a key whose last replayed forward
            still awaits its backward (its output is alive and its
            backward has not run) runs eagerly, counted in
            ``COUNTS["pending_eager"]``, since a replay would overwrite
            the residuals that backward reads; an output that dies
            without a backward releases the key. (b) The LRU never evicts
            an entry with a pending backward. (c) A second backward of one
            forward (``retain_graph=True``) replays the backward graph
            again and gives the same gradients; once a later forward of
            the key has replayed, it raises. ``create_graph=True`` raises:
            the graphs are differentiable once.

:func:`disable_graphs` runs every entry point eagerly, the counterpart of
``jax.disable_jit()``; it is the only eager switch for CUDA tensors
apart from the backend rule and the pending rule above. Tensors on the
CPU always run eagerly. A capture that fails raises
:class:`GraphCaptureError`, naming the entry point (and ``forward`` or
``backward`` of a differentiable one) and the line that failed; no call
is retried eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.utils import profiling
from myraytracer_tpu_torch.utils.profiling import span

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
    nodes: int = 0                      # graph nodes the body holds


@dataclasses.dataclass
class _Recording:
    """What a capture in progress gives :func:`if_node`."""

    device: torch.device
    pool: Optional[tuple] = None        # the bodies' memory pool, if any
    bodies: List[_Body] = dataclasses.field(default_factory=list)
    nodes: int = 0                      # the graph's nodes at its end


@dataclasses.dataclass
class _Graph:
    """One captured region."""

    graph: Any                          # torch.cuda.CUDAGraph
    launches: Dict[str, int]            # per replay, outside IF nodes
    bodies: List[_Body]                 # its IF nodes' bodies
    nodes: int = 0                      # its nodes outside IF nodes' bodies
    label: str = ""                     # its launch span's entry point
    #: what its capture added to TALLIES, added again at each replay
    tallies: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Entry:
    device: torch.device
    held: tuple                         # tensors read in place
    staged: tuple                       # device buffers of staged inputs
    forward: Optional[_Graph] = None    # the region (or its forward)
    backward: Optional[_Graph] = None   # a differentiable region's backward
    outputs: Any = None                 # the forward's static outputs
    body_pool: Optional[tuple] = None   # the IF nodes' bodies' memory
    # a differentiable region: the static cotangents of the outputs that
    # require grad (by index) and the backward's static gradients of the
    # staged buffers and held tensors that require grad (None where one
    # takes none)
    cot_index: tuple = ()
    cotangents: tuple = ()
    grads: tuple = ()
    #: the context of the replayed forward whose backward has not run
    pending: Optional[weakref.ref] = None
    #: forward replays so far: a backward of an older one finds its
    #: residuals overwritten
    generation: int = 0
    #: the entry point's name (the key's first part)
    name: str = ""
    #: its counters (:func:`counter`), by (what, shape, device)
    counters: Dict[tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict)


_CACHE: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
#: calls of :func:`run` on a CUDA device so far, by what they did: the
#: eager warm-up of a new key, a capture (followed by its first replay),
#: a replay (captures included); the IF nodes that the captures made
#: (one per conditional segment); the IF nodes' bodies that ran and that
#: were skipped in the last replay of each key that :func:`count_bodies`
#: counted; and of differentiable regions, the captures and replays of
#: the backward graph and the forwards run eagerly by the pending rule;
#: the keys evicted
COUNTS = {"warm_ups": 0, "captures": 0, "replays": 0, "if_nodes": 0,
          "bodies_run": 0, "bodies_skipped": 0, "backward_captures": 0,
          "backward_replays": 0, "pending_eager": 0, "evictions": 0}
#: host seconds of set-up so far: the warm-ups (a key's eager first call)
#: and the captures (a differentiable region's two), each to a
#: synchronise of its device. No replay adds to them.
SECONDS = {"warm_up": 0.0, "capture": 0.0}
#: the regions' host-side counts so far (:func:`tally`), by name
TALLIES: Dict[str, int] = collections.Counter()
_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
#: the streams that IF nodes' bodies are captured on
_BODY_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
#: the capture in progress in :func:`run`, else None
_RECORDING: Optional[_Recording] = None
#: graphs replayed since :func:`count_bodies` last ran that hold IF nodes
_UNCOUNTED: Dict[int, _Graph] = {}
#: the sites of the IF nodes whose bodies are being recorded, innermost
#: last
_BODY_SITES: List[str] = []
_disabled = 0
#: the counters of the calls run eagerly, by entry point's name
_EAGER_COUNTERS: Dict[str, Dict[tuple, torch.Tensor]] = {}
#: the counters of the calls whose regions run now, innermost last
_OWNERS: List[Dict[tuple, torch.Tensor]] = []


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
    return sum(e.forward is not None for e in _CACHE.values())


def clear() -> None:
    """Drop every key, releasing its graph and pool, and every counter."""
    while _CACHE:
        _release(_CACHE.popitem(last=False)[1])
    _EAGER_COUNTERS.clear()


@contextlib.contextmanager
def _owning(counters: Dict[tuple, torch.Tensor]):
    """The block's regions keep their counters in ``counters``."""
    _OWNERS.append(counters)
    try:
        yield
    finally:
        _OWNERS.pop()


def counter(what: str, shape: tuple, device) -> Optional[torch.Tensor]:
    """The int64 tensor ``what`` of ``shape`` on ``device`` that the call
    of :func:`run` whose region runs now owns (zeros when first asked
    for), for the region's kernels to add to in place; None outside
    every region. A key asks for its counters at its warm-up, so a
    capture finds them made and its graph adds to them on every
    replay."""
    if not _OWNERS:
        return None
    device = torch.device(device)
    k = (what, tuple(shape), device)
    held = _OWNERS[-1]
    if k not in held:
        held[k] = torch.zeros(shape, dtype=torch.int64, device=device)
    return held[k]


def counters(name: str, what: str) -> List[torch.Tensor]:
    """Every counter ``what`` that the calls of the entry point ``name``
    keep: each cached key's and the eager calls'."""
    sets = [e.counters for e in _CACHE.values() if e.name == name]
    sets.append(_EAGER_COUNTERS.get(name, {}))
    return [t for held in sets for (w, _, _), t in held.items() if w == what]


def _release(entry: _Entry) -> None:
    for g in (entry.forward, entry.backward):
        if g is not None:
            g.graph.reset()
            _UNCOUNTED.pop(id(g), None)
    if entry.body_pool is not None:
        torch._C._cuda_releasePool(entry.device.index, entry.body_pool)
    entry.forward = entry.backward = entry.outputs = entry.body_pool = None
    entry.cotangents = entry.grads = ()
    entry.pending = None


def _pending(entry: _Entry) -> bool:
    """Does the last replayed forward of a differentiable entry still
    await its backward (its output alive, its backward not run)?"""
    return entry.pending is not None and entry.pending() is not None


def _evict() -> None:
    """Release the least recently used keys until one more fits, passing
    over every entry with a pending backward."""
    for key in list(_CACHE):
        if len(_CACHE) < MAX_GRAPHS:
            return
        if not _pending(_CACHE[key]):
            with span("graphs.evict", key[0]):
                _release(_CACHE.pop(key))
            COUNTS["evictions"] += 1


def nodes(label: str) -> int:
    """The nodes of the captured graph of the entry point ``label`` (a
    differentiable region's backward graph: ``"<name> (backward)"``, the
    name its launch span carries) used last: its nodes outside IF nodes,
    each IF node one, plus every IF node's body's nodes, whether a replay
    runs the body or not. 0 where no such graph is captured."""
    for entry in reversed(_CACHE.values()):
        for g in (entry.forward, entry.backward):
            if g is not None and g.label == label:
                return g.nodes + sum(b.nodes for b in g.bodies)
    return 0


def tally(name: str) -> None:
    """Add one to the host-side count ``name`` (:data:`TALLIES`); under a
    capture, to what each replay of the graph adds to it."""
    TALLIES[name] += 1


def tallies(label: str) -> Dict[str, int]:
    """What one replay of the captured graph of the entry point ``label``
    (as :func:`nodes` names it) used last adds to :data:`TALLIES`; empty
    where no such graph is captured."""
    for entry in reversed(_CACHE.values()):
        for g in (entry.forward, entry.backward):
            if g is not None and g.label == label:
                return dict(g.tallies)
    return {}


@contextlib.contextmanager
def _set_up(kind: str, name: str, device: torch.device):
    """The block as set-up of ``kind`` ("warm_up" or "capture") of the
    entry point ``name``: a span, and its host seconds to a synchronise
    of ``device`` added to :data:`SECONDS` (not where it raises)."""
    t0 = time.perf_counter()
    with span("graphs." + kind, name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    SECONDS[kind] += time.perf_counter() - t0


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
             staged: Sequence[torch.Tensor], group=None,
             records_grad: bool = False) -> tuple:
    """The cache key of a call of :func:`run` (see the module docstring);
    of a process group it records the backend, this rank's index, the
    size and the group object; of a call that records autograd, which
    staged and held inputs require grad."""
    return (name, static, tuple(tensor_key(t) for t in held),
            tuple((tuple(s.shape), s.dtype) for s in staged),
            (tuple(s.requires_grad for s in staged),
             tuple(t.requires_grad for t in held)) if records_grad else None,
            None if group is None else (
                dist.get_backend(group), dist.get_rank(group),
                dist.get_world_size(group), group))


def runs_eagerly(device, group=None) -> bool:
    """Does :func:`run` call its region eagerly, whatever the key? On the
    CPU, inside :func:`disable_graphs`, and for a process group whose
    backend is not NCCL (its collectives cannot be captured)."""
    return (torch.device(device).type != "cuda" or _disabled > 0
            or (group is not None and dist.get_backend(group) != "nccl"))


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
    ``records_grad`` whether the caller's autograd records the call: then
    ``fn`` returns a tensor or a tuple of tensors, and the call replays a
    forward and a backward graph joined by one autograd Function
    (differentiable in the staged and held inputs that require grad).
    Where :func:`runs_eagerly` holds, ``fn`` runs eagerly with the staged
    inputs moved to ``device``.
    """
    device = torch.device(device)
    if runs_eagerly(device, group):
        with _owning(_EAGER_COUNTERS.setdefault(name, {})):
            return fn(*(s.to(device) for s in staged))
    with span("graphs.key", name):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = make_key(name, static, held, staged, group, records_grad)
        entry = _CACHE.get(key)
    if entry is None:
        entry = _Entry(device, tuple(held), tuple(
            torch.empty(s.shape, dtype=s.dtype, device=device)
            .requires_grad_(records_grad and s.requires_grad)
            for s in staged), name=name)
        with _set_up("warm_up", name, device), _owning(entry.counters):
            if records_grad:
                # an ordinary autograd result, reaching the caller's inputs
                out = _warm_up(lambda: fn(*(s.to(device) for s in staged)),
                               device)
            else:
                _stage(entry, staged)
                out = _warm_up(lambda: fn(*entry.staged), device)
        COUNTS["warm_ups"] += 1
        _evict()
        _CACHE[key] = entry
        return out
    _CACHE.move_to_end(key)
    if records_grad:
        return _run_grad(name, fn, entry, held, staged, group is not None)
    _stage(entry, staged)
    if entry.forward is None:
        def region():
            entry.outputs = fn(*entry.staged)
        with _set_up("capture", name, device), _owning(entry.counters):
            entry.forward, entry.body_pool = _capture(name, region, device,
                                                      group is not None)
        COUNTS["captures"] += 1
    _replay(entry.forward)
    COUNTS["replays"] += 1
    with span("graphs.clone", name):
        return _clone(entry.outputs)


def _flat(outputs) -> tuple:
    return outputs if isinstance(outputs, tuple) else (outputs,)


def _run_grad(name: str, fn: Callable, entry: _Entry, held, staged,
              collective: bool):
    """A call of a differentiable region after its warm-up: eagerly by
    the pending rule, else (capturing both graphs first) a replay of the
    forward through :class:`_Differentiable`, whose gradients reach this
    call's staged and held tensors (the key's addresses: the graphs read
    their memory)."""
    if _pending(entry):
        COUNTS["pending_eager"] += 1
        with _owning(entry.counters):
            return fn(*(s.to(entry.device) for s in staged))
    if entry.forward is None:
        with _set_up("capture", name, entry.device), _owning(entry.counters):
            _capture_grad(name, fn, entry, held, staged, collective)
    return _Differentiable.apply(entry, len(staged), *staged,
                                 *(t for t in held if t.requires_grad))


def _capture_grad(name: str, fn: Callable, entry: _Entry, held, staged,
                  collective: bool) -> None:
    """Capture a differentiable region's forward, then its backward in
    the forward's memory pool, their IF nodes' bodies sharing one pool.
    The backward differentiates with respect to the tensors that this
    call's ``fn`` reads, held from then on. Either failure releases both
    and raises."""
    _stage(entry, staged)
    entry.held = tuple(held)
    inputs = tuple(b for b in entry.staged if b.requires_grad) + tuple(
        t for t in entry.held if t.requires_grad)

    def forward():
        entry.outputs = fn(*entry.staged)

    def backward():
        outs = _flat(entry.outputs)
        # the residuals are kept: the next replay of this graph (a
        # second backward) reads them again
        entry.grads = torch.autograd.grad(
            [outs[i] for i in entry.cot_index], inputs, entry.cotangents,
            retain_graph=True, allow_unused=True)

    try:
        entry.forward, entry.body_pool = _capture(
            f"{name} (forward)", forward, entry.device, collective,
            label=name)
        outs = _flat(entry.outputs)
        entry.cot_index = tuple(i for i, o in enumerate(outs)
                                if o.requires_grad)
        entry.cotangents = tuple(torch.zeros_like(outs[i])
                                 for i in entry.cot_index)
        entry.backward, entry.body_pool = _capture(
            f"{name} (backward)", backward, entry.device, collective,
            pool=entry.forward.graph.pool(), body_pool=entry.body_pool,
            label=f"{name} (backward)")
    except GraphCaptureError:
        _release(entry)
        raise
    COUNTS["captures"] += 1
    COUNTS["backward_captures"] += 1


class _Differentiable(torch.autograd.Function):
    """A differentiable region's replays: ``apply(entry, n_staged,
    *staged, *held that require grad)`` stages the inputs, replays the
    forward graph and returns clones of its outputs; the backward copies
    the cotangents into the entry's buffers, replays the backward graph
    and returns clones of the gradients (None where an input takes
    none), each on its input's device."""

    @staticmethod
    def forward(ctx, entry: _Entry, n_staged: int, *inputs):
        _stage(entry, inputs[:n_staged])
        _replay(entry.forward)
        COUNTS["replays"] += 1
        entry.generation += 1
        entry.pending = weakref.ref(ctx)
        ctx.entry, ctx.generation = entry, entry.generation
        ctx.devices = [x.device for x in inputs]
        with span("graphs.clone", entry.name):
            return _clone(entry.outputs)

    @staticmethod
    def backward(ctx, *cots):
        entry = ctx.entry
        if torch.is_grad_enabled():
            raise RuntimeError(
                "a graphed differentiable region has no double backward "
                "(create_graph=True); run it under disable_graphs()")
        if entry.backward is None or ctx.generation != entry.generation:
            raise RuntimeError(
                "the backward graph of this output's forward was released "
                "or a later forward of its key has replayed over its "
                "residuals: a second backward (retain_graph=True) must "
                "come before the key's next call")
        with span("graphs.stage", entry.backward.label):
            for buf, i in zip(entry.cotangents, entry.cot_index):
                buf.copy_(cots[i])
        _replay(entry.backward)
        COUNTS["backward_replays"] += 1
        entry.pending = None
        # the key holds which inputs require grad: entry.grads follows
        # the inputs that do, in order
        grads = iter(entry.grads)
        out = [None, None]
        with span("graphs.clone", entry.backward.label):
            for takes, device in zip(ctx.needs_input_grad[2:], ctx.devices):
                g = next(grads) if takes else None
                out.append(None if g is None else g.to(device, copy=True))
        return tuple(out)


def count_bodies() -> Tuple[int, int]:
    """Add to ``LAUNCHES`` the launches of the IF nodes' bodies that ran
    in the last replay of each graph replayed since the last call, and
    return how many bodies ran and were skipped there (also added to
    :data:`COUNTS`). It synchronises the card and reads each body's
    condition, so it is never called on a replay's path."""
    ran = skipped = 0
    for g in _UNCOUNTED.values():
        torch.cuda.synchronize(g.bodies[0].pred.device)
        taken = torch.stack([b.pred for b in g.bodies]).tolist()
        for body, took in zip(g.bodies, taken):
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
    captured graph (of the entry point ``name`` only, if given), in
    capture order, a differentiable region's forward before its
    backward. It synchronises the card and reads each body's condition,
    so it is never called on a replay's path."""
    out = []
    for key, entry in _CACHE.items():
        for g in (entry.forward, entry.backward):
            if g is not None and g.bodies and (name is None
                                               or key[0] == name):
                torch.cuda.synchronize(g.bodies[0].pred.device)
                taken = torch.stack([b.pred for b in g.bodies]).tolist()
                out += [(b.site, took) for b, took in zip(g.bodies, taken)]
    return out


def _stage(entry: _Entry, staged) -> None:
    """Copy each staged input into its buffer, on the current stream
    (ordered after the last replay that read the buffer)."""
    with span("graphs.stage", entry.name), torch.no_grad():
        for buf, src in zip(entry.staged, staged):
            buf.copy_(src, non_blocking=True)


def _stream(streams: dict, device: torch.device) -> torch.cuda.Stream:
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _warm_up(call: Callable, device: torch.device):
    """``call()``, the eager first call of a key, on a side stream."""
    cur = torch.cuda.current_stream(device)
    side = _stream(_SIDE_STREAMS, device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = call()
    cur.wait_stream(side)
    return out


def _replay(g: _Graph) -> None:
    with span("graphs.launch", g.label):
        g.graph.replay()
        for k, n in g.launches.items():
            _build.LAUNCHES[k] += n
        for k, n in g.tallies.items():
            TALLIES[k] += n
        if g.bodies:
            _UNCOUNTED[id(g)] = g


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


def _record(region: Callable[[], None], pool, mode: str):
    """``region()`` captured into a new CUDA graph (in the memory pool
    ``pool``, a new one if None), ended by the device mark ``end``; the
    graph's nodes go to the recording."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
        region()
        rec = _RECORDING
        profiling.mark("end", rec.device)
        rec.nodes = _capture_nodes(torch.cuda.current_stream(rec.device))
    return graph


def _capture_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes of the graph that ``stream`` is capturing, so far
    (``csrc/graph_cond.cu``)."""
    lib = _build.library()
    n = ctypes.c_size_t(0)
    err = lib.mrt_capture_nodes(stream.cuda_stream, ctypes.addressof(n))
    if err:
        raise RuntimeError(f"counting a capture's nodes: CUDA error {err}: "
                           f"{lib.mrt_error_string(err).decode()}")
    return int(n.value)


def _capture(name: str, region: Callable[[], None], device: torch.device,
             collective: bool = False, pool=None,
             body_pool: Optional[tuple] = None, label: Optional[str] = None
             ) -> Tuple[_Graph, Optional[tuple]]:
    """Capture ``region()`` (which stores its results in the entry) ->
    (the graph, the IF nodes' bodies' pool: ``body_pool`` or one made
    here, or None). The launches its kernel wrappers count during the
    capture outside IF nodes become the count of one replay, those inside
    each node its body's count. ``label`` (``name`` by default) names the
    graph's launch span and :func:`nodes`. A region with a ``collective`` is
    captured in the thread-local mode: the process group's watchdog
    thread queries the events of eager collectives (a warm-up's
    all-reduce, a checkpoint's barrier), which under the global mode
    could invalidate the capture from that thread."""
    global _RECORDING
    before = dict(_build.LAUNCHES)
    before_tallies = collections.Counter(TALLIES)
    rec = _RECORDING = _Recording(device, body_pool)
    try:
        graph = _record(region, pool,
                        "thread_local" if collective else "global")
    except Exception as e:
        if rec.pool is not None and rec.pool is not body_pool:
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
        tallied = {k: v - before_tallies[k] for k, v in TALLIES.items()
                   if v != before_tallies[k]}
        TALLIES.clear()
        TALLIES.update(before_tallies)
    COUNTS["if_nodes"] += len(rec.bodies)
    return _Graph(graph, {k: v for k, v in counted.items() if v},
                  rec.bodies, rec.nodes,
                  name if label is None else label, tallied), rec.pool


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
    which the bodies of one entry's graphs share (a differentiable
    region's backward bodies read the residuals its forward bodies keep)
    and which lives as long as the entry, so it must copy every result
    that later nodes read into a tensor allocated before the node. Its launches are counted apart
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
            count = _capture_nodes(body_stream)
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
    rec.bodies.append(_Body(pred, launched, site, count))


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
