"""Wavefront Whitted integrator over the fused kernel pipeline (torch).

Counterpart of ``myraytracer_tpu/ops/tracer.py``. Every Whitted segment
runs once over the whole flat ray batch (:func:`segment_step`):

  closest hit  the dense analytic tests (spheres, then planes, then
               cylinders; K8, ops/cuda_analytic.py), then triangles by
               ``TraceConfig.tri_method``, merged in that order with
               strict <
  pre kernel   K3: per-kind hit resolve, atlas index, light-major
               shadow batch
  any hit      the triangle method's occlusion query OR-ed with the
               dense analytic occlusion (K8's any-hit mode)
  phong kernel K4: lighting with the texel override, blend, bounce.

The triangle methods: ``"cluster"`` (the default) is the cluster scan
(K2 phase-1 + K1/K1'); ``"bvh"`` the threaded-BVH walk (K7,
ops/traverse.py), the reference's default off the TPU; ``"brute"`` the
all-triangle oracle (torch ops). K3 and K4 shade the hits of every
method. The reference refuses its fused Pallas shading unless the method
is "cluster" (its ``resolved_fused_shade``) only because that pipeline
was built around the cluster megakernel; its own tests show the three
methods' images equal within 1e-5 and the fused and XLA shading equal.

One loop (:func:`_segments`) runs the forward segments of :func:`trace`
and :func:`trace_topology`; the topology asks it for each segment's
record (which primitive each ray hit, live hit, live miss, the shadow
mask per light), :func:`trace` does not and forms none. The training
step splits the chain in two: :func:`trace_topology` records without
gradients, :func:`trace_shade` replays the differentiable shading on
that fixed topology, with no traversal. :func:`trace` takes both passes
where K3/K4 differ from the reference's XLA shading: when autograd
records the call, and for the bilinear texel fetch on a textured scene
(:func:`replays`). :func:`trace_shade` takes its route from one table,
:data:`ROUTES`, under the name :meth:`TraceConfig.replay_route` gives by
the scene's primitive kinds, textures and lights: the fused K5/K6
segment (ops/shade_grad.py) on triangles alone, exactly where the
reference's ``resolved_fused_shade_grad`` would; the fused K10/K11
segment (ops/shade_grad_ana.py) on spheres and planes alone; both side
by side on triangles beside spheres or planes, K5/K6 on the triangle
hits and K10/K11 on the others; else (cylinders, textures, no light)
the autograd replay of ``shade.resolve_hit`` + :func:`lighting_from_mask`.
A choice by scene content, not a fallback: each fused segment covers its
kinds whole and computes what the autograd replay computes.

A segment in which no ray is alive any more yields its carry unchanged,
as the reference's ``lax.cond`` does. The condition is a 0-d tensor on
the device, so no segment reads a value back to the host and the entry
points can be captured as CUDA graphs (ops/graphs.py). Under a capture
the loop's segments 1.. are branches (:func:`_branch`): each runs under
a CUDA-graph IF node and writes the carry, and any record, in place, so
a replay skips a dead segment's work as ``lax.cond`` does. Segments 1..
of :func:`trace_shade` are :class:`_CondSegment`, an autograd Function
whose forward and backward each run under an IF node on the segment's
``(hit | miss).any()``: the VJP of ``lax.cond`` is a cond too, so a dead
segment costs nothing in a training step either. Run eagerly (the CPU,
a key's warm-up, ``disable_graphs()``, the sharded paths), a segment
runs and a ``torch.where`` keeps or drops its result (:func:`_select`),
and so do the backward's cotangents. Segment 0 of a fresh carry has
every ray alive (weight 1), so it takes neither.

Segment counters: inside an entry point's region (``graphs.run``), K3
adds to the region's int64 [S, 3] counters (``graphs.counter``
"tracer.segments") the rays that enter segment s alive and, where the
segment's condition holds (segment 0 always), one body run and its
rays: on the card within its own launch, so a replay counts with no
node of its own, on the CPU in the plain version. A skipped body counts
nothing; a segment run eagerly while no ray is alive counts no live ray
and no body, as the replay would. :func:`live_rays`,
:func:`segments_run` and :func:`rays_run` read them per entry point
(``render``, ``aa_refine``, ...), with a synchronise: after a call,
never on its path. The triangle walks of segments 1.. walk a list of
their live rays alone and count it the same way (ops/traverse.py
``walk.list``, ``listed_rays``).

Device phase marks (utils/profiling.mark) split a segment's device time:
``segment`` at its start (inside an IF node's body for segments 1..,
so a skipped segment leaves no mark), ``analytic`` before the dense
analytic tests, ``tri`` before each triangle query of segment 0 and
``tri.bounce`` before each of a later segment (the reflected rays' walks
apart from the primary rays'), ``shade`` before K3, K4, K5 or K10, and
``shade.autograd`` before the autograd replay's forward (its row gathers
and lighting apart from the topology's K3/K4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch.autograd.function import once_differentiable

from myraytracer_tpu_torch.ops import cuda_analytic as ca
from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import intersect as isx
from myraytracer_tpu_torch.ops import row_sum
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops import shade_grad_ana as sga
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.utils import vecmath as vm
from myraytracer_tpu_torch.utils.profiling import mark

#: rays x primitives per step of the plain dense analytic tests: bounds
#: their [rays, P, 3] temporaries to 192 MB each
ANA_BUDGET = 1 << 24


#: the triangle methods of TraceConfig.tri_method ("auto" resolves to
#: one of the others)
TRI_METHODS = ("auto", "cluster", "bvh", "brute")

#: the texture fetches of TraceConfig.texture_filter
TEXTURE_FILTERS = ("nearest", "bilinear")


class TraceConfig(NamedTuple):
    """Options of the integrator: the reference's TraceConfig reduced to
    what the fused path reads."""

    #: triangle intersection: "cluster" (the cluster scan, K2 + K1),
    #: "bvh" (the threaded-BVH walk, K7), "brute" (every triangle, the
    #: oracle) or "auto", which resolves to "bvh" as the reference's does
    #: off the TPU (:meth:`resolved_method`). The port's default stays
    #: "cluster", the method every recorded number was measured on;
    #: whether the default should be "bvh" is for the card's numbers of
    #: both to decide (PERF.md).
    tri_method: str = "cluster"
    #: the texel fetch: "nearest" or "bilinear" (differentiable in the
    #: texels and the UVs). The replay route (:func:`trace_shade`, which
    #: :func:`trace` takes for "bilinear" on a textured scene) honours
    #: it; K3/K4 always take the nearest texel, so the forward-only entry
    #: points (``render(clamp=True)``, ``render_aa``, the sharded
    #: forwards) set "nearest", as the reference's ``fused_shade=True``.
    texture_filter: str = "nearest"
    #: run the plain PyTorch versions of the kernels, on any device
    #: (compares the kernels with them on the card)
    plain: bool = False
    #: trace_shade replays each segment through a fused segment, K5/K6 or
    #: K10/K11 by the scene's kinds (True), or as an autograd replay of
    #: resolve_hit + lighting_from_mask (False, the reference's default).
    #: The reference keeps the fused segment opt-in because a Pallas
    #: boundary re-lays out ~30 per-ray columns on the TPU; on the GPU a
    #: thread reads its row by id.
    fused_shade_grad: bool = True
    #: phase-1 of the cluster scans: None keeps the segment hull for
    #: finite any-hit queries; "exact" sends them through K2 too. The AA
    #: refine sets "exact": its screen-scattered subray bundles make the
    #: hulls loose.
    phase1: Optional[str] = None

    def validate(self) -> "TraceConfig":
        """Raise ValueError for a method or filter the port does not take."""
        if self.tri_method not in TRI_METHODS:
            raise ValueError(f"tri_method must be one of {TRI_METHODS}, not "
                             f"{self.tri_method!r}")
        if self.texture_filter not in TEXTURE_FILTERS:
            raise ValueError(f"texture_filter must be one of "
                             f"{TEXTURE_FILTERS}, not {self.texture_filter!r}")
        return self

    def resolved_method(self) -> str:
        """The triangle method that runs: "auto" is "bvh"."""
        return "bvh" if self.tri_method == "auto" else self.tri_method

    def replay_route(self, scene) -> str:
        """The route of :func:`trace_shade` on ``scene`` (a key of
        :data:`ROUTES`), by its primitive kinds, textures and lights;
        each segment it runs adds one to its host tallies
        (``graphs.tally``, :class:`_Route`). With ``fused_shade_grad``,
        a light, no texture and no cylinder: ``"fused_tri"`` (K5/K6, the
        reference's ``resolved_fused_shade_grad``) for triangles alone,
        ``"fused_ana"`` (K10/K11) for spheres or planes alone,
        ``"fused_mixed"`` (both) for triangles beside spheres or planes.
        ``"autograd"`` (the autograd replay) otherwise."""
        if not (self.fused_shade_grad and scene.n_lights >= 1
                and not scene.has_textures) or scene.n_cylinders:
            return "autograd"
        ana = bool(scene.n_spheres or scene.n_planes)
        if scene.n_tris:
            return "fused_mixed" if ana else "fused_tri"
        return "fused_ana" if ana else "autograd"


class Bounce(NamedTuple):
    """Per-ray state carried from one Whitted segment to the next."""

    o: torch.Tensor       # [R, 3]
    d: torch.Tensor       # [R, 3]
    weight: torch.Tensor  # [R]; 0 = dead
    color: torch.Tensor   # [R, 3] accumulated linear color


class TracePack(NamedTuple):
    """Scene tables the segments read, packed once per render."""

    cl_rows: Optional[torch.Tensor]   # [K, M, 16] for "cluster", else None
    tri_flat: Optional[torch.Tensor]  # [T, 16] for "bvh"/"brute", else None
    geom: shade.ShadeGeom             # tri_pack, mat16, ana16
    env: torch.Tensor                 # [6] ambience, background


def pack_trace(scene, cfg: TraceConfig = TraceConfig()) -> TracePack:
    """Pack the tables :func:`segment_step` reads (once per render): the
    triangle-major cluster constants for "cluster", the corner rows of the
    current vertices for "bvh" and "brute"."""
    method = cfg.validate().resolved_method()
    cl_rows = tri_flat = None
    if scene.n_tris:
        if method == "cluster":
            cl_rows = cc.pack_cluster_rows(scene).detach()
        else:
            tri_flat = trv.pack_tri_vertices(scene).detach().contiguous()
    return TracePack(
        cl_rows=cl_rows, tri_flat=tri_flat,
        geom=shade.pack_shade_geom(scene, cfg.plain),
        env=torch.cat([scene.ambience, scene.background]).contiguous())


def _analytic_kinds(scene):
    """(kind, count, t(o, d) -> [N, count]) per analytic kind present, in
    merge order: spheres, planes, cylinders."""
    sc = scene
    out = []
    if sc.n_spheres:
        out.append((shade.KIND_SPHERE, sc.n_spheres, lambda o, d: (
            isx.ray_sphere(o[:, None], d[:, None], sc.sphere_center[None],
                           sc.sphere_radius[None]))))
    if sc.n_planes:
        out.append((shade.KIND_PLANE, sc.n_planes, lambda o, d: (
            isx.ray_plane(o[:, None], d[:, None], sc.plane_center[None],
                          sc.plane_normal[None]))))
    if sc.n_cylinders:
        out.append((shade.KIND_CYL, sc.n_cylinders, lambda o, d: (
            isx.ray_cylinder(o[:, None], d[:, None], sc.cyl_center[None],
                             sc.cyl_axis[None], sc.cyl_radius[None],
                             sc.cyl_height[None]))))
    return out


def _ray_steps(scene, n: int):
    """Ray slices of the dense analytic tests (ANA_BUDGET bounds each)."""
    prims = scene.n_spheres + scene.n_planes + scene.n_cylinders
    step = max(1, ANA_BUDGET // max(prims, 1))
    return [slice(i, i + step) for i in range(0, n, step)]


def _counts(scene) -> tuple:
    """(spheres, planes, cylinders): the ana16 rows of each kind."""
    return scene.n_spheres, scene.n_planes, scene.n_cylinders


def _closest_analytic(scene, o, d, ana16=None, plain: bool = False):
    """Closest sphere/plane/cylinder hit of each ray.

    Returns (kind [R] i32, idx [R] i32 per-kind index, aidx [R] i32 row
    of ShadeGeom.ana16, t [R]); KIND_MISS, 0, 0 and INF where no analytic
    primitive is hit. The kinds merge in the order sphere, plane,
    cylinder with strict <, and each kind's argmin takes the first
    minimum, so exact ties resolve as in the reference.

    CUDA tensors launch K8 (ops/cuda_analytic.py) on ``ana16``, the
    scene's ShadeGeom.ana16 (packed here when None); CPU tensors and
    ``plain`` run :func:`_closest_analytic_plain`, as does a scene
    without an analytic primitive, which launches nothing.
    """
    if plain or o.device.type == "cpu" or not shade.has_analytic(scene):
        return _closest_analytic_plain(scene, o, d)
    mark("analytic", o.device)
    if ana16 is None:
        ana16 = shade.pack_ana16(scene)
    return ca.closest_analytic(o.detach().contiguous(),
                               d.detach().contiguous(), ana16.detach(),
                               _counts(scene))


def _closest_analytic_plain(scene, o, d):
    """The plain version of :func:`_closest_analytic`: each kind one dense
    [R, P] test in ray slices of ANA_BUDGET pairs, merged with strict <."""
    R = o.shape[0]
    kind = torch.full((R,), shade.KIND_MISS, dtype=torch.int32, device=o.device)
    idx = torch.zeros(R, dtype=torch.int32, device=o.device)
    aidx = torch.zeros(R, dtype=torch.int32, device=o.device)
    best_t = torch.full((R,), INF, device=o.device)
    kinds = _analytic_kinds(scene)
    if not kinds:
        return kind, idx, aidx, best_t
    mark("analytic", o.device)
    for sl in _ray_steps(scene, R):
        a_off = 0
        for k, n, fn in kinds:
            t_all = fn(o[sl], d[sl])                                # [N, n]
            t_k, i_k = torch.min(t_all, dim=1)
            i_k = i_k.to(torch.int32)
            better = t_k < best_t[sl]
            best_t[sl] = torch.where(better, t_k, best_t[sl])
            kind[sl] = torch.where(better, k, kind[sl])
            idx[sl] = torch.where(better, i_k, idx[sl])
            aidx[sl] = torch.where(better, i_k + a_off, aidx[sl])
            a_off += n
    return kind, idx, aidx, best_t


def _analytic_occlusion(scene, o, d, dist, cast=None, ana16=None,
                        plain: bool = False):
    """Does any analytic primitive occlude o -> o + dist d? [N] bool.

    o, d [N, 3] or [N, 4] (xyz first); shadowed iff some primitive's t
    (INF on a miss) is below dist. With ``cast`` [N] bool, only where it
    holds (the rest False). CUDA tensors launch K8's any-hit mode on
    ``ana16`` (packed here when None), which stops a ray at its first
    occluder and skips a ray that does not cast; CPU tensors and
    ``plain`` run :func:`_analytic_occlusion_plain`.
    """
    if plain or o.device.type == "cpu" or not shade.has_analytic(scene):
        occ = _analytic_occlusion_plain(scene, o[:, :3], d[:, :3], dist)
        return occ if cast is None else cast & occ
    mark("analytic", o.device)
    if ana16 is None:
        ana16 = shade.pack_ana16(scene)
    return ca.analytic_anyhit(o.detach().contiguous(),
                              d.detach().contiguous(),
                              dist.detach().contiguous(), cast,
                              ana16.detach(), _counts(scene))


def _analytic_occlusion_plain(scene, o, d, dist):
    """The plain version of :func:`_analytic_occlusion` (without
    ``cast``): each kind is one dense [N, P] test: shadowed iff any
    t < dist."""
    shadowed = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    kinds = _analytic_kinds(scene)
    if kinds:
        mark("analytic", o.device)
    for sl in (_ray_steps(scene, o.shape[0]) if kinds else ()):
        for _, _, fn in kinds:
            shadowed[sl] |= (fn(o[sl], d[sl]) < dist[sl, None]).any(dim=1)
    return shadowed


class TraceTopo(NamedTuple):
    """Per-segment discrete trace topology (no gradients).

    Shapes: [S, R] for kind/idx/hit/miss, [S, L, R] for shadow, where S
    is the scene's number of Whitted segments.
    """

    kind: torch.Tensor    # i32 hit kind (KIND_MISS for dead rays)
    idx: torch.Tensor     # i32 triangle id (0 on a miss)
    hit: torch.Tensor     # bool live hit
    miss: torch.Tensor    # bool live miss
    shadow: torch.Tensor  # bool occluded, per light


def closest_hit(scene, pack: TracePack, o, d, live,
                cfg: TraceConfig = TraceConfig(), seg: int = 0):
    """Closest hit of each ray over every primitive kind in segment ``seg``.

    Analytic kinds first, triangles (``cfg.tri_method``) last, merged
    with strict <. Returns (kind [R] i32, KIND_MISS for dead rays; pidx
    [R] i32 the per-kind index; aidx [R] i32 the ana16 row of the
    closest analytic primitive; t [R], INF on a miss).
    """
    kind, pidx, aidx, t = _closest_analytic(scene, o, d, pack.geom.ana16,
                                            cfg.plain)
    if scene.n_tris:
        tri = _tri_query(scene, pack, o, d, live, cfg, seg=seg)
        better = tri.t < t
        kind = torch.where(better, shade.KIND_TRI, kind)
        pidx = torch.where(better, torch.clamp(tri.idx, min=0), pidx)
        t = torch.where(better, tri.t, t)
    kind = torch.where(live, kind, shade.KIND_MISS).to(torch.int32)
    return kind, pidx, aidx, t


def _tri_query(scene, pack: TracePack, o, d, active, cfg: TraceConfig,
               t_max=None, any_hit: bool = False, seg: int = 0
               ) -> trv.TriHit:
    """The one triangle query of a segment, by ``cfg.resolved_method()``,
    marked ``tri`` in segment 0 and ``tri.bounce`` in a later ``seg``.
    The walk of a later segment walks a list of its active rays alone
    (``traverse_bvh(listed=True)``): segment 0's closest query has every
    ray live, so it launches over the batch as it is.

    "brute" has no any-hit mode and no mask: it answers occlusion as the
    reference's ``_closest_tris`` does, with a closest query below
    ``t_max`` (idx >= 0 means occluded), masked here with ``active``.
    """
    if seg:
        mark("tri.bounce", o.device)
    else:
        mark("tri", o.device)
    method = cfg.resolved_method()
    if method == "cluster":
        return cc.intersect_clusters(scene, o, d, t_max=t_max,
                                     any_hit=any_hit, active=active,
                                     cl_rows=pack.cl_rows, plain=cfg.plain,
                                     phase1=cfg.phase1)
    if method == "bvh":
        return trv.traverse_bvh(scene, o, d, t_max=t_max, any_hit=any_hit,
                                active=active, tri_flat=pack.tri_flat,
                                plain=cfg.plain, listed=seg > 0)
    hit = trv.intersect_tris_brute(scene, o, d, t_max=t_max,
                                   tri_flat=pack.tri_flat)
    if active is None:
        return hit
    return trv.TriHit(torch.where(active, hit.idx, -1),
                      torch.where(active, hit.t, INF))


def shadow_mask(scene, pack: TracePack, so, sd, st, sact,
                cfg: TraceConfig = TraceConfig(), seg: int = 0
                ) -> torch.Tensor:
    """Occlusion of K3's light-major shadow batch of segment ``seg`` ->
    [L*R] i32.

    The triangle method's occlusion query OR-ed with the dense analytic
    occlusion, both for the active shadow rays only.
    """
    cast = sact > 0
    shadow = torch.zeros_like(cast)
    if scene.n_tris and cast.numel():
        occ = _tri_query(scene, pack, so, sd, cast, cfg, t_max=st,
                         any_hit=True, seg=seg)
        shadow = occ.idx >= 0
    if shade.has_analytic(scene):
        shadow = shadow | _analytic_occlusion(scene, so, sd, st, cast,
                                              pack.geom.ana16, cfg.plain)
    return shadow.to(torch.int32)


#: the columns of a segment's counters: the rays that enter it alive, the
#: bodies of it that ran, the rays of those bodies
LIVE, RAN, RAYS = 0, 1, 2
#: what the counters are called in their region (graphs.counter)
COUNTERS = "tracer.segments"


def segment_step(scene, pack: TracePack, carry: Bounce,
                 cfg: TraceConfig = TraceConfig(), seg: int = 0,
                 cond: Optional[torch.Tensor] = None, record: bool = True):
    """One Whitted segment -> (next bounce with its color added, the
    segment's topology record (kind, idx, hit, miss, shadow), or ``()``
    without ``record``, which forms none).

    ``seg`` is the segment's index and ``cond`` its condition (None for
    segment 0, else the 0-d bool ``(weight > 0).any()`` of the carry):
    K3 counts the segment in the counters of the region that runs it."""
    mark("segment", carry.o.device)
    R = carry.o.shape[0]
    L = scene.n_lights
    live = carry.weight > 0.0
    o = carry.o.contiguous()
    d = carry.d.contiguous()

    kind, pidx, aidx, t = closest_hit(scene, pack, o, d, live, cfg, seg)
    valid = kind != shade.KIND_MISS
    zero_i = torch.zeros_like(pidx)
    idx = torch.where(valid, pidx, zero_i) if record else None
    tri_idx = torch.where(kind == shade.KIND_TRI, pidx, zero_i).contiguous()
    live_i = live.to(torch.int32)

    pre = cs.shade_pre_plain if cfg.plain else cs.shade_pre
    geom = pack.geom
    counts = graphs.counter(COUNTERS, (scene.n_segments, 3), o.device)
    mark("shade", o.device)
    point, normal, mid, texid, so, sd, st, sact = pre(
        o, d, t.contiguous(), kind, live_i, tri_idx,
        torch.where(valid, aidx, zero_i).contiguous(), geom.tri_pack,
        geom.ana16, geom.mat16, scene.light_pos, scene.texels.shape[0],
        None if counts is None else counts[seg], cond)

    shadow = shadow_mask(scene, pack, so, sd, st, sact, cfg,
                         seg).reshape(L, R)

    phong = cs.shade_phong_plain if cfg.plain else cs.shade_phong
    mark("shade", o.device)
    add, o2, d2, w2 = phong(
        o, d, carry.weight.contiguous(), valid.to(torch.int32), live_i, mid,
        texid, point, normal, shadow.contiguous(), geom.mat16, scene.texels,
        scene.light_pos, scene.light_color, pack.env)
    rec = (kind, idx, valid, live & ~valid, shadow > 0) if record else ()
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add), rec


def _select(pred: torch.Tensor, new, old):
    """``new`` where the 0-d bool ``pred`` holds, else ``old``, field by
    field: the device-side ``lax.cond`` of a segment. ``new`` and ``old``
    are both a :class:`Bounce` or both a record tuple."""
    out = [torch.where(pred, a, b) for a, b in zip(new, old)]
    return type(old)(*out) if isinstance(old, Bounce) else tuple(out)


def _branch(pred: torch.Tensor, body, bufs, site: str) -> None:
    """The captured ``lax.cond`` of a segment: ``body()``'s tensors are
    copied into ``bufs`` inside a CUDA-graph IF node on the 0-d bool
    ``pred`` (:func:`graphs.if_node`, the seam a test replaces); where
    the node skips, ``bufs`` keep what they held. ``bufs`` are allocated
    before the node, so later nodes read fixed addresses."""
    def run():
        for buf, val in zip(bufs, body()):
            buf.copy_(val)
    graphs.if_node(pred, run, site)


def _branches(scene, device) -> bool:
    """Do segments 1.. run as :func:`_branch` (a graph capture is on)?"""
    return scene.n_segments > 1 and graphs.capturing(device)


def _owned(carry: Bounce) -> Bounce:
    """Copies of segment 0's carry that the branches write in place (never
    the caller's rays)."""
    return Bounce(*(t.clone() for t in carry))


def records_grad(scene, *tensors: torch.Tensor) -> bool:
    """Would autograd record a call on ``scene`` and ``tensors``? Grad
    mode is on and one of them, or a tensor of the scene, requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for t in tensors) or any(
        isinstance(v, torch.Tensor) and v.requires_grad
        for v in (getattr(scene, f.name) for f in dataclasses.fields(scene)))


def replays(scene, o: torch.Tensor, d: torch.Tensor, cfg: TraceConfig
            ) -> bool:
    """Does :func:`trace` take the replay route (:func:`trace_topology`,
    then :func:`trace_shade`)? Where the reference's XLA shading differs
    from K3/K4: autograd records the call (K3/K4 have no VJP), or
    ``cfg`` asks for the bilinear texel fetch on a textured scene (K3/K4
    take the nearest texel). Decided from the arguments, before any
    work."""
    return records_grad(scene, o, d) or (
        cfg.texture_filter == "bilinear" and scene.has_textures)


def trace(scene, o: torch.Tensor, d: torch.Tensor,
          cfg: TraceConfig = TraceConfig(), pack: Optional[TracePack] = None
          ) -> torch.Tensor:
    """Whitted trace of a ray batch -> [R, 3] linear color (unclamped).

    Segment 0 is the primary hit (weight 1); segments 1.. follow the
    mirror chain with weight *= mirror; a miss adds weight * background
    and kills the ray. ``pack`` (:func:`pack_trace`) can be shared by the
    tiles of one render; made in the same grad mode as the call, its
    ``geom`` carries the gradient of the shared rows, so their gather's
    backward runs once.

    Differentiable as the reference's: where :func:`replays` holds, the
    topology of the detached rays is recorded without gradients and
    :func:`trace_shade` replays the shading on it (the fused K5/K6 or
    K10/K11 segment or the autograd replay, by
    :meth:`TraceConfig.replay_route`), with the rays undetached, so
    gradients reach the scene and the rays.
    Else the K3/K4 chain of :func:`segment_step` runs.
    """
    if pack is None:
        pack = pack_trace(scene, cfg)
    if replays(scene, o, d, cfg):
        topo = trace_topology(scene, o.detach(), d.detach(), cfg, pack)
        return trace_shade(scene, o, d, topo, cfg, pack.geom)
    return _segments(scene, o, d, cfg, pack, "trace")[0].color


@torch.no_grad()
def trace_topology(scene, o: torch.Tensor, d: torch.Tensor,
                   cfg: TraceConfig = TraceConfig(),
                   pack: Optional[TracePack] = None) -> TraceTopo:
    """Gradient-free topology pass: the segments of :func:`trace`,
    recording per segment which primitive each ray hit, whether it was a
    live hit or a live miss, and the shadow mask per light. Segments after
    every ray died record no hits (kind KIND_MISS, idx 0, all False), the
    reference's ``dead`` record."""
    if pack is None:
        pack = pack_trace(scene, cfg)
    records = _segments(scene, o, d, cfg, pack, "trace_topology",
                        record=True)[1]
    return TraceTopo(*(torch.stack(x) for x in zip(*records)))


def _segments(scene, o, d, cfg: TraceConfig, pack: TracePack, entry: str,
              record: bool = False) -> tuple:
    """The one loop over the forward segments of :func:`trace` and
    :func:`trace_topology` (``entry``, in the IF nodes' names) -> (the
    last carry, each segment's record, ``()`` each without ``record``).

    Segment 0 runs as it is. Each later segment runs where its condition
    ``(weight > 0).any()`` holds: under a capture as a :func:`_branch`
    into the carry and a record pre-filled :func:`_dead`, eagerly by a
    :func:`_select` against them."""
    R, dev = o.shape[0], o.device
    carry = Bounce(o=o, d=d, weight=torch.ones(R, device=dev),
                   color=torch.zeros((R, 3), device=dev))
    branches = _branches(scene, dev)

    def dead():
        # an eager segment makes it after its step, so that it adds
        # nothing to the step's peak memory; a branch's must exist before
        # the IF node
        return _dead(R, scene.n_lights, dev) if record else ()
    records = []
    for s in range(scene.n_segments):
        alive = (carry.weight > 0.0).any() if s else None

        def step():
            return segment_step(scene, pack, carry, cfg, s, alive, record)
        if s and branches:
            rec = dead()
            # the body's (next carry, record) as one tuple, as the buffers
            _branch(alive, lambda: sum(step(), ()), carry + rec,
                    f"segment {s} of {entry}")
            records.append(rec)
            continue
        nxt, rec = step()
        if s:
            nxt = _select(alive, nxt, carry)
            rec = _select(alive, rec, dead())
        carry = _owned(nxt) if branches else nxt
        records.append(rec)
    return carry, records


def _dead(R: int, L: int, dev) -> tuple:
    """The record of a segment in which no ray is alive (kind KIND_MISS,
    idx 0, no hit, no miss, no shadow): the reference's ``dead``."""
    return (torch.full((R,), shade.KIND_MISS, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros((L, R), dtype=torch.bool, device=dev))


def lighting_from_mask(scene, hit: shade.Hit, view: torch.Tensor,
                       is_shadow: torch.Tensor) -> torch.Tensor:
    """Phong local illumination under a fixed shadow mask [L, R] bool.

    The lighting of the forward with the recorded occlusion as an input:
    the differentiable half of the topology split (occlusion has no
    gradient, so reusing the record changes none).
    """
    color = scene.ambience[None, :] * hit.ambient
    if scene.n_lights == 0:
        return color
    point, normal = hit.point, hit.normal
    l_dir = vm.normalize(scene.light_pos[:, None, :] - point[None])  # [L,R,3]
    diff = torch.clamp(vm.dot(normal[None], l_dir), min=0.0)       # [L, R]
    r = vm.normalize(vm.mirror(l_dir, normal[None]))
    cos_rv = torch.clamp(vm.dot(r, view[None]), min=0.0)
    gate = (diff > 0.0) & (cos_rv > 0.0)
    base = torch.where(gate, cos_rv, 1.0)
    spec = torch.where(gate, torch.pow(base, hit.shininess[None]), 0.0)
    lit = (~is_shadow).to(color.dtype)
    contrib = scene.light_color[:, None, :] * lit[:, :, None] * (
        hit.diffuse[None] * diff[:, :, None]
        + hit.specular[None] * spec[:, :, None])                   # [L,R,3]
    return color + contrib.sum(dim=0)


def _replay_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec,
                    cfg: TraceConfig) -> Bounce:
    """One segment of the autograd replay (the reference's default), with
    ``cfg.texture_filter``'s texel fetch, marked ``shade.autograd``."""
    mark("segment", carry.o.device)
    kind, idx, h, miss, is_shadow = rec
    mark("shade.autograd", carry.o.device)
    hit = shade.resolve_hit(scene, carry.o, carry.d, kind, idx, geom,
                            cfg.texture_filter)
    local = lighting_from_mask(scene, hit, -carry.d, is_shadow)
    w = carry.weight[:, None]
    add = (torch.where(h[:, None], w * (1.0 - hit.mirror[:, None]) * local,
                       0.0)
           + torch.where(miss[:, None], w * scene.background[None, :], 0.0))
    refl = vm.reflect(carry.d, hit.normal)
    o2 = hit.point + shade.EPS_OFFSET * refl
    return Bounce(o=torch.where(h[:, None], o2, carry.o),
                  d=torch.where(h[:, None], refl, carry.d),
                  weight=torch.where(h, carry.weight * hit.mirror, 0.0),
                  color=carry.color + add)


def _fused_rows(scene, rec, dtype) -> tuple:
    """The per-ray inputs of the fused segment besides the carry: (tri_idx,
    is_t, h, miss, lit)."""
    kind, idx, h, miss, is_shadow = rec
    ti = torch.clamp(idx, 0, scene.n_tris - 1).to(torch.int32).contiguous()
    return (ti, (kind == shade.KIND_TRI).contiguous(), h.contiguous(),
            miss.contiguous(), (~is_shadow).to(dtype).contiguous())


def _fused_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec,
                   cfg: TraceConfig) -> Bounce:
    """One segment through the fused K5/K6 segment (ops/shade_grad.py)."""
    mark("segment", carry.o.device)
    ti, is_t, h, miss, lit = _fused_rows(scene, rec, carry.o.dtype)
    mark("shade", carry.o.device)
    add, o2, d2, w2 = sg.ShadeSegment.apply(
        carry.o.contiguous(), carry.d.contiguous(), carry.weight.contiguous(),
        geom.tri_pack, ti, scene.light_pos, scene.light_color,
        scene.ambience, scene.background, is_t, h, miss, lit, cfg.plain)
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add)


def _fused_ana_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec,
                       cfg: TraceConfig) -> Bounce:
    """One segment through the fused K10/K11 segment on sphere and plane
    hits (ops/shade_grad_ana.py), which reads the record as it is."""
    mark("segment", carry.o.device)
    kind, idx, h, miss, is_shadow = rec
    mark("shade", carry.o.device)
    add, o2, d2, w2 = sga.ShadeSegmentAna.apply(
        carry.o.contiguous(), carry.d.contiguous(), carry.weight.contiguous(),
        geom.ana16, geom.mat16, kind.contiguous(), idx.contiguous(),
        h.contiguous(), miss.contiguous(), is_shadow.contiguous(),
        scene.light_pos, scene.light_color, scene.ambience, scene.background,
        (scene.n_spheres, scene.n_planes), cfg.plain)
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add)


def _mixed_geom(scene, geom: shade.ShadeGeom, cfg: TraceConfig
                ) -> shade.ShadeGeom:
    """The rows the ``"fused_mixed"`` route reads: ``geom`` with each
    triangle's material row beside its 32 columns of ``tri_pack``, where
    K5/K6 read it (columns 32:48, as in a triangle-only scene's pack).
    The gather is K12's forward (``row_sum.gather_rows``), so the
    material cotangent that K6 leaves in those columns reaches ``mat16``
    through K12's fixed-order row sum. The mixed pack itself stays 32
    wide: K3/K4 read it in every render."""
    mat = row_sum.gather_rows(geom.mat16, scene.tri_mat, cfg.plain)
    return geom._replace(tri_pack=torch.cat(
        [geom.tri_pack[:, :32], mat], dim=1).contiguous())


def _fused_mixed_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec,
                         cfg: TraceConfig) -> Bounce:
    """One segment through both fused segments (``geom`` from
    :func:`_mixed_geom`): K5/K6 on the triangle hits, K10/K11 on the
    sphere and plane hits and on the live misses (the background term).
    Each passes the other's rays through (no hit: nothing added, the
    carry's ray, weight 0), so the results merge by kind and the merge's
    backward sends each ray's cotangent to the one segment that shaded
    it."""
    mark("segment", carry.o.device)
    kind, idx, _, _, is_shadow = rec
    ti, is_t, h, miss, lit = _fused_rows(scene, rec, carry.o.dtype)
    o, d = carry.o.contiguous(), carry.d.contiguous()
    w = carry.weight.contiguous()
    lights = (scene.light_pos, scene.light_color, scene.ambience,
              scene.background)
    mark("shade", carry.o.device)
    add_t, o_t, d_t, w_t = sg.ShadeSegment.apply(
        o, d, w, geom.tri_pack, ti, *lights, is_t, h & is_t,
        torch.zeros_like(miss), lit, cfg.plain)
    # K10 shades any kind but KIND_MISS: the triangle hits become misses
    add_a, o_a, d_a, w_a = sga.ShadeSegmentAna.apply(
        o, d, w, geom.ana16, geom.mat16,
        torch.where(is_t, shade.KIND_MISS, kind), idx.contiguous(),
        h & ~is_t, miss, is_shadow.contiguous(), *lights,
        (scene.n_spheres, scene.n_planes), cfg.plain)
    t3 = is_t[:, None]
    return Bounce(o=torch.where(t3, o_t, o_a), d=torch.where(t3, d_t, d_a),
                  weight=torch.where(is_t, w_t, w_a),
                  color=carry.color + (add_t + add_a))


def _same_geom(scene, geom: shade.ShadeGeom, cfg: TraceConfig
               ) -> shade.ShadeGeom:
    return geom


class _Route(NamedTuple):
    """One route of :func:`trace_shade` (a value of :data:`ROUTES`)."""

    #: one segment: (scene, geom, carry, record, cfg) -> the next Bounce
    step: Callable
    #: the ShadeGeom rows and the scene fields it reads with a gradient:
    #: the inputs of its conditional segments, so that their gradients
    #: pass through
    rows: tuple
    fields: tuple
    #: ``trace_shade(checkpoint=True)`` keeps none of its residuals:
    #: segment 0 runs under ``torch.utils.checkpoint`` and each later
    #: segment recomputes itself in its backward. A fused segment's
    #: residuals are its inputs, so its graph is always kept and its
    #: backward kernel (K6, K11) runs once, its forward never again.
    recompute: bool = False
    #: (scene, geom, cfg) -> the ShadeGeom its steps read, made from the
    #: pass's once per :func:`trace_shade` call
    geom: Callable = _same_geom
    #: the routes whose host tallies ``"replay.<name>"`` each of its
    #: segments adds one to: its own name's where empty
    tallies: tuple = ()


#: the lights and the environment, which every route reads
_LIGHTS = ("light_pos", "light_color", "ambience", "background")

#: the routes of :func:`trace_shade` by :meth:`TraceConfig.replay_route`'s
#: names, each segment one host tally ``"replay.<name>"``; a segment of
#: ``"fused_mixed"`` runs both fused segments and adds one to each one's
#: tally, ``"replay.fused_tri"`` and ``"replay.fused_ana"``
ROUTES = {
    "fused_tri": _Route(_fused_segment, ("tri_pack",), _LIGHTS),
    "fused_ana": _Route(_fused_ana_segment, ("ana16", "mat16"), _LIGHTS),
    "fused_mixed": _Route(
        _fused_mixed_segment, ("tri_pack", "ana16", "mat16"), _LIGHTS,
        geom=_mixed_geom, tallies=("fused_tri", "fused_ana")),
    "autograd": _Route(
        _replay_segment, ("tri_pack", "mat16"),
        ("sphere_center", "sphere_radius", "plane_center", "plane_normal",
         "cyl_center", "cyl_axis", "cyl_radius", "cyl_height", "texels",
         *_LIGHTS), recompute=True),
}


@dataclasses.dataclass(frozen=True)
class _Segment:
    """What a conditional segment of :func:`trace_shade` runs."""

    #: "segment s of trace_shade": the forward IF node's name; the
    #: backward's adds " (backward)"
    site: str
    #: (o, d, weight, color, *tensors) -> the next (o, d, weight, color)
    fwd: Callable
    #: autograd keeps ``fwd``'s graph from the forward to the backward
    #: (its residuals in the IF nodes' pool under a capture), else the
    #: backward recomputes ``fwd``
    keep: bool = False


class _CondSegment(torch.autograd.Function):
    """Segment s >= 1 of :func:`trace_shade` as the reference's ``lax.cond``
    on the segment's record: ``apply(seg, pred, o, d, weight, color,
    *tensors)`` -> the next (o, d, weight, color), ``pred`` the 0-d bool
    ``(hit | miss).any()``.

    Under a graph capture the forward runs ``seg.fwd`` in a CUDA-graph IF
    node on ``pred`` (:func:`_branch`), and the backward runs the
    segment's VJP in a second IF node on the same condition, captured
    with the forward's graph or, for a differentiable region
    (``graphs.run(..., records_grad=True)``), into its backward graph:
    from the autograd engine's thread, on the stream the forward ran on,
    which that capture holds. Where the nodes skip, the outputs are the
    carry and the cotangents a dead segment's: the carry's own cotangents
    unchanged, zero for every other tensor (the VJP of ``lax.cond``'s
    identity branch), so a dead segment costs nothing forward or
    backward. Eagerly both run and a select keeps or drops their
    results, so the two modes group the gradient sums alike. Every
    tensor the segment reads with a gradient is one of ``tensors``: one
    that ``seg.fwd`` only closed over would lose its gradient.
    """

    @staticmethod
    def forward(ctx, seg: _Segment, pred, *inputs):
        ctx.seg = seg
        ctx.branch = graphs.capturing(pred.device)
        if seg.keep:
            leaves = [x.detach().requires_grad_(n)
                      for x, n in zip(inputs, ctx.needs_input_grad[2:])]
            kept = []

            def body():
                with torch.enable_grad():
                    kept[:] = seg.fwd(*leaves)
                return kept
            ctx.kept = leaves, kept
            ctx.save_for_backward(pred)
        else:
            def body():
                return seg.fwd(*inputs)
            ctx.save_for_backward(pred, *inputs)
        carry = inputs[:4]
        if not ctx.branch:
            return _select(pred, body(), carry)
        out = [t.clone() for t in carry]
        _branch(pred, body, out, seg.site)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        seg = ctx.seg
        pred, *inputs = ctx.saved_tensors
        if seg.keep:
            inputs = ctx.kept[0]
        need = ctx.needs_input_grad[2:]
        idx = [i for i, n in enumerate(need) if n]

        def body():
            if seg.keep:
                leaves, outs = ctx.kept
            else:
                with torch.enable_grad():
                    leaves = [x.detach().requires_grad_(n)
                              for x, n in zip(inputs, need)]
                    outs = seg.fwd(*leaves)
            live = [(y, g) for y, g in zip(outs, cots) if y.requires_grad]
            # a kept graph stays: a second backward (retain_graph, or a
            # backward graph replayed again) reads its residuals again
            got = torch.autograd.grad([y for y, _ in live],
                                      [leaves[i] for i in idx],
                                      [g for _, g in live],
                                      retain_graph=seg.keep,
                                      allow_unused=True)
            return [torch.zeros_like(leaves[i]) if g is None else g
                    for i, g in zip(idx, got)]

        def dead(i):
            return cots[i] if i < 4 else torch.zeros_like(inputs[i])

        site = f"{seg.site} (backward)"
        if not ctx.branch:
            grads = [torch.where(pred, g, dead(i))
                     for i, g in zip(idx, body())]
        elif not graphs.capturing(pred.device):
            raise graphs.GraphCaptureError(
                f"{site}: the backward runs off the capturing stream")
        else:
            grads = [dead(i).clone() if i < 4 else dead(i) for i in idx]
            _branch(pred, body, grads, site)
        out = [None] * len(inputs)
        for i, g in zip(idx, grads):
            out[i] = g
        return (None, None, *out)


def _cond_segment(route: _Route, scene, geom: shade.ShadeGeom, rec,
                  cfg: TraceConfig, site: str, keep: bool):
    """(segment, tensors) of ``route``'s segment on the record ``rec`` for
    :class:`_CondSegment`: ``tensors`` are the route's rows of ``geom``
    and its fields of ``scene``, which its ``fwd`` puts back."""
    n = len(route.rows)

    def fwd(o, d, weight, color, *tensors):
        g = geom._replace(**dict(zip(route.rows, tensors[:n])))
        sc = dataclasses.replace(scene, **dict(zip(route.fields, tensors[n:])))
        return tuple(route.step(sc, g, Bounce(o, d, weight, color), rec, cfg))
    return (_Segment(site, fwd, keep=keep),
            (*(getattr(geom, r) for r in route.rows),
             *(getattr(scene, f) for f in route.fields)))


def trace_shade(scene, o: torch.Tensor, d: torch.Tensor, topo: TraceTopo,
                cfg: TraceConfig = TraceConfig(),
                geom: Optional[shade.ShadeGeom] = None,
                checkpoint: bool = False) -> torch.Tensor:
    """Differentiable shading replay of a recorded topology -> [R, 3].

    Re-resolves each segment's fixed hit, shades it under the recorded
    shadow mask and follows the mirror chain, with no traversal and no
    occlusion query. ``trace_shade(scene, o, d, trace_topology(scene, o,
    d))`` equals ``trace(scene, o, d)``. ``geom`` (the packed rows) can be
    shared by the tiles of one pass, so that its gather backward runs
    once. The route (the fused K5/K6 segment, the fused K10/K11 segment,
    both side by side, or the autograd replay) is the entry of
    :data:`ROUTES` that :meth:`TraceConfig.replay_route` names; each
    segment adds one to the route's host tallies ``"replay.<route>"``
    (``graphs.tally``: a captured graph adds its counts at each replay).

    Segment 0 of a topology from :func:`trace_topology` has every ray
    live. Segments 1.. are :class:`_CondSegment` on ``(hit | miss).any()``:
    a segment with no live hit or miss yields its carry unchanged and its
    cotangents pass through, in IF nodes under a graph capture and by a
    select eagerly. ``checkpoint`` (the training step's tiles) keeps no
    residual of the autograd replay between forward and backward:
    segment 0 runs under ``torch.utils.checkpoint`` and each later
    segment recomputes itself in its backward, so a live segment's replay
    runs twice and a dead one's never under a capture; without it each
    runs once. A fused segment's residuals are its inputs either way.
    """
    name = cfg.validate().replay_route(scene)
    route = ROUTES[name]
    recompute = checkpoint and route.recompute
    if geom is None:
        geom = shade.pack_shade_geom(scene, cfg.plain)
    geom = route.geom(scene, geom, cfg)
    R = o.shape[0]
    carry = Bounce(o=o, d=d, weight=torch.ones(R, device=o.device),
                   color=torch.zeros((R, 3), device=o.device))
    for s in range(topo.kind.shape[0]):
        rec = (topo.kind[s], topo.idx[s], topo.hit[s], topo.miss[s],
               topo.shadow[s])
        for t in route.tallies or (name,):
            graphs.tally("replay." + t)
        if s == 0 and recompute:
            # the replay draws no random numbers, and a capture cannot
            # stash the CUDA generator's state
            carry = Bounce(*torch.utils.checkpoint.checkpoint(
                lambda *c, rec=rec: tuple(route.step(
                    scene, geom, Bounce(*c), rec, cfg)),
                *carry, use_reentrant=False, preserve_rng_state=False))
        elif s == 0:
            carry = route.step(scene, geom, carry, rec, cfg)
        else:
            seg, tensors = _cond_segment(
                route, scene, geom, rec, cfg, f"segment {s} of trace_shade",
                keep=not recompute)
            carry = Bounce(*_CondSegment.apply(
                seg, (rec[2] | rec[3]).any(),
                *(t.contiguous() for t in carry), *tensors))
    return carry.color


def _tally(entry: str) -> Optional[torch.Tensor]:
    """The segment counters of every call of the entry point ``entry`` so
    far, summed on the host -> int64 [S, 3] (S the most segments of its
    scenes), or None where no call counted."""
    held = graphs.counters(entry, COUNTERS)
    if not held:
        return None
    out = torch.zeros((max(t.shape[0] for t in held), 3), dtype=torch.int64)
    for t in held:
        out[:t.shape[0]] += t.cpu()
    return out


def live_rays(entry: str, s: Optional[int] = None) -> int:
    """The rays that entered segment ``s`` alive (every segment where
    None) in the calls of the entry point ``entry`` so far (``render``,
    ``aa_refine``, ``fit_step``, ...): the live rays K3 counted, 0 where
    it counted none. It synchronises (a device-to-host copy), so it is
    never called on a call's path."""
    t = _tally(entry)
    if t is None or (s is not None and s >= t.shape[0]):
        return 0
    return int(t[:, LIVE].sum() if s is None else t[s, LIVE])


def segments_run(entry: str) -> int:
    """The segment bodies that ran in the calls of the entry point
    ``entry`` so far: segment 0 of each trace, and each later segment
    whose condition held (its IF node's body ran). Synchronises."""
    t = _tally(entry)
    return 0 if t is None else int(t[:, RAN].sum())


def rays_run(entry: str) -> int:
    """The rays of the segment bodies that ran in the calls of the entry
    point ``entry`` so far (each body runs over its whole batch, alive or
    not). Synchronises."""
    t = _tally(entry)
    return 0 if t is None else int(t[:, RAYS].sum())
