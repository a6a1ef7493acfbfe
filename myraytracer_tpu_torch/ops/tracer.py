"""Wavefront Whitted integrator over the fused kernel pipeline (torch).

Counterpart of the fused branch of ``myraytracer_tpu/ops/tracer.py`` for
triangle-only, untextured scenes. Every Whitted segment runs once over
the whole flat ray batch:

  closest-hit cluster scan (K2 phase-1 + K1)  ->  pre kernel K3 (hit
  resolve + light-major shadow batch)  ->  any-hit cluster scan (hull
  phase-1 + K1')  ->  phong kernel K4 (lighting, blend, bounce).

:func:`trace` runs that chain. The training step splits it in two:
:func:`trace_topology` runs the same chain without gradients and records
per segment which triangle each ray hit and the shadow mask;
:func:`trace_shade` replays the differentiable shading on that fixed
topology, with no traversal, either through the fused K5/K6 segment
(ops/shade_grad.py, the default) or as an autograd replay of
``shade.resolve_hit`` + :func:`lighting_from_mask`.

A segment in which no ray is alive any more is skipped. Scenes with
spheres, planes, cylinders or textures raise NotImplementedError: their
branches of K3/K4 are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.utils import vecmath as vm


class TraceConfig(NamedTuple):
    """Options of the integrator: the reference's TraceConfig reduced to
    what the fused triangle path reads."""

    #: run the plain PyTorch versions of the kernels, on any device
    #: (compares the kernels with them on the card)
    plain: bool = False
    #: trace_shade replays each segment through the fused K5/K6 segment
    #: (True) or as an autograd replay of resolve_hit + lighting_from_mask
    #: (False, the reference's default). The reference keeps the fused
    #: segment opt-in because a Pallas boundary re-lays out ~30 per-ray
    #: columns on the TPU; on the GPU a thread reads its row by id.
    fused_shade_grad: bool = True


class Bounce(NamedTuple):
    """Per-ray state carried from one Whitted segment to the next."""

    o: torch.Tensor       # [R, 3]
    d: torch.Tensor       # [R, 3]
    weight: torch.Tensor  # [R]; 0 = dead
    color: torch.Tensor   # [R, 3] accumulated linear color


class TracePack(NamedTuple):
    """Scene tables the segments read, packed once per render."""

    cl_const: torch.Tensor  # [K, 16, M] cluster solve constants
    geom: shade.ShadeGeom   # tri_pack [T, 48], mat16 [Mt, 16]
    env: torch.Tensor       # [6] ambience, background


def check_supported(scene) -> None:
    """Raise NotImplementedError for scenes the port cannot trace yet."""
    if scene.n_spheres or scene.n_planes or scene.n_cylinders:
        raise NotImplementedError(
            "spheres, planes and cylinders are not ported yet")
    if scene.has_textures:
        raise NotImplementedError("textured meshes are not ported yet")
    if not scene.n_tris:
        raise NotImplementedError("the port traces triangle meshes only")


def pack_trace(scene) -> TracePack:
    """Pack the tables :func:`segment_step` reads (once per render)."""
    check_supported(scene)
    return TracePack(
        cl_const=cc.pack_cluster_constants(scene),
        geom=shade.pack_shade_geom(scene),
        env=torch.cat([scene.ambience, scene.background]).contiguous())


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


def segment_step(scene, pack: TracePack, carry: Bounce,
                 cfg: TraceConfig = TraceConfig()):
    """One Whitted segment -> (next bounce with its color added, the
    segment's topology record (kind, idx, hit, miss, shadow))."""
    R = carry.o.shape[0]
    L = scene.n_lights
    live = carry.weight > 0.0
    o = carry.o.contiguous()
    d = carry.d.contiguous()

    tri = cc.intersect_clusters(scene, o, d, active=live,
                                cl_const=pack.cl_const, plain=cfg.plain)
    hit = tri.t < INF
    kind = torch.where(hit & live, shade.KIND_TRI, shade.KIND_MISS).to(torch.int32)
    valid = kind != shade.KIND_MISS
    t = torch.where(hit, tri.t, torch.full_like(tri.t, INF))
    tri_idx = torch.where(valid, torch.clamp(tri.idx, min=0),
                          torch.zeros_like(tri.idx)).contiguous()
    live_i = live.to(torch.int32)

    pre = cs.shade_pre_plain if cfg.plain else cs.shade_pre
    point, normal, mid, so, sd, st, sact = pre(
        o, d, t.contiguous(), kind, live_i, tri_idx, pack.geom.tri_pack,
        pack.geom.mat16, scene.light_pos)

    if L:
        occ = cc.intersect_clusters(scene, so, sd, t_max=st, any_hit=True,
                                    active=sact > 0, cl_const=pack.cl_const,
                                    plain=cfg.plain)
        shadow = (occ.idx >= 0).to(torch.int32).reshape(L, R)
    else:
        shadow = torch.zeros((0, R), dtype=torch.int32, device=o.device)

    phong = cs.shade_phong_plain if cfg.plain else cs.shade_phong
    add, o2, d2, w2 = phong(
        o, d, carry.weight.contiguous(), valid.to(torch.int32), live_i, mid,
        point, normal, shadow.contiguous(), pack.geom.mat16, scene.light_pos,
        scene.light_color, pack.env)
    record = (kind, tri_idx, valid, live & ~valid, shadow > 0)
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add), record


def trace(scene, o: torch.Tensor, d: torch.Tensor,
          cfg: TraceConfig = TraceConfig(), pack: Optional[TracePack] = None
          ) -> torch.Tensor:
    """Whitted trace of a ray batch -> [R, 3] linear color (unclamped).

    Segment 0 is the primary hit (weight 1); segments 1.. follow the
    mirror chain with weight *= mirror; a miss adds weight * background
    and kills the ray. ``pack`` (:func:`pack_trace`) can be shared by the
    tiles of one render.
    """
    if pack is None:
        pack = pack_trace(scene)
    R = o.shape[0]
    carry = Bounce(o=o, d=d, weight=torch.ones(R, device=o.device),
                   color=torch.zeros((R, 3), device=o.device))
    for _ in range(scene.n_segments):
        if not bool((carry.weight > 0.0).any()):
            break
        carry, _ = segment_step(scene, pack, carry, cfg)
    return carry.color


@torch.no_grad()
def trace_topology(scene, o: torch.Tensor, d: torch.Tensor,
                   cfg: TraceConfig = TraceConfig(),
                   pack: Optional[TracePack] = None) -> TraceTopo:
    """Gradient-free topology pass: the segments of :func:`trace`,
    recording per segment which triangle each ray hit, whether it was a
    live hit or a live miss, and the shadow mask per light. Segments after
    every ray died record no hits (kind KIND_MISS, idx 0, all False)."""
    if pack is None:
        pack = pack_trace(scene)
    R, L = o.shape[0], scene.n_lights
    dev = o.device
    carry = Bounce(o=o, d=d, weight=torch.ones(R, device=dev),
                   color=torch.zeros((R, 3), device=dev))
    dead = (torch.full((R,), shade.KIND_MISS, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros(R, dtype=torch.bool, device=dev),
            torch.zeros((L, R), dtype=torch.bool, device=dev))
    records = []
    for _ in range(scene.n_segments):
        if bool((carry.weight > 0.0).any()):
            carry, rec = segment_step(scene, pack, carry, cfg)
        else:
            rec = dead
        records.append(rec)
    return TraceTopo(*(torch.stack(x) for x in zip(*records)))


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


def _replay_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec
                    ) -> Bounce:
    """One segment of the autograd replay (the reference's default)."""
    kind, idx, h, miss, is_shadow = rec
    hit = shade.resolve_hit(scene, carry.o, carry.d, kind, idx, geom)
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


def _fused_segment(scene, geom: shade.ShadeGeom, carry: Bounce, rec,
                   plain: bool) -> Bounce:
    """One segment through the fused K5/K6 segment (ops/shade_grad.py)."""
    kind, idx, h, miss, is_shadow = rec
    ti = torch.clamp(idx, 0, scene.n_tris - 1).to(torch.int32).contiguous()
    lit = (~is_shadow).to(carry.o.dtype).contiguous()
    add, o2, d2, w2 = sg.ShadeSegment.apply(
        carry.o.contiguous(), carry.d.contiguous(), carry.weight.contiguous(),
        geom.tri_pack, ti, scene.light_pos, scene.light_color,
        scene.ambience, scene.background, (kind == shade.KIND_TRI).contiguous(),
        h.contiguous(), miss.contiguous(), lit, plain)
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add)


def trace_shade(scene, o: torch.Tensor, d: torch.Tensor, topo: TraceTopo,
                cfg: TraceConfig = TraceConfig(),
                geom: Optional[shade.ShadeGeom] = None) -> torch.Tensor:
    """Differentiable shading replay of a recorded topology -> [R, 3].

    Re-resolves each segment's fixed hit, shades it under the recorded
    shadow mask and follows the mirror chain, with no traversal and no
    occlusion query. ``trace_shade(scene, o, d, trace_topology(scene, o,
    d))`` equals ``trace(scene, o, d)``. ``geom`` (the packed rows) can be
    shared by the tiles of one pass, so that its gather backward runs
    once. Segments with no live ray are skipped.
    """
    if geom is None:
        geom = shade.pack_shade_geom(scene)
    R = o.shape[0]
    carry = Bounce(o=o, d=d, weight=torch.ones(R, device=o.device),
                   color=torch.zeros((R, 3), device=o.device))
    for s in range(topo.kind.shape[0]):
        rec = (topo.kind[s], topo.idx[s], topo.hit[s], topo.miss[s],
               topo.shadow[s])
        if not bool((rec[2] | rec[3]).any()):
            continue
        if cfg.fused_shade_grad:
            carry = _fused_segment(scene, geom, carry, rec, cfg.plain)
        else:
            carry = _replay_segment(scene, geom, carry, rec)
    return carry.color
