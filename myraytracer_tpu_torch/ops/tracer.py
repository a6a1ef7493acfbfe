"""Wavefront Whitted integrator over the fused kernel pipeline (torch).

Counterpart of the fused branch of ``myraytracer_tpu/ops/tracer.py``
(``_fused_segment_step`` and ``trace``) for triangle-only, untextured
scenes. Every Whitted segment runs once over the whole flat ray batch:

  closest-hit cluster scan (K2 phase-1 + K1)  ->  pre kernel K3 (hit
  resolve + light-major shadow batch)  ->  any-hit cluster scan (hull
  phase-1 + K1')  ->  phong kernel K4 (lighting, blend, bounce).

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
from myraytracer_tpu_torch.ops.intersect import INF


class TraceConfig(NamedTuple):
    """Options of the integrator: the reference's TraceConfig reduced to
    what the fused triangle path reads."""

    #: run the plain PyTorch versions of the kernels, on any device
    #: (compares the kernels with them on the card)
    plain: bool = False


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


def segment_step(scene, pack: TracePack, carry: Bounce,
                 cfg: TraceConfig = TraceConfig()) -> Bounce:
    """One Whitted segment: returns the next bounce with its color added."""
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
    return Bounce(o=o2, d=d2, weight=w2, color=carry.color + add)


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
        carry = segment_step(scene, pack, carry, cfg)
    return carry.color
