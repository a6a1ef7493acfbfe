"""Ray-primitive intersection and the slab test (torch).

Counterpart of ``myraytracer_tpu/ops/intersect.py``: the same epsilons,
the same expression forms (so t agrees with the reference to the bit on
the CPU), and misses encoded as the finite ``INF = 3e38`` so closest-hit
stays a plain min and the kernels compare it like any other distance.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.utils import vecmath as vm

#: shadow-acne epsilon used by every primitive (reference: 1e-5)
EPS_HIT = 1e-5

#: parallel-ray guard for planes
EPS_PARALLEL = 1e-9

#: degenerate-triangle determinant guard
EPS_DET = 1e-10

#: "no hit" distance: finite on purpose (the kernels rely on INF < inf)
INF = 3.0e38


def dot_last(a, b):
    """Dot product along the last axis."""
    return torch.sum(a * b, dim=-1)


def ray_sphere(o, d, center, radius):
    """Closest ray-sphere hit distance; INF on miss.

    o, d, center [..., 3] and radius [...], broadcastable; directions
    need not be normalized.
    """
    oc = o - center
    a = vm.dot(d, d)
    b = 2.0 * vm.dot(oc, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = vm.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 > EPS_HIT, t0, t1)
    valid = (disc >= 0.0) & (t > EPS_HIT)
    return torch.where(valid, t, torch.full_like(t, INF))


def ray_plane(o, d, center, normal):
    """Ray-plane hit distance; INF on miss or for a parallel ray."""
    cos_theta = vm.dot(normal, d)
    parallel = cos_theta.abs() < EPS_PARALLEL
    denom = torch.where(parallel, torch.ones_like(cos_theta), cos_theta)
    t = (vm.dot(normal, center) - vm.dot(normal, o)) / denom
    valid = ~parallel & (t > EPS_HIT)
    return torch.where(valid, t, torch.full_like(t, INF))


def ray_cylinder(o, d, center, axis, radius, height):
    """Closest hit with a finite open (uncapped) cylinder; INF on miss.

    With a = d - (d.u)u and b = oc - (oc.u)u, solves |a t + b|^2 = r^2
    and keeps the nearer root whose point lies within +-height/2 along
    the axis u. A ray parallel to the axis (|a|^2 < 1e-12) misses.
    """
    oc = o - center
    d_par = dot_last(d, axis)
    oc_par = dot_last(oc, axis)
    a_v = d - d_par[..., None] * axis
    b_v = oc - oc_par[..., None] * axis
    a = dot_last(a_v, a_v)
    b = 2.0 * dot_last(a_v, b_v)
    c = dot_last(b_v, b_v) - radius * radius
    degenerate = a < 1e-12
    a_safe = torch.where(degenerate, torch.ones_like(a), a)
    disc = b * b - 4.0 * a_safe * c
    # sqrt(max(disc, 0)) with a double where: the same values, and a
    # finite gradient for the rays whose disc <= 0 (the training replay
    # evaluates this branch for every ray; sqrt'(0) = inf would turn
    # their zero cotangents into NaN)
    pos = disc > 0.0
    sq = torch.where(pos, vm.sqrt(torch.where(pos, disc, torch.ones_like(a))),
                     torch.zeros_like(a))
    inv2a = 0.5 / a_safe
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    half = height * 0.5
    ok0 = (t0 > EPS_HIT) & ((oc_par + t0 * d_par).abs() <= half)
    ok1 = (t1 > EPS_HIT) & ((oc_par + t1 * d_par).abs() <= half)
    inf = torch.full_like(t0, INF)
    t = torch.where(ok0, t0, torch.where(ok1, t1, inf))
    valid = ~degenerate & (disc >= 0.0) & (ok0 | ok1)
    return torch.where(valid, t, inf)


def ray_aabb(o, inv_d, bbmin, bbmax):
    """Slab test: returns (hit, tmin).

    Per-axis slab distances with min/max swap, hit iff the slabs overlap
    and ``tmax > EPS_HIT``. ``inv_d`` is the reciprocal direction; IEEE
    inf for zero components gives the correct +-inf slab behavior.
    """
    t0 = (bbmin - o) * inv_d
    t1 = (bbmax - o) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tmax >= tmin) & (tmax > EPS_HIT), tmin


def keeps_recorded_hit(ok, t):
    """Where a replay keeps a recorded triangle hit: wherever its
    re-solve is not degenerate (``ok``) and ahead of the ray
    (``t > EPS_HIT``), with no inside test. The replay re-solves a hit
    that the topology pass recorded, from a ray whose last bits can
    differ from the traced one's, and a hit grazing an edge can then
    fall just outside the triangle; the solve of the triangle's plane
    is still the hit, where a miss would send the point to INF (and a
    reflected ray on to NaN). The rule of every triangle replay: the
    autograd one (``ray_triangle(recorded=True)`` in
    ``shade.resolve_hit``) and K5/K6 (``shade_grad._fwd_core`` and
    ``seg_geometry`` in csrc/shade_grad.cu). The sphere and cylinder
    re-solves keep their miss: off a grazing tangent their quadratic
    has no root to keep. The reference keeps the inside test, so the
    port departs from it on such rays, by as much as the ray moved."""
    return ok & (t > EPS_HIT)


def ray_triangle(o, d, p0, p1, p2, recorded: bool = False):
    """Ray-triangle via Cramer's rule: returns (t, alpha, beta).

    Solves ``o + t d = alpha p0 + beta p1 + gamma p2`` with
    ``gamma = 1 - alpha - beta`` (columns [p0-p2, p1-p2, -d | o-p2]).
    Miss -> t = INF. alpha and beta are differentiable with respect to
    the vertices and the ray; the double ``where`` keeps the gradient of
    a degenerate triangle finite. ``recorded``: the ray is known to hit
    this triangle (a replay of a recorded topology), and t holds by
    :func:`keeps_recorded_hit`.
    """
    c1 = p0 - p2
    c2 = p1 - p2
    c3 = -d
    c4 = o - p2
    s = vm.det3(c1, c2, c3)
    ok = s.abs() > EPS_DET
    inv_s = torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    t = vm.det3(c1, c2, c4) * inv_s
    alpha = vm.det3(c4, c2, c3) * inv_s
    beta = vm.det3(c1, c4, c3) * inv_s
    gamma = 1.0 - alpha - beta
    inside = ((alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
              & (gamma >= 0.0) & (gamma <= 1.0))
    valid = (keeps_recorded_hit(ok, t) if recorded
             else ok & (t > EPS_HIT) & inside)
    return torch.where(valid, t, torch.full_like(t, INF)), alpha, beta
