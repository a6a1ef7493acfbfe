"""Ray-primitive constants and the slab test (torch).

Counterpart of ``myraytracer_tpu/ops/intersect.py``: the same epsilons,
and misses encoded as the finite ``INF = 3e38`` so closest-hit stays a
plain min and the kernels compare it like any other distance.
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


def ray_triangle(o, d, p0, p1, p2):
    """Ray-triangle via Cramer's rule: returns (t, alpha, beta).

    Solves ``o + t d = alpha p0 + beta p1 + gamma p2`` with
    ``gamma = 1 - alpha - beta`` (columns [p0-p2, p1-p2, -d | o-p2]).
    Miss -> t = INF. alpha and beta are differentiable with respect to
    the vertices and the ray; the double ``where`` keeps the gradient of
    a degenerate triangle finite.
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
    valid = ok & (t > EPS_HIT) & inside
    return torch.where(valid, t, torch.full_like(t, INF)), alpha, beta
