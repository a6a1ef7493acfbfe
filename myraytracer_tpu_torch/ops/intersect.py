"""Ray-primitive constants and the slab test (torch).

Counterpart of ``myraytracer_tpu/ops/intersect.py``: the same epsilons,
and misses encoded as the finite ``INF = 3e38`` so closest-hit stays a
plain min and the kernels compare it like any other distance.
"""

from __future__ import annotations

import torch

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
