"""Acceleration-structure refit for optimised geometry (torch).

Counterpart of ``myraytracer_tpu/ops/refit.py``. A training step moves
``vertex_pos``, so bounds built from the initial vertices stop being
conservative and culling would drop true hits. :func:`refit_accel`
recomputes every BVH node box and every cluster AABB from the current
vertices in one dense pass:

  1. per-triangle AABBs from the corner gathers;
  2. a sparse table of power-of-two window mins and maxes (``log2 T``
     shifted elementwise passes; the maxes as negated mins, exactly);
  3. each node's or cluster's range ``[lo, hi)`` reduces to two
     overlapping window lookups with ``j = floor(log2(hi - lo))``,
     computed in integers.

min/max are exact in floating point, so the boxes equal the reference's
bit for bit. The refit runs under ``no_grad``: bounds are traversal
topology. Tree structure (links, cluster cut, leaf order) is kept.
"""

from __future__ import annotations

import dataclasses

import torch


def _range_table(lo_hi: torch.Tensor):
    """Sparse min table over windows of length 2^j: row ``j*T + i`` of the
    [J*T, C] result reduces rows ``[i, i + 2^j)`` (clamped at T). Returns
    (table, J). Maxima ride along as negated columns (exact)."""
    T = lo_hi.shape[0]
    J = max(1, T.bit_length())  # floor(log2(T)) + 1 levels
    levels = [lo_hi]
    for j in range(1, J):
        h = 1 << (j - 1)
        prev = levels[-1]
        if h < T:
            shifted = torch.nn.functional.pad(prev[h:], (0, 0, 0, h),
                                              value=float("inf"))
            levels.append(torch.minimum(prev, shifted))
        else:
            levels.append(prev)
    return torch.cat(levels), J


def _floor_log2(x: torch.Tensor, bits: int) -> torch.Tensor:
    """floor(log2(x)) of positive integers below ``2**bits``, exactly:
    the number of k in [1, bits) with x >> k > 0."""
    ks = torch.arange(1, max(bits, 2), dtype=x.dtype, device=x.device)
    return ((x[:, None] >> ks) > 0).sum(dim=1, dtype=x.dtype)


def _range_bounds(table, T: int, J: int, lo, hi):
    """(bmin, bmax) of contiguous triangle ranges [lo, hi) via the table."""
    length = torch.clamp(hi - lo, min=1)
    j = _floor_log2(length, J)
    win = torch.ones_like(j) << j
    ia = (j * T + lo).long()
    ib = (j * T + torch.clamp(hi - win, min=0)).long()
    b = torch.minimum(table[ia], table[ib])
    return b[:, :3].contiguous(), (-b[:, 3:]).contiguous()


@torch.no_grad()
def refit_accel(scene):
    """``scene`` with ``bvh_bbmin/bbmax``, the packed node boxes and
    ``cl_bbmin/bbmax`` recomputed from the current ``vertex_pos``."""
    if scene.n_tris == 0:
        return scene
    vp = scene.vertex_pos.detach()
    tv = scene.tri_vidx.long()
    p0, p1, p2 = vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]
    tmin = torch.minimum(torch.minimum(p0, p1), p2)
    tmax = torch.maximum(torch.maximum(p0, p1), p2)

    T = scene.n_tris
    table, J = _range_table(torch.cat([tmin, -tmax], dim=1))
    nbmin, nbmax = _range_bounds(table, T, J, scene.bvh_lo, scene.bvh_hi)
    cbmin, cbmax = _range_bounds(table, T, J, scene.cl_first,
                                 scene.cl_first + scene.cl_count)
    nodes_packed = torch.cat([nbmin, nbmax, scene.bvh_nodes_packed[:, 6:8]],
                             dim=1)
    return dataclasses.replace(
        scene, bvh_bbmin=nbmin, bvh_bbmax=nbmax,
        bvh_nodes_packed=nodes_packed, cl_bbmin=cbmin, cl_bbmax=cbmax)
