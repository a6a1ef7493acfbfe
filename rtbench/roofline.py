"""The yardstick's roofline: the card's published peaks, and the work a
BVH walk needs on given rays.

Frozen copies from the repository's ``chip_smoke.py`` (its peaks, its
operation counts and ``walk_bound``) and from the program's plain walk
(``ops/traverse.traverse_bvh_plain`` with its ``stats`` counters), so
that a later change to the program cannot move the bound its kernels
are measured against.

The walk reads the tables the program's ``Scene.build`` packs:
``bvh_nodes_packed`` [N, 8] (bbmin, bbmax, the bits of the first
triangle and of the count, 0 for an internal node) and
``bvh_links_packed`` [8N, 2] (entry and skip link, row ``octant * N +
node``). A step enters a node if its slab test hits no farther than the
ray's best t and the node is internal, and takes the skip link
otherwise; a leaf solves its triangles in slot order.
"""

from __future__ import annotations

from typing import Dict

import torch

#: one H100 SXM (NVIDIA's data sheet): HBM bytes/s and fp32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

#: operations of one slab test and of one ray-triangle solve
OPS_SLAB, OPS_TRI = 24, 51

EPS_HIT, EPS_DET, INF = 1e-5, 1e-10, 3.0e38


def bound_ms(n_bytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the fp32 rate, in ms."""
    return max(n_bytes / PEAK_BYTES, ops / PEAK_F32) * 1e3


def walk_bound_ms(rays: int, work: Dict[str, float]) -> float:
    """A closest-hit walk's bound from the work its rays need: each ray's
    origin, direction, t_max and flag read and its t and index written
    once; the distinct node rows (32 B), link rows (8 B) and triangles
    (three corners, 36 B) read; a slab test per node step, a solve per
    leaf slot."""
    n_bytes = (rays * (12 + 12 + 4 + 4 + 4 + 4) + work["nodes"] * 32
               + work["links"] * 8 + work["tris"] * 36)
    return bound_ms(n_bytes, work["visits"] * OPS_SLAB
                    + work["slots"] * OPS_TRI)


def _det3(c1, c2, c3):
    return (c1[:, 0] * (c2[:, 1] * c3[:, 2] - c3[:, 1] * c2[:, 2])
            - c2[:, 0] * (c1[:, 1] * c3[:, 2] - c3[:, 1] * c1[:, 2])
            + c3[:, 0] * (c1[:, 1] * c2[:, 2] - c2[:, 1] * c1[:, 2]))


def _tri_t(o, d, p0, p1, p2):
    c1, c2, c3, c4 = p0 - p2, p1 - p2, -d, o - p2
    s = _det3(c1, c2, c3)
    ok = s.abs() > EPS_DET
    inv = torch.where(ok, 1.0 / torch.where(ok, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    t = _det3(c1, c2, c4) * inv
    a = _det3(c4, c2, c3) * inv
    b = _det3(c1, c4, c3) * inv
    g = 1.0 - a - b
    inside = ((a >= 0) & (a <= 1) & (b >= 0) & (b <= 1) & (g >= 0)
              & (g <= 1))
    return torch.where(ok & (t > EPS_HIT) & inside, t, torch.full_like(t, INF))


def walk_work(nodes, links, corners, max_leaf: int, o, d) -> Dict[str, int]:
    """Count a closest-hit walk's work on rays (o, d) [R, 3]: ``visits``
    (node steps), ``slots`` (triangle solves) and the distinct ``nodes``,
    ``links`` and ``tris`` rows read. ``corners`` [T, >= 9] holds each
    triangle's p0 p1 p2."""
    dev = o.device
    R, N, T = o.shape[0], nodes.shape[0], corners.shape[0]
    links = links.long()
    inv_d = 1.0 / d
    octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
              + 4 * (d[:, 2] < 0).long())
    t = torch.full((R,), INF, device=dev)
    ptr = torch.zeros(R, dtype=torch.long, device=dev)
    seen_n = torch.zeros(N, dtype=torch.bool, device=dev)
    seen_l = torch.zeros(8 * N, dtype=torch.bool, device=dev)
    seen_t = torch.zeros(T, dtype=torch.bool, device=dev)
    visits = slots = 0
    ids = torch.arange(R, device=dev)
    while ids.numel():
        p = ptr[ids]
        row = nodes[p]
        fc = row[:, 6:8].contiguous().view(torch.int32)
        first, count = fc[:, 0].long(), fc[:, 1].long()
        oo, dd, tb = o[ids], d[ids], t[ids]
        t0 = (row[:, 0:3] - oo) * inv_d[ids]
        t1 = (row[:, 3:6] - oo) * inv_d[ids]
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        box = (tmax >= tmin) & (tmax > EPS_HIT) & (tmin <= tb)
        leaf = count > 0
        lw = torch.nonzero(box & leaf)[:, 0]
        if lw.numel():
            base, cnt, tl = first[lw], count[lw], tb[lw]
            for k in range(max_leaf):
                ti = torch.clamp(base + k, max=T - 1)
                c = corners[ti]
                tt = _tri_t(oo[lw], dd[lw], c[:, 0:3], c[:, 3:6], c[:, 6:9])
                ok = (k < cnt) & (tt < tl)
                tl = torch.where(ok, tt, tl)
                seen_t[ti[k < cnt]] = True
            tb[lw] = tl
            slots += int(cnt.sum())
        lrow = octant[ids] * N + p
        nxt = torch.where(box & ~leaf, links[lrow, 0], links[lrow, 1])
        visits += ids.numel()
        seen_n[p] = True
        seen_l[lrow] = True
        t[ids], ptr[ids] = tb, nxt
        ids = ids[nxt >= 0]
    return {"visits": visits, "slots": slots, "nodes": int(seen_n.sum()),
            "links": int(seen_l.sum()), "tris": int(seen_t.sum())}
