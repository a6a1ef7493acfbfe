"""Triangle queries without clusters: the threaded-BVH walk and the
brute-force oracle (torch, and kernel K7).

Counterpart of ``myraytracer_tpu/ops/traverse.py``. The walk reads the
tables the scene build packs (ops/bvh.py): ``bvh_nodes_packed`` [N, 8]
(bbmin, bbmax, and the bits of the first triangle and of the count, 0
for an internal node), ``bvh_links_packed`` [8N, 2] (entry and skip
link, octant-major: row ``octant * N + p``) and the [T, 16] corner rows
of :func:`pack_tri_vertices`. Each ray carries one node pointer: a step
enters a node's subtree only if its slab test hits with ``tmin <=`` the
ray's best t and the node is internal (the entry link, near child first
for the ray's octant), and follows the skip link otherwise; a leaf
solves its triangles in slot order with a strict <. -1 ends the walk.

:func:`traverse_bvh` launches K7 (``csrc/bvh_walk.cu``) on CUDA tensors
and runs :func:`traverse_bvh_plain`, the reference's lockstep walk, on
CPU tensors. :func:`intersect_tris_brute` tests every triangle; it is
the oracle of both, and was never a Pallas kernel, so it stays torch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.intersect import INF, ray_aabb, ray_triangle


class TriHit(NamedTuple):
    """Per-ray closest triangle: index (-1 = miss) and distance."""

    idx: torch.Tensor   # [R] int32
    t: torch.Tensor     # [R] float32 (INF on miss)


def pack_tri_vertices(scene) -> torch.Tensor:
    """[T, 16] packed triangle corners (p0 p1 p2, padded 9 -> 16)."""
    vp = scene.vertex_pos
    tv = scene.tri_vidx.long()
    packed = torch.cat([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], dim=1)
    return torch.nn.functional.pad(packed, (0, 7))


def _miss(R: int, device) -> TriHit:
    return TriHit(torch.full((R,), -1, dtype=torch.int32, device=device),
                  torch.full((R,), INF, device=device))


def _start(R: int, t_max, active, device):
    """(t0 [R] f32: t_max or INF, start pointer [R] i64: 0, -1 inactive)."""
    t0 = (torch.full((R,), INF, device=device) if t_max is None
          else t_max.to(torch.float32).clone())
    ptr = torch.zeros(R, dtype=torch.int64, device=device)
    if active is not None:
        ptr = torch.where(active, ptr, -1)
    return t0, ptr


def _lanes_busy(steps):
    """(node steps over 32 x the sum of each 32-ray group's largest step
    count, that sum) of per-ray step counts in launch order."""
    n = steps.numel()
    if n == 0:
        return 0.0, 0
    groups = torch.nn.functional.pad(steps, (0, -n % 32)).view(-1, 32)
    warp_steps = int(groups.max(dim=1).values.sum())
    return int(steps.sum()) / max(32 * warp_steps, 1), warp_steps


def traverse_bvh_plain(scene, o, d, t_max=None, any_hit: bool = False,
                       active=None, tri_flat=None,
                       stats: Optional[dict] = None) -> TriHit:
    """The plain version of K7: the reference's lockstep walk.

    o, d [R, 3] (or [R, 4], xyz first); ``t_max`` [R] bounds the hit
    distance (INF without it); ``active`` [R] bool masks rays out
    (their walk starts at -1). In any-hit mode a ray retires after the
    step that found its first hit below ``t_max``. Returns TriHit: idx
    -1 and t INF on a miss. Each step runs over the rays still walking;
    the leaf solves run over the rays whose step hit a leaf.

    ``stats`` is a measurement hook, read only by chip_smoke.py's bound
    for K7: when given, it gets the work these inputs need. ``visits``:
    node steps; ``slots``: triangle solves (slot k < count of each leaf
    hit); ``nodes``, ``links``, ``tris``: the numbers of distinct node,
    link and corner rows read; ``warp_steps`` and ``lanes_busy``: over
    the 32-ray groups in call order (one warp each in K7), the sum of
    the groups' largest step counts, and the node steps over 32 times
    that; ``warp_steps_compact`` and ``lanes_busy_compact``: the same
    with each block's active rays packed first (K7's any-hit launch,
    :func:`compact_active`).
    """
    R, dev = o.shape[0], o.device
    if scene.n_tris == 0:
        return _miss(R, dev)
    o = o[:, :3].detach()
    d = d[:, :3].detach()
    if tri_flat is None:
        tri_flat = pack_tri_vertices(scene)
    tri_flat = tri_flat.detach()
    nodes = scene.bvh_nodes_packed.detach()
    links = scene.bvh_links_packed.long()
    N, T, L = nodes.shape[0], scene.n_tris, scene.max_leaf

    inv_d = 1.0 / d          # IEEE: 1 / -0 = -inf, as in the reference
    octant = ((d[:, 0] < 0).long() + 2 * (d[:, 1] < 0).long()
              + 4 * (d[:, 2] < 0).long())
    link_base = octant * N
    t, ptr = _start(R, t_max, active, dev)
    idx = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if stats is not None:
        seen = {"nodes": torch.zeros(N, dtype=torch.bool, device=dev),
                "links": torch.zeros(8 * N, dtype=torch.bool, device=dev),
                "tris": torch.zeros(T, dtype=torch.bool, device=dev)}
        visits = slots = 0
        steps = torch.zeros(R, dtype=torch.int64, device=dev)

    ids = torch.nonzero(ptr >= 0)[:, 0]
    while ids.numel():
        p = ptr[ids]
        row = nodes[p]                                          # [n, 8]
        fc = row[:, 6:8].contiguous().view(torch.int32)
        first, count = fc[:, 0], fc[:, 1]
        oo, dd = o[ids], d[ids]
        tb, ib = t[ids], idx[ids]
        box_hit, tmin = ray_aabb(oo, inv_d[ids], row[:, 0:3], row[:, 3:6])
        box_hit = box_hit & (tmin <= tb)
        is_leaf = count > 0
        lw = torch.nonzero(box_hit & is_leaf)[:, 0]             # leaf steps
        if lw.numel():
            base, cnt = first[lw], count[lw]
            tl, il = tb[lw], ib[lw]
            ol, dl = oo[lw], dd[lw]
            for k in range(L):
                ti = torch.clamp(base + k, max=T - 1)
                tr = tri_flat[ti.long()]
                t_tri, _, _ = ray_triangle(ol, dl, tr[:, 0:3], tr[:, 3:6],
                                           tr[:, 6:9])
                ok = (k < cnt) & (t_tri < tl)
                tl = torch.where(ok, t_tri, tl)
                il = torch.where(ok, base + k, il)
                if stats is not None:
                    seen["tris"][ti[k < cnt].long()] = True
            tb[lw], ib[lw] = tl, il
            if stats is not None:
                slots += int(cnt.sum())
        lrow = link_base[ids] + p
        lnk = links[lrow]
        nxt = torch.where(box_hit & ~is_leaf, lnk[:, 0], lnk[:, 1])
        if any_hit:
            nxt = torch.where(ib >= 0, -1, nxt)
        if stats is not None:
            visits += ids.numel()
            steps[ids] += 1
            seen["nodes"][p] = True
            seen["links"][lrow] = True
        t[ids], idx[ids], ptr[ids] = tb, ib, nxt
        ids = ids[nxt >= 0]
    if stats is not None:
        live = _start(R, None, active, dev)[1] >= 0
        packed = steps[compact_active(live)]
        stats.update({k: int(v.sum()) for k, v in seen.items()},
                     visits=visits, slots=slots)
        stats["lanes_busy"], stats["warp_steps"] = _lanes_busy(steps)
        stats["lanes_busy_compact"], stats["warp_steps_compact"] = \
            _lanes_busy(packed)
    return TriHit(idx, torch.where(idx >= 0, t, torch.full_like(t, INF)))


#: rays per block of K7: csrc/bvh_walk.cu kWalkThreads, which the built
#: library reports as mrt_bvh_walk_threads() (chip_smoke.py and the on-card
#: tests check that the two agree)
WALK_BLOCK = 128


def compact_active(active):
    """The order in which K7's any-hit launch walks the rays: within each
    block of ``WALK_BLOCK`` consecutive rays, the active ones first, in
    call order, then the inactive ones (which the kernel does not walk) ->
    order [R] i64. The kernel compacts each block in shared memory; this
    is its plain form."""
    ids = torch.arange(active.shape[0], device=active.device)
    return torch.argsort((ids // WALK_BLOCK) * 2 + (~active).long(),
                         stable=True)


def bvh_walk(o, d, t0, act, nodes, links, tri_flat, any_hit: bool):
    """K7 on CUDA tensors -> (t [R] f32, idx [R] i32).

    o, d [R, 3] or [R, 4] f32 (xyz first); t0 [R] f32; act [R] i32;
    nodes [N, 8] f32; links [8N, 2] i32; tri_flat [T, 16] f32. The
    any-hit launch walks each block's active rays compacted as
    :func:`compact_active` orders them. Raises ValueError for tensors the
    kernel does not take.
    """
    dev = o.device
    widths = {"o_f": o.shape[1], "d_f": o.shape[1], "nodes_f": 8,
              "links_i": 2, "tri_flat_f": 16}
    _build.check_inputs("bvh_walk", dev, widths, o_f=o, d_f=d, t0_f=t0,
                        act_i=act, nodes_f=nodes, links_i=links,
                        tri_flat_f=tri_flat)
    R, ws, N = o.shape[0], o.shape[1], nodes.shape[0]
    if ws not in (3, 4) or d.shape[0] != R or t0.shape != (R,) or \
            act.shape != (R,):
        raise ValueError(f"bvh_walk: rays must be [R, 3] or [R, 4] with t0 "
                         f"and act [R], got o {tuple(o.shape)}, d "
                         f"{tuple(d.shape)}, t0 {tuple(t0.shape)}, act "
                         f"{tuple(act.shape)}")
    if links.shape[0] != 8 * N:
        raise ValueError(f"bvh_walk: links must be [8N, 2] = [{8 * N}, 2], "
                         f"got {tuple(links.shape)}")
    for name, tab in (("nodes", nodes), ("links", links),
                      ("tri_flat", tri_flat)):
        if tab.data_ptr() % 16:
            raise ValueError(f"bvh_walk: {name} must be 16-byte aligned")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("mrt_bvh_walk",
                  "bvh_walk_anyhit" if any_hit else "bvh_walk_closest", dev,
                  o.data_ptr(), d.data_ptr(), t0.data_ptr(), act.data_ptr(),
                  nodes.data_ptr(), links.data_ptr(), tri_flat.data_ptr(),
                  t.data_ptr(), idx.data_ptr(), R, ws, N, int(any_hit))
    return t, idx


def traverse_bvh(scene, o, d, t_max=None, any_hit: bool = False, active=None,
                 tri_flat=None, plain: bool = False) -> TriHit:
    """Closest (or any) triangle hit per ray through the threaded BVH.

    The contract of :func:`traverse_bvh_plain`. CUDA tensors launch K7,
    CPU tensors run the plain version; ``plain=True`` runs the plain
    version on any device (for comparisons on the card). ``tri_flat`` is
    :func:`pack_tri_vertices` of the current vertices (built here when
    None).
    """
    if plain or o.device.type == "cpu":
        return traverse_bvh_plain(scene, o, d, t_max, any_hit, active,
                                  tri_flat)
    R, dev = o.shape[0], o.device
    if scene.n_tris == 0:
        return _miss(R, dev)
    if tri_flat is None:
        tri_flat = pack_tri_vertices(scene)
    t0 = (torch.full((R,), INF, device=dev) if t_max is None
          else t_max.to(torch.float32).contiguous())
    act = (torch.ones(R, dtype=torch.int32, device=dev) if active is None
           else active.to(torch.int32))
    nodes = scene.bvh_nodes_packed.detach().contiguous()
    t, idx = bvh_walk(o.detach().contiguous(), d.detach().contiguous(), t0,
                      act.contiguous(), nodes,
                      scene.bvh_links_packed.contiguous(),
                      tri_flat.detach().contiguous(), any_hit)
    return TriHit(idx, t)


def intersect_tris_brute(scene, o, d, t_max=None, chunk: int = 512,
                         tri_flat=None) -> TriHit:
    """Closest triangle over all triangles: the oracle of the walk.

    Triangle blocks of ``chunk`` are solved densely ([R, chunk] at a
    time); each block's first minimum replaces the best t with a strict
    <. There is no any-hit mode and no active mask: callers mask the
    result (a closest query with ``t_max`` answers occlusion).
    """
    R, dev = o.shape[0], o.device
    T = scene.n_tris
    if T == 0:
        return _miss(R, dev)
    o = o[:, :3].detach()[:, None, :]
    d = d[:, :3].detach()[:, None, :]
    if tri_flat is None:
        tri_flat = pack_tri_vertices(scene)
    tri_flat = tri_flat.detach()
    t_best, _ = _start(R, t_max, None, dev)
    i_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for base in range(0, T, chunk):
        tr = tri_flat[base:base + chunk][None]                  # [1, c, 16]
        t_tri, _, _ = ray_triangle(o, d, tr[..., 0:3], tr[..., 3:6],
                                   tr[..., 6:9])                # [R, c]
        t_min, k = torch.min(t_tri, dim=1)                      # first min
        better = t_min < t_best
        t_best = torch.where(better, t_min, t_best)
        i_best = torch.where(better, (base + k).to(torch.int32), i_best)
    return TriHit(i_best, torch.where(i_best >= 0, t_best,
                                      torch.full_like(t_best, INF)))
