"""Cluster-scan triangle intersection over the K1/K2 CUDA kernels.

Counterpart of ``myraytracer_tpu/ops/pallas_cluster.py``
(``intersect_clusters_pallas``). A ray batch is cut into subgroups of
``sub`` consecutive rays (spatially coherent: render.py orders rays in
screen blocks). For every subgroup:

  phase 1   a key per cluster: a lower bound on any hit t in the cluster
            by any active ray of the subgroup, INF when none can touch
            it. Closest-hit queries take the exact per-ray slab test
            (kernel K2, :func:`phase1_exact`); finite any-hit queries
            (shadow rays) take the conservative O(S*K) segment hull
            (:func:`phase1_anyhit_hull`, torch ops).
  sort      one stable sort of the keys gives the visit order and the
            sorted lower bounds; n_touched counts the finite keys.
  scan      kernel K1 (:func:`cluster_scan`) walks each subgroup's list
            front to back, runs the dense Cramer solve per touched
            cluster and stops once no active ray can improve.

Every kernel has a plain PyTorch version (``*_plain``) that runs the same
algorithm. The dispatching wrapper runs the plain version for tensors on
the CPU and launches the kernel for tensors on a CUDA device; the
``plain=True`` argument of :func:`intersect_clusters` runs the plain
versions on any device (for comparisons on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.cluster import pack_cluster_tris
from myraytracer_tpu_torch.ops.intersect import EPS_DET, EPS_HIT, INF, ray_aabb
from myraytracer_tpu_torch.ops.traverse import TriHit, pack_tri_vertices
from myraytracer_tpu_torch.utils import vecmath as vm

#: rays per compaction subgroup (one CTA of the kernels)
SUB = 512

#: subgroups per step of the plain versions: bounds their [C, SUB, K, 3]
#: (phase-1) and [C, SUB, M] (scan) intermediates to a few hundred MB at
#: the office 1080p shapes
_PLAIN_P1_CHUNK = 64
_PLAIN_SCAN_CHUNK = 128


def pack_cluster_constants(scene, tri_flat16: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """[K, 16, M] per-cluster solve constants, triangle slot innermost.

    Rows: 0-2 N = c1 x c2, 3 N.p2, 4-6 c1, 7-9 c2, 10-12 K1 = c1 x p2,
    13-15 K2 = p2 x c2, with c1 = p0 - p2 and c2 = p1 - p2.
    """
    if tri_flat16 is None:
        tri_flat16 = pack_tri_vertices(scene)
    tris = pack_cluster_tris(scene, tri_flat16)           # [K, M, 9]
    p0, p1, p2 = tris[..., 0:3], tris[..., 3:6], tris[..., 6:9]
    c1 = p0 - p2
    c2 = p1 - p2
    n = vm.cross(c1, c2)
    k1 = vm.cross(c1, p2)
    k2 = vm.cross(p2, c2)
    ndp2 = torch.sum(n * p2, dim=-1, keepdim=True)        # [K, M, 1]
    packed = torch.cat([n, ndp2, c1, c2, k1, k2], dim=-1)  # [K, M, 16]
    return packed.transpose(1, 2).contiguous()             # [K, 16, M]


def cluster_boxes(scene) -> torch.Tensor:
    """[K, 6] cluster boxes (bbmin, bbmax)."""
    return torch.cat([scene.cl_bbmin, scene.cl_bbmax], dim=1).contiguous()


# ---------------------------------------------------------------------------
# K2: exact phase-1
# ---------------------------------------------------------------------------

def phase1_exact_plain(o4, d4, t0, act, bb, sub: int = SUB) -> torch.Tensor:
    """Plain version of K2 -> key [S, K].

    key[s, k] = min over the active rays of subgroup s whose slab test
    hits box k with tmin <= t0 of max(tmin, 0); INF where none does.
    """
    S = o4.shape[0] // sub
    o = o4[:, :3].reshape(S, sub, 1, 3)
    iv = (1.0 / d4[:, :3]).reshape(S, sub, 1, 3)
    t0s = t0.reshape(S, sub, 1)
    acts = act.reshape(S, sub, 1) > 0
    bmin, bmax = bb[None, None, :, 0:3], bb[None, None, :, 3:6]
    keys = []
    for c in range(0, S, _PLAIN_P1_CHUNK):
        sl = slice(c, c + _PLAIN_P1_CHUNK)
        hit, tmin = ray_aabb(o[sl], iv[sl], bmin, bmax)    # [C, sub, K]
        touch = hit & acts[sl] & (tmin <= t0s[sl])
        val = torch.where(touch, torch.clamp(tmin, min=0.0),
                          torch.full_like(tmin, INF))
        keys.append(torch.amin(val, dim=1))
    return torch.cat(keys, dim=0)


def phase1_exact(o4, d4, t0, act, bb, sub: int = SUB) -> torch.Tensor:
    """K2 on CUDA tensors, :func:`phase1_exact_plain` on CPU tensors.

    o4, d4 [S*sub, 4] f32; t0 [S*sub] f32; act [S*sub] i32; bb [K, 6] f32.
    """
    if o4.device.type == "cpu":
        return phase1_exact_plain(o4, d4, t0, act, bb, sub)
    dev = o4.device
    _build.check_inputs("phase1_exact", dev, o4_f=o4, d4_f=d4, t0_f=t0,
                        act_i=act, bb_f=bb)
    S, K = o4.shape[0] // sub, bb.shape[0]
    key = torch.empty((S, K), dtype=torch.float32, device=dev)
    _build.launch("mrt_phase1_exact", "phase1_exact", dev,
                  o4.data_ptr(), d4.data_ptr(), t0.data_ptr(), act.data_ptr(),
                  bb.data_ptr(), key.data_ptr(), S, K, sub)
    return key


# ---------------------------------------------------------------------------
# conservative phase-1 for bundles (torch ops)
# ---------------------------------------------------------------------------

def phase1_frustum(o_s, d_s, t0_s, act_s, cl_bbmin, cl_bbmax) -> torch.Tensor:
    """Interval-arithmetic touch test of each subgroup bundle -> key [S, K].

    Origin AABB x per-axis direction range against every cluster box: a
    superset of the exact per-ray union, O(S*K). The key is a lower bound
    on any hit t in the cluster (clamped >= 0), INF when the bundle
    provably cannot reach it.
    """
    any_act = act_s.any(dim=1)                             # [S]
    big = 3e37
    a3 = act_s[:, :, None]

    def lohi(x):
        lo = torch.where(a3, x, torch.full_like(x, big)).amin(dim=1)
        hi = torch.where(a3, x, torch.full_like(x, -big)).amax(dim=1)
        return lo, hi                                      # [S, 3]

    olo, ohi = lohi(o_s)
    dlo, dhi = lohi(d_s)
    # 1/d range where the bundle's sign is constant; mixed-sign (or
    # empty) axes impose no constraint
    con = (dlo > 0.0) | (dhi < 0.0)                        # [S, 3]
    one = torch.ones_like(dlo)
    ivlo = 1.0 / torch.where(con, dhi, one)
    ivhi = 1.0 / torch.where(con, dlo, one)

    def prod_interval(alo, ahi):                           # [S, K, 3] each
        c1 = alo * ivlo[:, None]
        c2 = alo * ivhi[:, None]
        c3 = ahi * ivlo[:, None]
        c4 = ahi * ivhi[:, None]
        return (torch.minimum(torch.minimum(c1, c2), torch.minimum(c3, c4)),
                torch.maximum(torch.maximum(c1, c2), torch.maximum(c3, c4)))

    t0lo, t0hi = prod_interval(cl_bbmin[None] - ohi[:, None],
                               cl_bbmin[None] - olo[:, None])
    t1lo, t1hi = prod_interval(cl_bbmax[None] - ohi[:, None],
                               cl_bbmax[None] - olo[:, None])
    entry_lo = torch.where(con[:, None], torch.minimum(t0lo, t1lo),
                           torch.full_like(t0lo, -big))
    exit_hi = torch.where(con[:, None], torch.maximum(t0hi, t1hi),
                          torch.full_like(t0hi, big))
    lb_tmin = entry_lo.amax(dim=2)                          # [S, K]
    ub_tmax = exit_hi.amin(dim=2)

    t0_max = torch.where(act_s, t0_s, torch.zeros_like(t0_s)).amax(dim=1)
    touch = ((ub_tmax >= lb_tmin) & (ub_tmax > EPS_HIT)
             & (lb_tmin <= t0_max[:, None]) & any_act[:, None])
    return torch.where(touch, torch.clamp(lb_tmin, min=0.0),
                       torch.full_like(lb_tmin, INF))


def phase1_anyhit_hull(o_s, d_s, t0_s, act_s, cl_bbmin, cl_bbmax
                       ) -> torch.Tensor:
    """Conservative touch test + key for finite any-hit bundles -> [S, K].

    A shadow ray only tests points on the segment o -> o + t0*d, so the
    subgroup's swept volume lies in AABB(origins + endpoints), inflated
    so fp32 rounding never shrinks it past a true hit. Intersected with
    :func:`phase1_frustum`; the key is the larger of the two lower
    bounds. Both tests are supersets of the exact per-ray union, and the
    in-kernel per-ray test keeps the final result exact.
    """
    eps = 1e-4
    big = 3e37
    a3 = act_s[:, :, None]
    any_act = act_s.any(dim=1)

    # a clamped bound keeps o + t0*d finite for unbounded rays
    t0_c = torch.clamp(t0_s[:, :, None], max=big)
    e_s = o_s + t0_c * d_s                                 # endpoints
    fill_hi = torch.full_like(o_s, big)
    fill_lo = torch.full_like(o_s, -big)
    olo = torch.where(a3, o_s, fill_hi).amin(dim=1)        # [S, 3]
    ohi = torch.where(a3, o_s, fill_lo).amax(dim=1)
    elo = torch.where(a3, e_s, fill_hi).amin(dim=1)
    ehi = torch.where(a3, e_s, fill_lo).amax(dim=1)
    ulo = torch.minimum(olo, elo)
    uhi = torch.maximum(ohi, ehi)
    slack = eps * (1.0 + torch.maximum(ulo.abs(), uhi.abs()))
    ulo = ulo - slack
    uhi = uhi + slack

    overlap = ((cl_bbmin[None] <= uhi[:, None])
               & (cl_bbmax[None] >= ulo[:, None])).all(dim=2)   # [S, K]

    # t lower bound from the origin-box -> cluster-box distance
    gap = torch.clamp(torch.maximum(cl_bbmin[None] - ohi[:, None],
                                    olo[:, None] - cl_bbmax[None]), min=0.0)
    dist = torch.sqrt(torch.sum(gap * gap, dim=2))         # [S, K]
    dnorm = torch.sqrt(torch.sum(d_s * d_s, dim=2))        # [S, sub]
    dmax = torch.where(act_s, dnorm, torch.zeros_like(dnorm)).amax(dim=1)
    safe_dmax = torch.clamp(dmax, min=1e-30)
    lb_box = dist / safe_dmax[:, None] * (1.0 - eps)

    t0_max = torch.where(act_s, t0_s, torch.zeros_like(t0_s)).amax(dim=1)
    touch = (overlap & any_act[:, None]
             & (lb_box <= t0_max[:, None] * (1.0 + eps)))

    key_f = phase1_frustum(o_s, d_s, t0_s, act_s, cl_bbmin, cl_bbmax)
    key = torch.maximum(key_f, torch.clamp(lb_box, min=0.0))
    return torch.where(touch & (key_f < INF), key, torch.full_like(key, INF))


def visit_lists(key: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable co-sort of (key, cluster id) -> (order [S, K] i32,
    sorted keys [S, K], n_touched [S] i32)."""
    lb, order = torch.sort(key, dim=1, stable=True)
    n_touched = (key < INF).sum(dim=1, dtype=torch.int32)
    return order.to(torch.int32).contiguous(), lb.contiguous(), n_touched


# ---------------------------------------------------------------------------
# K1 / K1': the scan
# ---------------------------------------------------------------------------

def _solve_chunk(tc, count, first, oc, dc, ivc, tbc, ibc, ac, bbk, any_hit):
    """One visit step of the plain scan for C subgroups.

    tc [C, 16, M] constants; count, first [C]; oc, dc, ivc [C, sub, 3];
    tbc, ibc, ac [C, sub]; bbk [C, 6]. Returns updated (tb, ib).
    """
    hit, tmin = ray_aabb(oc, ivc, bbk[:, None, 0:3], bbk[:, None, 3:6])
    touch = hit & ac & (tmin <= tbc)
    if any_hit:
        touch = touch & (ibc < 0)

    o0, o1, o2 = oc[..., 0:1], oc[..., 1:2], oc[..., 2:3]   # [C, sub, 1]
    d0, d1, d2 = dc[..., 0:1], dc[..., 1:2], dc[..., 2:3]
    w0 = o1 * d2 - o2 * d1
    w1 = o2 * d0 - o0 * d2
    w2 = o0 * d1 - o1 * d0

    def dotc(row, a0, a1, a2):
        # constant rows [C, 1, M] . ray components [C, sub, 1] -> [C, sub, M]
        return (a0 * tc[:, row:row + 1] + a1 * tc[:, row + 1:row + 2]
                + a2 * tc[:, row + 2:row + 3])

    s = -dotc(0, d0, d1, d2)
    t_num = dotc(0, o0, o1, o2) - tc[:, 3:4]
    a_num = dotc(7, w0, w1, w2) + dotc(13, d0, d1, d2)
    b_num = -dotc(4, w0, w1, w2) + dotc(10, d0, d1, d2)
    s_ok = s.abs() > EPS_DET
    inv_s = torch.where(s_ok, 1.0 / torch.where(s_ok, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    t_tri = t_num * inv_s
    alpha = a_num * inv_s
    beta = b_num * inv_s
    inside = (alpha >= 0) & (beta >= 0) & (alpha + beta <= 1)
    M = tc.shape[2]
    slot_ok = (torch.arange(M, device=tc.device)[None, None, :]
               < count[:, None, None])
    ok = s_ok & (t_tri > EPS_HIT) & inside & touch[..., None] & slot_ok
    t_tri = torch.where(ok, t_tri, torch.full_like(t_tri, INF))
    if any_hit:
        hit_any = (t_tri < tbc[..., None]).any(dim=-1)
        return tbc, torch.where(hit_any, first[:, None].expand_as(ibc), ibc)
    j = torch.argmin(t_tri, dim=-1)                         # first minimum
    t_min = torch.gather(t_tri, -1, j[..., None])[..., 0]
    better = t_min < tbc
    return (torch.where(better, t_min, tbc),
            torch.where(better, first[:, None] + j.to(torch.int32), ibc))


def cluster_scan_plain(o4, d4, t0, act, bb, cl_const, order, lb, n_touched,
                       cl_first, cl_count, any_hit: bool, sub: int = SUB
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1 / K1' -> (t [S*sub] f32, idx [S*sub] i32).

    The same algorithm as the kernel: visit step g runs cluster
    order[s, g] for every subgroup s that has one and has not stopped,
    with the same strict < update, the same first-of-cluster any-hit idx
    and the same exit rule after each step.
    """
    S, K = order.shape
    o = o4[:, :3].reshape(S, sub, 3)
    d = d4[:, :3].reshape(S, sub, 3)
    iv = 1.0 / d
    tb = t0.reshape(S, sub).clone()
    ib = torch.full((S, sub), -1, dtype=torch.int32, device=o4.device)
    a = act.reshape(S, sub) > 0
    done = torch.zeros(S, dtype=torch.bool, device=o4.device)
    lb_pad = torch.cat([lb, torch.full((S, 1), INF, device=lb.device)], dim=1)
    n_max = int(n_touched.max()) if S else 0
    for g in range(n_max):
        live = torch.nonzero((n_touched > g) & ~done)[:, 0]
        if live.numel() == 0:
            break
        for c in range(0, live.numel(), _PLAIN_SCAN_CHUNK):
            sidx = live[c:c + _PLAIN_SCAN_CHUNK]
            k = order[sidx, g].long()
            tb[sidx], ib[sidx] = _solve_chunk(
                cl_const[k], cl_count[k], cl_first[k], o[sidx], d[sidx],
                iv[sidx], tb[sidx], ib[sidx], a[sidx], bb[k], any_hit)
        if any_hit:
            more = (a[live] & (ib[live] < 0)).any(dim=1)
        else:
            more = (a[live] & (lb_pad[live, g + 1:g + 2] < tb[live])).any(dim=1)
        done[live] = ~more
    return tb.reshape(-1), ib.reshape(-1)


def cluster_scan(o4, d4, t0, act, bb, cl_const, order, lb, n_touched,
                 cl_first, cl_count, any_hit: bool, sub: int = SUB
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 / K1' on CUDA tensors, :func:`cluster_scan_plain` on CPU ones.

    o4, d4 [S*sub, 4] f32; t0 [S*sub] f32; act [S*sub] i32; bb [K, 6] f32;
    cl_const [K, 16, M] f32; order [S, K] i32; lb [S, K] f32;
    n_touched [S] i32; cl_first, cl_count [K] i32.
    """
    if o4.device.type == "cpu":
        return cluster_scan_plain(o4, d4, t0, act, bb, cl_const, order, lb,
                                  n_touched, cl_first, cl_count, any_hit, sub)
    dev = o4.device
    _build.check_inputs("cluster_scan", dev, o4_f=o4, d4_f=d4, t0_f=t0,
                        act_i=act, bb_f=bb, cl_const_f=cl_const, order_i=order,
                        lb_f=lb, n_touched_i=n_touched, cl_first_i=cl_first,
                        cl_count_i=cl_count)
    S, K = order.shape
    M = cl_const.shape[2]
    t = torch.empty(S * sub, dtype=torch.float32, device=dev)
    idx = torch.empty(S * sub, dtype=torch.int32, device=dev)
    _build.launch("mrt_cluster_scan",
                  "cluster_scan_anyhit" if any_hit else "cluster_scan_closest",
                  dev, o4.data_ptr(), d4.data_ptr(), t0.data_ptr(),
                  act.data_ptr(), bb.data_ptr(), cl_const.data_ptr(),
                  order.data_ptr(), lb.data_ptr(), n_touched.data_ptr(),
                  cl_first.data_ptr(), cl_count.data_ptr(), t.data_ptr(),
                  idx.data_ptr(), S, K, M, sub, int(any_hit))
    return t, idx


# ---------------------------------------------------------------------------
# the query
# ---------------------------------------------------------------------------

def pad_rays(o, d, t_max=None, active=None, sub: int = SUB):
    """Pad a ray batch to whole subgroups -> (o4, d4, t0, act).

    o4, d4 [Rp, 4] f32 (3-wide input gets a 4th column, 0 for o and 1 for
    d); padded rays get d = 1 and act = 0. t0 is INF without ``t_max``.
    """
    R = o.shape[0]
    Rp = -(-R // sub) * sub
    pad, wpad = Rp - R, 4 - o.shape[1]
    F = torch.nn.functional
    o4 = F.pad(o, (0, wpad, 0, pad)).contiguous()
    d4 = F.pad(d, (0, wpad, 0, pad), value=1.0).contiguous()
    t0 = (torch.full((R,), INF, device=o.device) if t_max is None
          else t_max.float())
    act = (torch.ones(R, dtype=torch.int32, device=o.device) if active is None
           else active.to(torch.int32))
    return o4, d4, F.pad(t0, (0, pad)).contiguous(), F.pad(act, (0, pad)).contiguous()


def phase1_keys(scene, o4, d4, t0, act, any_hit: bool, finite: bool,
                sub: int = SUB, plain: bool = False) -> torch.Tensor:
    """Phase-1 keys [S, K]: the segment hull for finite any-hit queries,
    the exact slab compaction (K2) otherwise."""
    if any_hit and finite:
        S = o4.shape[0] // sub
        return phase1_anyhit_hull(
            o4[:, :3].reshape(S, sub, 3), d4[:, :3].reshape(S, sub, 3),
            t0.reshape(S, sub), act.reshape(S, sub) > 0,
            scene.cl_bbmin, scene.cl_bbmax)
    exact = phase1_exact_plain if plain else phase1_exact
    return exact(o4, d4, t0, act, cluster_boxes(scene), sub)


def intersect_clusters(scene, o, d, t_max=None, any_hit: bool = False,
                       active=None, cl_const=None, sub: int = SUB,
                       plain: bool = False) -> TriHit:
    """Closest (or any) triangle hit per ray through the cluster scan.

    o, d [R, 3] or [R, 4]; ``t_max`` [R] bounds the hit distance (INF
    without it); ``active`` [R] bool masks rays out; ``cl_const`` is
    :func:`pack_cluster_constants` (built here when None). Returns
    TriHit: idx -1 and t INF on a miss; any-hit queries report the first
    triangle of the occluding cluster. ``plain=True`` runs the plain
    PyTorch versions of the kernels on any device.
    """
    R = o.shape[0]
    if scene.n_tris == 0:
        return TriHit(torch.full((R,), -1, dtype=torch.int32, device=o.device),
                      torch.full((R,), INF, device=o.device))
    if cl_const is None:
        cl_const = pack_cluster_constants(scene)
    o4, d4, t0, act = pad_rays(o, d, t_max, active, sub)
    key = phase1_keys(scene, o4, d4, t0, act, any_hit, t_max is not None,
                      sub, plain)
    order, lb, n_touched = visit_lists(key)
    scan = cluster_scan_plain if plain else cluster_scan
    t, idx = scan(o4, d4, t0, act, cluster_boxes(scene), cl_const, order, lb,
                  n_touched, scene.cl_first, scene.cl_count, any_hit, sub)
    idx = idx[:R]
    t = torch.where(idx >= 0, t[:R], torch.full_like(t[:R], INF))
    return TriHit(idx, t)
