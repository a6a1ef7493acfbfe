"""Cluster cut of the BVH leaf order (NumPy) and its dense pack (torch).

Counterpart of the build half of ``myraytracer_tpu/ops/cluster.py``: the
leaf order is cut into contiguous runs of at most M triangles by the
surface-area dynamic program, and each cluster's triangles are packed
into one dense [M, 9] block that the cluster-scan kernel
(ops/cuda_cluster.py) streams through shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

#: triangles per cluster (dense batch width)
CLUSTER_M = 128


def _kappa_rel() -> float:
    """DP-cut per-cluster penalty as a fraction of the root-box SA.

    0.0002 is the measured knee of the office sweep; the valley is flat
    below 0.001, and the value is already normalized by the root surface
    area, so it transfers across scene scales.
    """
    return 2e-4


def _dp_cut(tri_bbmin: np.ndarray, tri_bbmax: np.ndarray, m: int):
    """Optimal partition of the leaf order into runs of <= m triangles.

    The kernel's cost per (subgroup, touched cluster) visit is FIXED —
    one 8 KB DMA plus a full dense [SUB, M] solve, masked lanes
    included — and a cluster's touch probability is ~proportional to its
    AABB surface area. So the right objective for the cut is simply
    ``minimize sum of cluster-box surface areas`` over all partitions of
    the (spatially coherent, BVH-DFS) leaf order into contiguous runs of
    at most m triangles: an O(T*m) dynamic program, vectorized over the
    window axis. A tiny per-cluster epsilon breaks SA ties toward fewer,
    fuller clusters (less phase-1 work, fewer DMAs).

    Against the subtree cut on the office scene this packs 247 clusters
    at 64% mean fill into ~157 at ~99% with a LOWER total SA — the
    subtree cut wastes 36% of every dense solve on padding lanes.
    """
    T = tri_bbmin.shape[0]
    INF = np.float32(np.inf)
    # sa_w[w-1, i] = surface area of the union box of tris [i, i+w)
    bmin = tri_bbmin.copy()
    bmax = tri_bbmax.copy()
    sa_w = np.full((m, T), INF, np.float32)

    def _sa(bmin, bmax):
        e = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                      + e[:, 2] * e[:, 0])

    sa_w[0] = _sa(bmin, bmax)
    for w in range(2, min(m, T) + 1):
        bmin = np.minimum(bmin[:-1], tri_bbmin[w - 1:])
        bmax = np.maximum(bmax[:-1], tri_bbmax[w - 1:])
        sa_w[w - 1, :T - w + 1] = _sa(bmin, bmax)

    # per-cluster penalty: every cluster costs phase-1 slab work (per
    # subgroup, per cluster) + SMEM table rows + a sort key, independent
    # of its content. Expressed as a fraction of the ROOT box SA so the
    # knob is scene-scale-free. Office calibration: kernels 113 ms at
    # total SA 915 (-> ~0.12 ms per SA unit) vs phase-1 17.8 ms over 247
    # clusters (-> ~0.07 ms per cluster) puts the break-even near
    # 0.6 SA units = ~5e-4 of the root SA; measured sweep below.
    # swept on the office 1080p forward (v5e): 0.002 -> 0.1727 s (K=239),
    # 0.0005 -> 0.1632 (K=310), 0.0002 -> 0.1621 (K=380),
    # 0.0001 -> 0.1661 (K=443); vs the subtree cut's 0.2003 s (K=247).
    # The valley is flat below 0.001 — phase-1's per-cluster cost is
    # smaller than the calibration estimate because the fused kernel
    # amortizes it across subgroups.
    root_sa = float(_sa(tri_bbmin.min(0)[None], tri_bbmax.max(0)[None])[0])
    krel = _kappa_rel()

    def run_dp(eps):
        # cost[i] = best total SA of a valid partition of tris [0, i)
        cost = np.full(T + 1, INF, np.float32)
        back = np.zeros(T + 1, np.int32)
        cost[0] = 0.0
        ws = np.arange(1, m + 1)
        for i in range(1, T + 1):
            w = ws[:min(i, m)]
            cand = cost[i - w] + sa_w[w - 1, i - w] + eps
            j = int(np.argmin(cand))
            cost[i] = cand[j]
            back[i] = i - int(w[j])
        cuts = []
        i = T
        while i > 0:
            cuts.append((back[i], i))
            i = back[i]
        cuts.reverse()
        return cuts

    eps = np.float32(max(krel * root_sa, 1e-12))
    cuts = run_dp(eps)
    # lane-boundary snap: the phase-1 key/visit arrays pad K to a
    # multiple of 128 columns (ops/pallas_cluster._phase1_exact_pallas),
    # so a K barely over a multiple pays a whole extra column block of
    # slab tests for a handful of clusters. When K lands within 24 of
    # the lower multiple, raise kappa until the cut fits it — the SA
    # valley is flat there (PERF.md round-4 sweep: K 310 vs 380 is
    # within 0.7% forward), so the snap is near-free in solve work and
    # saves the padded phase-1 columns outright.
    target = (len(cuts) // 128) * 128
    if target >= 128 and len(cuts) - target <= 24:
        eps_try = eps
        for _ in range(8):
            eps_try = np.float32(eps_try * 1.35)
            cand = run_dp(eps_try)
            if len(cand) <= target:
                cuts = cand
                break
    first = np.asarray([a for a, _ in cuts], np.int32)
    count = np.asarray([b - a for a, b in cuts], np.int32)
    K = len(cuts)
    cl_bbmin = np.empty((K, 3), np.float32)
    cl_bbmax = np.empty((K, 3), np.float32)
    for k, (a, b) in enumerate(cuts):
        cl_bbmin[k] = tri_bbmin[a:b].min(0)
        cl_bbmax[k] = tri_bbmax[a:b].max(0)
    return first, count, cl_bbmin, cl_bbmax


def build_clusters(tri_bbmin, tri_bbmax, m: int = CLUSTER_M):
    """Cut the leaf order into clusters of <= m triangles.

    ``tri_bbmin``/``tri_bbmax`` [T, 3] are the per-triangle bounds in leaf
    order. Returns (first [K], count [K], bbmin [K,3], bbmax [K,3]) in
    leaf (spatially coherent) order, from the optimal-partition DP
    (:func:`_dp_cut`), which minimizes total cluster surface area.
    """
    return _dp_cut(np.asarray(tri_bbmin, np.float32),
                   np.asarray(tri_bbmax, np.float32), m)


def pack_cluster_tris(scene, tri_flat16: torch.Tensor) -> torch.Tensor:
    """[K, M, 9] dense per-cluster triangle corners.

    Cluster k takes rows [first, first + M) of the corner table (its own
    ``count`` triangles, then its neighbors'; the kernel masks slots
    >= count), with all-zero degenerate rows past the end.
    """
    M = scene.cl_M
    T = scene.n_tris
    tri9 = tri_flat16[:, :9]
    tri9 = torch.cat([tri9, tri9.new_zeros((M, 9))], dim=0)
    start = torch.clamp(scene.cl_first.long(), max=T)
    rows = start[:, None] + torch.arange(M, device=start.device)[None, :]
    return tri9[rows]
