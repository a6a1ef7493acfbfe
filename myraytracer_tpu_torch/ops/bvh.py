"""Host-side BVH builder (NumPy) with a threaded (rope) layout.

The NumPy builder of ``myraytracer_tpu/ops/bvh.py`` copied unchanged:
median or 16-bin SAH splits, triangles physically reordered so every
leaf owns a contiguous range, and per-octant entry/skip links. The
cluster cut (ops/cluster.py) reads the leaf order.

``build_bvh`` builds the same tree with the C++ builder of ``runtime/``
(runtime/native.py) by default where ``g++`` is found, as the reference
builds natively by default; ``native=False`` is the opt-out (the
reference's ``MRT_NO_NATIVE=1``) and ``native=True`` requires it. A
native build that fails raises: there is no fallback to NumPy. Both
builders give the same arrays, bit for bit (tests/test_torch_native.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: default static leaf-size bound. The reference splits to leaves of <= 2
#: (mybvh.cpp:270); on a TPU, larger leaves are usually faster — fewer
#: lockstep traversal steps, and the extra triangle tests are dense VPU
#: work. build_bvh takes leaf_size explicitly.
MAX_LEAF = 2

#: sentinel for "traversal finished" / "no child"
SENTINEL = np.int32(-1)


@dataclasses.dataclass
class BVHArrays:
    """Flat SoA BVH, host-side. ``n_nodes`` valid entries.

    TPU analogue of BVHNodes_SoA (mybvh.h:49-55) plus threading links.
    """

    bbmin: np.ndarray        # [N, 3] float32
    bbmax: np.ndarray        # [N, 3] float32
    left: np.ndarray         # [N] int32, left child (right = left+1); -1 for leaf
    first: np.ndarray        # [N] int32, first triangle (leaf)
    count: np.ndarray        # [N] int32, triangle count (0 for internal)
    axis: np.ndarray         # [N] int32, split axis of internal nodes
    entry: np.ndarray        # [8, N] int32 threaded entry links per octant
    skip: np.ndarray         # [8, N] int32 threaded skip links per octant
    order: np.ndarray        # [T] int32: new-to-old triangle permutation
    max_leaf: int            # max triangles in any leaf (<= MAX_LEAF)

    @property
    def n_nodes(self) -> int:
        return self.bbmin.shape[0]


def build_bvh(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    leaf_size: int = MAX_LEAF,
    builder: str = "median",
    native: Optional[bool] = None,
) -> BVHArrays:
    """Build a BVH over triangles given by vertex positions.

    Args:
        v0, v1, v2: [T, 3] float arrays of triangle corner positions.
        leaf_size: stop subdividing at this many triangles (static bound
            for the vectorized leaf loop).
        builder: "median" (reference-parity median split) or "sah"
            (16-bin binned surface-area heuristic — typically 1.5-2x
            fewer node visits and tighter cluster bounds; falls back to
            median when a node's SAH finds no improving split).
        native: build with the C++ builder (runtime/native.py): None
            where ``g++`` is found (runtime/native.available), True
            always; either raises when the builder cannot be built or
            loaded. False builds with NumPy.
    Returns:
        BVHArrays with triangles permuted into leaf-contiguous order via
        ``order`` (new index i holds old triangle order[i]).
    """
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("build_bvh: no triangles")
    from myraytracer_tpu_torch.runtime import native as native_builder

    if native or (native is None and native_builder.available()):
        return native_builder.build_bvh_native(v0, v1, v2, leaf_size, builder)

    centroid = (v0 + v1 + v2) / 3.0
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    order = np.arange(T, dtype=np.int64)

    max_nodes = 2 * T - 1 if T > 1 else 1
    bbmin = np.empty((max_nodes, 3), np.float64)
    bbmax = np.empty((max_nodes, 3), np.float64)
    left = np.full(max_nodes, -1, np.int64)
    first = np.zeros(max_nodes, np.int64)
    count = np.zeros(max_nodes, np.int64)
    axis_arr = np.zeros(max_nodes, np.int64)

    nodes_used = 1
    first[0], count[0] = 0, T

    def node_bounds(n):
        sl = order[first[n] : first[n] + count[n]]
        bbmin[n] = tri_min[sl].min(axis=0)
        bbmax[n] = tri_max[sl].max(axis=0)

    node_bounds(0)

    # Iterative subdivision (explicit worklist instead of recursion).
    stack = [(0, 1)]  # (node, depth); root depth 1 as in mybvh.cpp:62
    while stack:
        n, depth = stack.pop()
        cnt = count[n]
        if cnt <= leaf_size:
            continue
        lo, hi = first[n], first[n] + cnt
        sl = order[lo:hi]

        mask = None
        ax = depth % 3
        if builder == "sah":
            pick = _sah_split(centroid[sl], tri_min[sl], tri_max[sl])
            if pick is not None:
                ax, mask = pick
        if mask is None:
            pts = centroid[sl, ax]
            split = _median(pts)
            mask = pts < split

        n_left = int(mask.sum())
        if n_left == 0 or n_left == cnt:
            # Degenerate: force an even halving (departure, see docstring).
            pts = centroid[sl, ax]
            n_left = cnt // 2
            idx = np.argsort(pts, kind="stable")
            order[lo:hi] = sl[idx]
        else:
            # Stable partition == same leaf contents as the reference's
            # two-pointer swap (order within a leaf does not affect hits).
            order[lo:hi] = np.concatenate([sl[mask], sl[~mask]])

        lc = nodes_used
        rc = lc + 1
        nodes_used += 2
        first[lc], count[lc] = lo, n_left
        first[rc], count[rc] = lo + n_left, cnt - n_left
        left[n] = lc
        count[n] = 0
        axis_arr[n] = ax
        node_bounds(lc)
        node_bounds(rc)
        stack.append((rc, depth + 1))
        stack.append((lc, depth + 1))

    N = nodes_used
    entry, skip = _thread_links(left[:N], axis_arr[:N], N)
    max_leaf = int(count[:N].max()) if N else 0

    return BVHArrays(
        bbmin=bbmin[:N].astype(np.float32),
        bbmax=bbmax[:N].astype(np.float32),
        left=left[:N].astype(np.int32),
        first=first[:N].astype(np.int32),
        count=count[:N].astype(np.int32),
        axis=axis_arr[:N].astype(np.int32),
        entry=entry,
        skip=skip,
        order=order.astype(np.int32),
        max_leaf=max(max_leaf, 1),
    )


def _sah_split(cen, tmin, tmax, n_bins: int = 16):
    """Binned SAH split: returns (axis, left_mask) or None if no split
    beats keeping the node whole. Vectorized NumPy over the node's tris.
    """
    cnt = cen.shape[0]
    best = None
    best_cost = float(cnt)  # leaf cost: cnt * 1 intersection
    node_min = tmin.min(axis=0)
    node_max = tmax.max(axis=0)
    ext = node_max - node_min
    node_sa = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if node_sa <= 0:
        return None
    for ax in range(3):
        clo = cen[:, ax].min()
        chi = cen[:, ax].max()
        if chi - clo < 1e-12:
            continue
        scale = n_bins * (1.0 - 1e-7) / (chi - clo)
        bin_id = np.minimum(((cen[:, ax] - clo) * scale).astype(np.int64),
                            n_bins - 1)
        counts = np.bincount(bin_id, minlength=n_bins)
        bmin = np.full((n_bins, 3), np.inf)
        bmax = np.full((n_bins, 3), -np.inf)
        for k in range(3):
            np.minimum.at(bmin[:, k], bin_id, tmin[:, k])
            np.maximum.at(bmax[:, k], bin_id, tmax[:, k])

        def sweep_sa(mn, mx, c):
            # cumulative bbox surface areas weighted by counts
            run_min = np.minimum.accumulate(mn, axis=0)
            run_max = np.maximum.accumulate(mx, axis=0)
            e = np.maximum(run_max - run_min, 0.0)
            sa = 2.0 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0])
            return sa, np.cumsum(c)

        sa_l, cnt_l = sweep_sa(bmin, bmax, counts)
        sa_r_rev, cnt_r_rev = sweep_sa(bmin[::-1], bmax[::-1], counts[::-1])
        sa_r = sa_r_rev[::-1]
        cnt_r = cnt_r_rev[::-1]
        # split after bin b: left = bins[0..b], right = bins[b+1..]
        costs = np.full(n_bins - 1, np.inf)
        for b in range(n_bins - 1):
            if cnt_l[b] == 0 or cnt_r[b + 1] == 0:
                continue
            costs[b] = 0.125 + (sa_l[b] * cnt_l[b] + sa_r[b + 1] * cnt_r[b + 1]) / node_sa
        b = int(np.argmin(costs))
        if costs[b] < best_cost:
            best_cost = float(costs[b])
            best = (ax, bin_id <= b)
    return best


def _median(a: np.ndarray) -> float:
    """Exact median, matching BVH::median_inplace (mybvh.cpp:346-362)."""
    n = a.shape[0]
    mid = n // 2
    if n % 2 == 1:
        return float(np.partition(a, mid)[mid])
    part = np.partition(a, [mid - 1, mid])
    return 0.5 * (float(part[mid - 1]) + float(part[mid]))


def _thread_links(left: np.ndarray, axis: np.ndarray, n_nodes: int):
    """Compute entry/skip links for all 8 direction octants.

    Octant o has bit k set iff the ray direction's k-th component is
    negative. At an internal node split on axis a, the *near* child for a
    ray is the left child when dir[a] >= 0 (left subtree holds centroids
    below the split), else the right child. The links encode, per octant,
    the DFS order that always descends the near child first — recovering
    the reference's near-child-first stack ordering
    (mytracer_gpu.cu:407-420) without any stack.
    """
    entry = np.full((8, n_nodes), SENTINEL, np.int32)
    skip = np.full((8, n_nodes), SENTINEL, np.int32)
    for o in range(8):
        neg = [(o >> k) & 1 for k in range(3)]
        # Iterative DFS carrying each node's skip target.
        stack = [(0, np.int32(-1))]
        while stack:
            n, skip_target = stack.pop()
            skip[o, n] = skip_target
            lc = left[n]
            if lc < 0:
                continue  # leaf: traversal jumps to skip after its tris
            rc = lc + 1
            near, far = (lc, rc) if not neg[axis[n]] else (rc, lc)
            entry[o, n] = near
            # visit near subtree, then far subtree, then skip_target
            stack.append((far, skip_target))
            stack.append((near, np.int32(far)))
    return entry, skip


def validate_bvh(bvh: BVHArrays, v0, v1, v2) -> None:
    """Structural invariants; raises AssertionError on the first broken one.

    ``v0/v1/v2`` must already be in BVH (leaf-contiguous) order, i.e.
    permuted by ``bvh.order``. Checks: every leaf's triangles lie inside
    its AABB; every internal node's AABB contains its children; leaf
    ranges partition [0, T).
    """
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    seen = np.zeros(bvh.order.shape[0], bool)
    eps = 1e-4

    def require(ok, what):
        if not ok:
            raise AssertionError(what)

    for n in range(bvh.n_nodes):
        if bvh.left[n] >= 0:
            for c in (bvh.left[n], bvh.left[n] + 1):
                require(np.all(bvh.bbmin[n] <= bvh.bbmin[c] + eps)
                        and np.all(bvh.bbmax[n] >= bvh.bbmax[c] - eps),
                        f"node {n}'s box does not hold child {c}'s")
        else:
            cnt = bvh.count[n]
            require(1 <= cnt <= bvh.max_leaf,
                    f"leaf {n} holds {cnt} triangles (max {bvh.max_leaf})")
            for i in range(bvh.first[n], bvh.first[n] + cnt):
                require(not seen[i], f"triangle {i} is in two leaves")
                seen[i] = True
                require(np.all(tri_min[i] >= bvh.bbmin[n] - eps)
                        and np.all(tri_max[i] <= bvh.bbmax[n] + eps),
                        f"triangle {i} lies outside leaf {n}'s box")
    require(seen.all(), f"{int((~seen).sum())} triangles are in no leaf")
