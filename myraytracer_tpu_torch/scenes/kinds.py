"""Two small scenes that put every hit kind and textures on screen (NumPy).

``mixed_scene``: a sphere, a plane, a cylinder and a triangle mesh, two
lights, optional mirrors. ``textured_scene``: two textured quads with odd
texture sizes (the rounding and clamping of the nearest-texel fetch) and
an untextured mesh. Both are the reference's shading test scenes
(``tests/test_pallas_shade.py``). They check the analytic and texture
branches of the kernels, which the office does not reach.

``cluster_edge_scene`` (over ``cluster_edge_tris``) and
``cluster_edge_rays``: a few hundred
triangles and seeded ray batches that pin the cluster scan's edge cases
(axis-parallel rays, origins on box faces and inside boxes, finite t0,
inactive subgroups, clusters of one and of M triangles);
``edge_t_misses`` is the bar two scans' hit distances meet on them.

``api`` is the authoring API, (Scene, Material, TriangleMesh, PHONG,
FLAT, uv_sphere), the port's by default: a comparison can author the same
scene with another package's classes.
"""

from __future__ import annotations

import numpy as np
import torch

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, PHONG, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

PORT_API = (Scene, Material, TriangleMesh, PHONG, FLAT, uv_sphere)


def mixed_scene(mirror: float = 0.0, cyl: bool = True, tris: bool = True,
                w: int = 40, h: int = 40, api=PORT_API):
    """Triangles + sphere + plane (+ cylinder): every hit kind on screen."""
    S, Mat, Mesh, phong, _, sphere = api
    s = S()
    s.set_camera(eye=(0, 1.2, 5.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=55, width=w, height=h)
    s.add_light((3, 5, 4), (0.8, 0.75, 0.7))
    s.add_light((-2, 3, 2), (0.25, 0.25, 0.35))
    s.ambience = (0.15, 0.15, 0.18)
    s.background = (0.04, 0.07, 0.12)
    s.max_depth = 2
    s.add_sphere((-1.1, 0.1, 0.4), 0.6, Mat(
        diffuse=(0.2, 0.3, 0.7), specular=(0.6, 0.6, 0.6), shininess=40,
        mirror=mirror))
    s.add_plane((0, -0.9, 0), (0, 1, 0), Mat(
        diffuse=(0.5, 0.5, 0.45), mirror=mirror * 0.5))
    if cyl:
        s.add_cylinder((1.6, -0.3, -0.5), (0.1, 1, 0.15), 0.35, 1.4,
                       Mat(diffuse=(0.6, 0.5, 0.2), specular=(0.3,) * 3,
                           shininess=12))
    if tris:
        v, f = sphere(0.55, 7, 11, center=(0.4, 0.0, 0.8))
        s.add_mesh(Mesh(v, f, material=Mat(
            diffuse=(0.6, 0.2, 0.2), specular=(0.4,) * 3, shininess=25,
            mirror=mirror), draw_mode=phong))
    return s


def textured_scene(w: int = 40, h: int = 40, api=PORT_API):
    """Two textured quads (13x9 and 6x17 texels) + an untextured mesh."""
    S, Mat, Mesh, phong, flat, sphere = api
    s = S()
    s.set_camera(eye=(0, 0.4, 4.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=w, height=h)
    s.add_light((2, 3, 4), (0.9, 0.85, 0.8))
    s.ambience = (0.25, 0.25, 0.25)
    s.background = (0.1, 0.05, 0.15)

    def quad(cx, cy, size, tex):
        fv = np.asarray([[cx - size, cy - size, 0], [cx + size, cy - size, 0],
                         [cx + size, cy + size, 0], [cx - size, cy + size, 0]],
                        np.float32)
        ff = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        return Mesh(fv, ff, material=Mat(
            diffuse=(1, 0, 1), specular=(0.2,) * 3, shininess=10),
            uv_indices=ff, u_coords=np.float32([0, 1, 1, 0]),
            v_coords=np.float32([0, 0, 1, 1]), texture=tex, draw_mode=flat)

    rng = np.random.RandomState(7)
    s.add_mesh(quad(-0.8, 0.0, 0.7, rng.rand(13, 9, 3).astype(np.float32)))
    s.add_mesh(quad(0.9, 0.2, 0.6, rng.rand(6, 17, 3).astype(np.float32)))
    v, f = sphere(0.35, 6, 9, center=(0.0, -0.5, 1.2))
    s.add_mesh(Mesh(v, f, material=Mat(
        diffuse=(0.3, 0.6, 0.3), specular=(0.3,) * 3, shininess=20),
        draw_mode=phong))
    return s


#: the ray batches of cluster_edge_rays
EDGE_CASES = ("axis", "face", "inside", "t0", "inactive", "counts")

#: rays per edge batch: four subgroups of 512
EDGE_RAYS = 2048


def cluster_edge_tris(seed: int = 2) -> np.ndarray:
    """[T, 3, 3] float32 triangles whose cluster cut holds the shapes the
    cluster scan must get right: a blob of 256 tiny triangles (full
    clusters, count == M), three lone triangles far from the rest, 24
    triangles of axis-aligned quads (boxes of zero thickness, whose faces
    rays can lie in), 60 small triangles scattered wide (clusters of count
    1) and 150 larger ones packed closer (clusters of tens). 493
    triangles; at the default seed the cut gives K = 66 clusters (not a
    multiple of 32), two of count M and 56 of count 1."""
    rng = np.random.default_rng(seed)
    blob = (rng.uniform(-0.4, 0.4, (256, 1, 3))
            + rng.normal(size=(256, 3, 3)) * 0.04 + np.float32([1, 1, -6]))
    lone = (np.float32([[30, 0, 0], [0, -30, 5], [-5, 0, 30]])[:, None]
            + rng.normal(size=(3, 3, 3)))
    quads = []
    for i in range(12):
        a = i % 3                       # the axis the quad is normal to
        u, v = (a + 1) % 3, (a + 2) % 3
        c = rng.uniform(-6, 6, 3)
        corners = np.zeros((4, 3))
        corners[:, a] = np.round(c[a])  # on an integer plane
        for j, (du, dv) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
            corners[j, u] = c[u] + du
            corners[j, v] = c[v] + dv
        quads += [corners[[0, 1, 2]], corners[[0, 2, 3]]]
    wide = (rng.uniform(-12, 12, (60, 1, 3))
            + rng.normal(size=(60, 3, 3)) * 0.6)
    dense = (rng.uniform(-5, 5, (150, 1, 3))
             + rng.normal(size=(150, 3, 3)) * 1.5)
    return np.concatenate([blob, lone, np.asarray(quads), wide, dense]
                          ).astype(np.float32)


def cluster_edge_scene(seed: int = 2, api=PORT_API):
    """:func:`cluster_edge_tris` as one FLAT mesh (no light and no camera:
    the checks query the cluster scan directly)."""
    S, Mat, Mesh, _, flat, _ = api
    tri = cluster_edge_tris(seed)
    n = tri.shape[0]
    s = S()
    s.add_mesh(Mesh(tri.reshape(-1, 3), np.arange(3 * n).reshape(n, 3),
                    material=Mat(), draw_mode=flat))
    return s


def cluster_edge_rays(case: str, bbmin, bbmax, count, seed: int = 0,
                      n: int = EDGE_RAYS):
    """One edge batch against a scene's cluster boxes ([K, 3] each) and
    counts ([K]), all NumPy -> (o [n, 3], d [n, 3], t_max [n] or None,
    active [n] bool or None). The cases:

    ``axis``: directions along an axis (exact zeros, some -0.0), aimed
    at the boxes; ``face``: origins exactly on a box's face plane with a
    zero direction component along its normal (0 * inf = NaN in the slab
    test); ``inside``: origins inside boxes; ``t0``: finite t_max that
    ends rays inside the boxes; ``inactive``: one subgroup wholly
    inactive, one with inactive warps and lanes; ``counts``: rays aimed at
    the clusters of one and of M triangles.
    """
    rng = np.random.default_rng([seed, EDGE_CASES.index(case)])
    bbmin = np.asarray(bbmin, np.float32)
    bbmax = np.asarray(bbmax, np.float32)
    count = np.asarray(count)
    K = bbmin.shape[0]

    def in_boxes(ks, margin=0.0):
        lo, hi = bbmin[ks] - margin, bbmax[ks] + margin
        return (lo + rng.uniform(size=lo.shape) * (hi - lo)).astype(np.float32)

    def toward(o, tgt):
        d = tgt - o
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    t_max = active = None
    ks = rng.integers(0, K, n)
    axis = rng.integers(0, 3, n)
    rows = np.arange(n)
    if case == "axis":
        sign = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        o = in_boxes(ks, 0.5)
        o[rows, axis] -= sign * 20.0
        d = np.zeros((n, 3), np.float32)
        d[rows, axis] = sign
        d[(d == 0) & (rng.uniform(size=(n, 3)) < 0.3)] = -0.0
    elif case == "face":
        o = in_boxes(ks, 1.0)
        side = np.where(rng.uniform(size=(n, 1)) < 0.5, bbmin[ks], bbmax[ks])
        o[rows, axis] = side[rows, axis]
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[rows, axis] = np.where(rng.uniform(size=n) < 0.5, 0.0, -0.0)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif case == "inside":
        o = in_boxes(ks)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        if case == "counts":
            ks = rng.choice(np.flatnonzero((count == 1) | (count == count.max())),
                            n)
        o = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
        tgt = in_boxes(ks)
        d = toward(o, tgt)
        if case == "t0":
            dist = np.linalg.norm(tgt - o, axis=1)
            t_max = (dist * rng.uniform(0.2, 1.1, n)).astype(np.float32)
        if case == "inactive":
            lane = rows % 512
            active = rng.uniform(size=n) < 0.9
            active[:512] = False                       # subgroup 0
            sub1 = (rows >= 512) & (rows < 1024)
            active[sub1 & ((lane // 32) % 2 == 0)] = False
            active[sub1 & (rng.uniform(size=n) < 0.5)] = False
    return (o.astype(np.float32), d.astype(np.float32), t_max, active)


def edge_t_misses(cl_rows, cl_first, o, d, idx, got, want,
                  rtol: float = 5e-5):
    """Two scans' t on the rays where both hit triangle ``idx``, held to
    the edge batches' bar -> (hits outside rtol plus 2^-22 of the solve's
    rounding scale, share of hits within rtol alone); the bar is 0 and
    >= 0.99.

    The scale is (|o.N| + |N.p2|) / |s| of the hit triangle's row in
    ``cl_rows`` ([K, M, 16], ``cuda_cluster.pack_cluster_rows``): where o
    lies near the triangle's plane (origins inside boxes) the two terms
    of t = (o.N - N.p2) / s nearly cancel, so two evaluation orders of
    the same solve (with and without FMA contraction, or XLA's fused
    one) differ by a few ulps of the larger term, and a relative bar on
    t alone does not hold there. o, d [N, >= 3]; cl_first [K]; idx, got,
    want [N] (torch tensors on one device).
    """
    K, M, _ = cl_rows.shape
    first = cl_first.long()
    k = torch.searchsorted(first, idx.long(), right=True) - 1
    row = cl_rows.reshape(K * M, 16)[k * M + idx.long() - first[k]]
    n = row[:, :3]
    scale = ((o[:, :3] * n).sum(1).abs() + row[:, 3].abs()) / (
        (d[:, :3] * n).sum(1).abs())
    err = (got - want).abs()
    rel = rtol * want.abs()
    n_bad = int((err > rel + 2.0 ** -22 * scale).sum())
    return n_bad, float((err <= rel).float().mean()) if err.numel() else 1.0
