"""Triangle mesh (host-side, NumPy) with angle-weighted vertex normals.

Covers the reference ``Mesh`` data model (SURVEY.md L1; fields used at
mymesh.cpp:25-235, mytracer.cpp:221-293) and the normal-computation math
of ``Mesh::compute_normals`` (mymesh.cpp:103-163): per-face normals
``normalize(cross(p1-p0, p2-p0))`` plus angle-weighted vertex normals with
corner weight ``1 / (||u||*||v|| + u.v)``.

The mesh lives on the host in NumPy; the Scene builder packs all meshes
into flat device SoA arrays (models/scene.py), the TPU analogue of the
reference's AoS->SoA ``build_Data`` (mytracer.cpp:166-296).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from myraytracer_tpu_torch.models.material import Material

#: draw modes (reference: draw_mode_ in {FLAT=0, PHONG=1}, mymesh.cpp:228)
FLAT = 0
PHONG = 1


@dataclasses.dataclass
class TriangleMesh:
    """A single mesh: vertices, triangle indices, optional UVs + texture."""

    vertices: np.ndarray                 # [V, 3] float32
    triangles: np.ndarray                # [T, 3] int32 vertex indices
    material: Material = dataclasses.field(default_factory=Material)
    draw_mode: int = PHONG
    uv_indices: Optional[np.ndarray] = None   # [T, 3] int32 into u/v arrays
    u_coords: Optional[np.ndarray] = None     # [U] float32
    v_coords: Optional[np.ndarray] = None     # [U] float32
    texture: Optional[np.ndarray] = None      # [Ht, Wt, 3] float32 in [0,1]
    # computed by compute_normals():
    vertex_normals: Optional[np.ndarray] = None  # [V, 3]
    face_normals: Optional[np.ndarray] = None    # [T, 3]

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, np.int32).reshape(-1, 3)
        if self.uv_indices is not None:
            self.uv_indices = np.asarray(self.uv_indices, np.int32).reshape(-1, 3)
        if self.u_coords is not None:
            self.u_coords = np.asarray(self.u_coords, np.float32).ravel()
            self.v_coords = np.asarray(self.v_coords, np.float32).ravel()
        if self.texture is not None:
            self.texture = np.asarray(self.texture, np.float32)
        if self.vertex_normals is None:
            self.compute_normals()

    @property
    def has_texture(self) -> bool:
        return self.texture is not None and self.uv_indices is not None

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    def compute_normals(self) -> None:
        """Face normals + angle-weighted vertex normals.

        Math follows Mesh::compute_normals (mymesh.cpp:103-163): each
        triangle contributes its face normal to its three vertices with
        weight ``1 / (||u||*||v|| + u.v)`` per corner (eps-guarded), then
        vertex normals are normalized. Vectorized over all triangles.
        """
        eps = 1e-12
        v = self.vertices.astype(np.float64)
        t = self.triangles
        p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

        fn = np.cross(p1 - p0, p2 - p0)
        ln = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = fn / np.maximum(ln, eps)
        self.face_normals = fn.astype(np.float32)

        e0 = p1 - p0   # corner 0 uses edges (p1-p0, p0-p2->negated)
        e1 = p2 - p1
        e2 = p0 - p2
        l0 = np.linalg.norm(e0, axis=1)
        l1 = np.linalg.norm(e1, axis=1)
        l2 = np.linalg.norm(e2, axis=1)
        d0 = np.sum(e0 * -e2, axis=1)
        d1 = np.sum(e1 * -e0, axis=1)
        d2 = np.sum(e2 * -e1, axis=1)
        w0 = l0 * l2 + d0
        w1 = l1 * l0 + d1
        w2 = l2 * l1 + d2

        vn = np.zeros_like(v)
        for corner, w in ((0, w0), (1, w1), (2, w2)):
            ok = np.abs(w) > eps
            contrib = np.where(ok[:, None], fn / np.where(ok, w, 1.0)[:, None], 0.0)
            np.add.at(vn, t[:, corner], contrib)
        n = np.linalg.norm(vn, axis=1, keepdims=True)
        self.vertex_normals = (vn / np.maximum(n, eps)).astype(np.float32)

    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)
