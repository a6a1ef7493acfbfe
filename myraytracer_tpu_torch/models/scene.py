"""Scene model: host-side authoring container + a dataclass of tensors.

Counterpart of ``myraytracer_tpu/models/scene.py``. ``Scene`` collects
objects, meshes and lights on the host; :meth:`Scene.build` packs them in
NumPy (flat vertex/index arrays, deduplicated material table, SAH BVH
with leaf-contiguous triangles, DP cluster cut, dead-light cull, the
``live_depth`` trim) and moves the result to ``device`` as a
:class:`SceneData` with the reference's field names. Scene data plays
the role of weights: :func:`scenedata_from_arrays` carries the
reference's packed arrays across unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.models.light import Light
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import TriangleMesh
from myraytracer_tpu_torch.ops import bvh as bvh_mod
from myraytracer_tpu_torch.ops.cluster import build_clusters


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat SoA scene: float32/int32 tensors on one device."""

    # --- analytic primitives ---
    sphere_center: torch.Tensor   # [S, 3]
    sphere_radius: torch.Tensor   # [S]
    sphere_mat: torch.Tensor      # [S] int32 -> material table
    plane_center: torch.Tensor    # [P, 3]
    plane_normal: torch.Tensor    # [P, 3]
    plane_mat: torch.Tensor       # [P] int32
    cyl_center: torch.Tensor      # [C, 3]
    cyl_axis: torch.Tensor        # [C, 3] unit
    cyl_radius: torch.Tensor      # [C]
    cyl_height: torch.Tensor      # [C]
    cyl_mat: torch.Tensor         # [C] int32

    # --- triangle geometry (BVH-ordered) ---
    vertex_pos: torch.Tensor      # [V, 3]
    vertex_normal: torch.Tensor   # [V, 3]
    tri_vidx: torch.Tensor        # [T, 3] int32
    tri_uvidx: torch.Tensor       # [T, 3] int32 (0 when mesh has no UVs)
    tri_mat: torch.Tensor         # [T] int32
    tri_flags: torch.Tensor       # [T] int32: draw mode (0 FLAT / 1 PHONG)
    tri_tex: torch.Tensor         # [T, 3] int32: (tex_w, tex_h, tex_offset); w=-1 -> untextured
    uv_u: torch.Tensor            # [U]
    uv_v: torch.Tensor            # [U]
    texels: torch.Tensor          # [X, 3] texture atlas

    # --- material table ---
    mat_ambient: torch.Tensor     # [Mt, 3]
    mat_diffuse: torch.Tensor     # [Mt, 3]
    mat_specular: torch.Tensor    # [Mt, 3]
    mat_mirror: torch.Tensor      # [Mt]
    mat_shininess: torch.Tensor   # [Mt]
    mat_shadowable: torch.Tensor  # [Mt] float 0/1

    # --- lights & globals ---
    light_pos: torch.Tensor       # [L, 3]
    light_color: torch.Tensor     # [L, 3]
    background: torch.Tensor      # [3]
    ambience: torch.Tensor        # [3]

    # --- BVH (threaded, octant-ordered; ops/bvh.py) ---
    bvh_bbmin: torch.Tensor       # [N, 3]
    bvh_bbmax: torch.Tensor       # [N, 3]
    bvh_first: torch.Tensor       # [N] int32
    bvh_count: torch.Tensor       # [N] int32 (0 = internal)
    bvh_entry: torch.Tensor       # [8, N] int32
    bvh_skip: torch.Tensor        # [8, N] int32
    bvh_nodes_packed: torch.Tensor  # [N, 8] f32: bbmin, bbmax, bits(first), bits(count)
    bvh_links_packed: torch.Tensor  # [8N, 2] i32: (entry, skip) per octant-major node
    bvh_lo: torch.Tensor          # [N] int32 first triangle under the node
    bvh_hi: torch.Tensor          # [N] int32 one past the last

    # --- cluster cut (ops/cluster.py) ---
    cl_first: torch.Tensor        # [K] int32 first triangle of cluster
    cl_count: torch.Tensor        # [K] int32
    cl_bbmin: torch.Tensor        # [K, 3]
    cl_bbmax: torch.Tensor        # [K, 3]

    # --- static config ---
    max_depth: int = 3
    max_leaf: int = 2
    cl_M: int = 128
    #: Whitted segments actually traced; 0 = unset (max_depth + 1).
    #: Scene.build sets 1 when no material has mirror > 0.
    live_depth: int = 0
    #: False when no triangle carries a texture record
    has_textures: bool = True

    @property
    def n_segments(self) -> int:
        """Number of Whitted segments to trace (see live_depth)."""
        return self.live_depth if self.live_depth > 0 else self.max_depth + 1

    @property
    def n_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def n_planes(self) -> int:
        return self.plane_center.shape[0]

    @property
    def n_cylinders(self) -> int:
        return self.cyl_center.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_vidx.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_pos.shape[0]

    @property
    def n_nodes(self) -> int:
        """BVH nodes (one placeholder node when there is no triangle)."""
        return self.bvh_bbmin.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertex_pos.device


#: names of the static (non-tensor) fields of SceneData
STATIC_FIELDS = ("max_depth", "max_leaf", "cl_M", "live_depth", "has_textures")

#: names of the tensor fields of SceneData, in declaration order
ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(SceneData)
                     if f.name not in STATIC_FIELDS)


def scenedata_from_arrays(arrays: Dict[str, np.ndarray], static: dict,
                          device) -> SceneData:
    """SceneData from packed NumPy arrays (one per tensor field).

    Carries a scene packed elsewhere (for example the reference
    package's ``Scene.build()`` leaves) onto ``device`` unchanged:
    float arrays become float32 tensors, integer arrays int32.
    """
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing scene arrays: {sorted(missing)}")

    def tensor(a):
        a = np.asarray(a)
        dtype = np.float32 if a.dtype.kind == "f" else np.int32
        return torch.from_numpy(np.array(a, dtype, order="C")).to(device)

    kw = {name: tensor(arrays[name]) for name in ARRAY_FIELDS}
    kw.update({name: static[name] for name in STATIC_FIELDS})
    return SceneData(**kw)


class Scene:
    """Host-side scene under construction. Call :meth:`build` to pack."""

    def __init__(self) -> None:
        self.camera: Camera = Camera.make(
            eye=(0.0, 0.0, 5.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
            fovy=45.0, width=256, height=256,
        )
        self.lights: List[Light] = []
        self.background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
        self.ambience: Tuple[float, float, float] = (0.2, 0.2, 0.2)
        self.max_depth: int = 3
        self._spheres: List[Tuple[np.ndarray, float, Material]] = []
        self._planes: List[Tuple[np.ndarray, np.ndarray, Material]] = []
        self._cylinders: List[Tuple[np.ndarray, np.ndarray, float, float, Material]] = []
        self._meshes: List[TriangleMesh] = []

    # --- authoring API -----------------------------------------------------
    def set_camera(self, eye, center, up, fovy, width, height) -> "Scene":
        self.camera = Camera.make(eye, center, up, fovy, width, height)
        return self

    def add_light(self, position, color) -> "Scene":
        self.lights.append(Light(tuple(position), tuple(color)))
        return self

    def add_sphere(self, center, radius: float, material: Material) -> "Scene":
        self._spheres.append((np.asarray(center, np.float32), float(radius), material))
        return self

    def add_plane(self, center, normal, material: Material) -> "Scene":
        n = np.asarray(normal, np.float64)
        n = (n / np.linalg.norm(n)).astype(np.float32)
        self._planes.append((np.asarray(center, np.float32), n, material))
        return self

    def add_cylinder(self, center, axis, radius: float, height: float,
                     material: Material) -> "Scene":
        a = np.asarray(axis, np.float64)
        a = (a / np.linalg.norm(a)).astype(np.float32)
        self._cylinders.append(
            (np.asarray(center, np.float32), a, float(radius), float(height), material))
        return self

    def add_mesh(self, mesh: TriangleMesh) -> "Scene":
        self._meshes.append(mesh)
        return self

    @property
    def meshes(self) -> List[TriangleMesh]:
        return self._meshes

    # --- packing -----------------------------------------------------------
    def pack(self, leaf_size: int = 4, cluster_size: int = 128,
             builder: str = "sah", native: Optional[bool] = None
             ) -> Tuple[Dict[str, np.ndarray], dict]:
        """Pack the scene into NumPy arrays: (arrays, static fields).

        ``leaf_size`` bounds BVH leaf occupancy, ``cluster_size`` sets
        the cluster width M, ``builder`` picks the BVH split rule ("sah"
        or "median"), ``native`` the BVH builder (ops/bvh.build_bvh): the
        C++ builder where ``g++`` is found (None, the default) or always
        (True), NumPy for False.
        """
        materials: List[Material] = []
        mat_index: dict = {}

        def mat_id(m: Material) -> int:
            # identical materials share one row of the table
            key = (tuple(m.ambient), tuple(m.diffuse), tuple(m.specular),
                   float(m.mirror), float(m.shininess), bool(m.shadowable))
            if key not in mat_index:
                mat_index[key] = len(materials)
                materials.append(m)
            return mat_index[key]

        s_center = np.zeros((len(self._spheres), 3), np.float32)
        s_radius = np.zeros((len(self._spheres),), np.float32)
        s_mat = np.zeros((len(self._spheres),), np.int32)
        for i, (c, r, m) in enumerate(self._spheres):
            s_center[i], s_radius[i], s_mat[i] = c, r, mat_id(m)

        p_center = np.zeros((len(self._planes), 3), np.float32)
        p_normal = np.zeros((len(self._planes), 3), np.float32)
        p_mat = np.zeros((len(self._planes),), np.int32)
        for i, (c, n, m) in enumerate(self._planes):
            p_center[i], p_normal[i], p_mat[i] = c, n, mat_id(m)

        nc = len(self._cylinders)
        c_center = np.zeros((nc, 3), np.float32)
        c_axis = np.zeros((nc, 3), np.float32)
        c_radius = np.zeros((nc,), np.float32)
        c_height = np.zeros((nc,), np.float32)
        c_mat = np.zeros((nc,), np.int32)
        for i, (c, a, r, h, m) in enumerate(self._cylinders):
            c_center[i], c_axis[i], c_radius[i], c_height[i], c_mat[i] = (
                c, a, r, h, mat_id(m))

        # meshes -> global flat arrays with rebased indices
        vtx_pos, vtx_nrm = [], []
        tri_vidx, tri_uvidx, tri_mat, tri_flags, tri_tex = [], [], [], [], []
        uv_u, uv_v = [], []
        texels = []
        vbase = ubase = 0
        tex_offset = 0
        for mesh in self._meshes:
            mid = mat_id(mesh.material)
            T = mesh.n_triangles
            vtx_pos.append(mesh.vertices)
            vtx_nrm.append(mesh.vertex_normals)
            tri_vidx.append(mesh.triangles.astype(np.int64) + vbase)
            tri_mat.append(np.full(T, mid, np.int32))
            tri_flags.append(np.full(T, mesh.draw_mode, np.int32))
            if mesh.has_texture:
                tri_uvidx.append(mesh.uv_indices.astype(np.int64) + ubase)
                uv_u.append(mesh.u_coords)
                uv_v.append(mesh.v_coords)
                ubase += mesh.u_coords.shape[0]
                th, tw = mesh.texture.shape[:2]
                tri_tex.append(np.tile([[tw, th, tex_offset]], (T, 1)).astype(np.int64))
                texels.append(mesh.texture.reshape(-1, 3))
                tex_offset += tw * th
            else:
                tri_uvidx.append(np.zeros((T, 3), np.int64))
                tri_tex.append(np.tile([[-1, -1, 0]], (T, 1)).astype(np.int64))
            vbase += mesh.n_vertices

        def cat(parts, empty_shape, dtype):
            if parts:
                return np.concatenate(parts, axis=0).astype(dtype)
            return np.zeros(empty_shape, dtype)

        vertex_pos = cat(vtx_pos, (0, 3), np.float32)
        vertex_normal = cat(vtx_nrm, (0, 3), np.float32)
        tri_vidx_a = cat(tri_vidx, (0, 3), np.int32)
        tri_uvidx_a = cat(tri_uvidx, (0, 3), np.int32)
        tri_mat_a = cat(tri_mat, (0,), np.int32)
        tri_flags_a = cat(tri_flags, (0,), np.int32)
        tri_tex_a = cat(tri_tex, (0, 3), np.int32)
        uv_u_a = cat(uv_u, (0,), np.float32)
        uv_v_a = cat(uv_v, (0,), np.float32)
        texels_a = cat(texels, (0, 3), np.float32)
        if uv_u_a.shape[0] == 0:
            uv_u_a = np.zeros((1,), np.float32)
            uv_v_a = np.zeros((1,), np.float32)
        if texels_a.shape[0] == 0:
            texels_a = np.zeros((1, 3), np.float32)

        # BVH over all triangles; triangles are permuted so every leaf
        # owns a contiguous range
        n_tris = tri_vidx_a.shape[0]
        max_leaf = 2
        if n_tris > 0:
            p0 = vertex_pos[tri_vidx_a[:, 0]]
            p1 = vertex_pos[tri_vidx_a[:, 1]]
            p2 = vertex_pos[tri_vidx_a[:, 2]]
            tree = bvh_mod.build_bvh(p0, p1, p2, leaf_size=leaf_size,
                                     builder=builder, native=native)
            perm = tree.order
            tri_vidx_a = tri_vidx_a[perm]
            tri_uvidx_a = tri_uvidx_a[perm]
            tri_mat_a = tri_mat_a[perm]
            tri_flags_a = tri_flags_a[perm]
            tri_tex_a = tri_tex_a[perm]
            bvh_arrays = (tree.bbmin, tree.bbmax, tree.first, tree.count,
                          tree.entry, tree.skip)
            max_leaf = tree.max_leaf
            # per-node triangle ranges, bottom-up: children always have
            # larger indices than their parent
            nn = tree.bbmin.shape[0]
            node_lo = np.zeros(nn, np.int64)
            node_hi = np.zeros(nn, np.int64)
            tleft = tree.left
            for n in range(nn - 1, -1, -1):
                if tleft[n] < 0:
                    node_lo[n] = tree.first[n]
                    node_hi[n] = tree.first[n] + tree.count[n]
                else:
                    node_lo[n] = node_lo[tleft[n]]
                    node_hi[n] = node_hi[tleft[n] + 1]
        else:
            bvh_arrays = (
                np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.zeros((1,), np.int32), np.zeros((1,), np.int32),
                np.full((8, 1), -1, np.int32), np.full((8, 1), -1, np.int32),
            )
            node_lo = np.zeros(1, np.int64)
            node_hi = np.zeros(1, np.int64)

        bbmin_a, bbmax_a, first_a, count_a, entry_a, skip_a = bvh_arrays
        nodes_packed = np.concatenate(
            [bbmin_a.astype(np.float32), bbmax_a.astype(np.float32),
             first_a.astype(np.int32).view(np.float32)[:, None],
             count_a.astype(np.int32).view(np.float32)[:, None]],
            axis=1,
        )
        links_packed = np.stack(
            [entry_a.reshape(-1), skip_a.reshape(-1)], axis=1
        ).astype(np.int32)

        # cluster cut for the cluster scan (ops/cluster.py)
        cl_M = int(cluster_size)
        if n_tris > 0:
            q0 = vertex_pos[tri_vidx_a[:, 0]]
            q1 = vertex_pos[tri_vidx_a[:, 1]]
            q2 = vertex_pos[tri_vidx_a[:, 2]]
            tbmin = np.minimum(np.minimum(q0, q1), q2)
            tbmax = np.maximum(np.maximum(q0, q1), q2)
            cl_first, cl_count, cl_bbmin, cl_bbmax = build_clusters(
                tbmin, tbmax, cl_M)
        else:
            cl_first = np.zeros((1,), np.int32)
            cl_count = np.zeros((1,), np.int32)
            cl_bbmin = np.zeros((1, 3), np.float32)
            cl_bbmax = np.zeros((1, 3), np.float32)

        if not materials:
            materials.append(Material())
        amb = np.stack([np.asarray(m.ambient, np.float32) for m in materials])
        dif = np.stack([np.asarray(m.diffuse, np.float32) for m in materials])
        spc = np.stack([np.asarray(m.specular, np.float32) for m in materials])
        mir = np.asarray([m.mirror for m in materials], np.float32)
        shi = np.asarray([m.shininess for m in materials], np.float32)
        shd = np.asarray([1.0 if m.shadowable else 0.0 for m in materials], np.float32)

        lp = np.asarray([l.position for l in self.lights], np.float32).reshape(-1, 3)
        lc = np.asarray([l.color for l in self.lights], np.float32).reshape(-1, 3)
        # a light whose color is exactly zero contributes nothing, yet
        # would trace a full shadow-ray batch per segment: cull it
        if len(lc):
            live = np.any(lc != 0.0, axis=1)
            lp, lc = lp[live], lc[live]

        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        i32 = lambda x: np.asarray(x, np.int32)    # noqa: E731
        arrays = dict(
            sphere_center=f32(s_center), sphere_radius=f32(s_radius), sphere_mat=i32(s_mat),
            plane_center=f32(p_center), plane_normal=f32(p_normal), plane_mat=i32(p_mat),
            cyl_center=f32(c_center), cyl_axis=f32(c_axis),
            cyl_radius=f32(c_radius), cyl_height=f32(c_height), cyl_mat=i32(c_mat),
            vertex_pos=f32(vertex_pos), vertex_normal=f32(vertex_normal),
            tri_vidx=i32(tri_vidx_a), tri_uvidx=i32(tri_uvidx_a),
            tri_mat=i32(tri_mat_a), tri_flags=i32(tri_flags_a), tri_tex=i32(tri_tex_a),
            uv_u=f32(uv_u_a), uv_v=f32(uv_v_a), texels=f32(texels_a),
            mat_ambient=f32(amb), mat_diffuse=f32(dif), mat_specular=f32(spc),
            mat_mirror=f32(mir), mat_shininess=f32(shi), mat_shadowable=f32(shd),
            light_pos=f32(lp), light_color=f32(lc),
            background=f32(self.background), ambience=f32(self.ambience),
            bvh_bbmin=f32(bbmin_a), bvh_bbmax=f32(bbmax_a),
            bvh_first=i32(first_a), bvh_count=i32(count_a),
            bvh_entry=i32(entry_a), bvh_skip=i32(skip_a),
            bvh_nodes_packed=f32(nodes_packed), bvh_links_packed=i32(links_packed),
            bvh_lo=i32(node_lo), bvh_hi=i32(node_hi),
            cl_first=i32(cl_first), cl_count=i32(cl_count),
            cl_bbmin=f32(cl_bbmin), cl_bbmax=f32(cl_bbmax),
        )
        static = dict(
            max_depth=int(self.max_depth), max_leaf=int(max_leaf), cl_M=cl_M,
            # mirror-free scenes never spawn segment 1+
            live_depth=(1 if (len(mir) == 0 or float(np.max(mir)) == 0.0)
                        else int(self.max_depth) + 1),
            has_textures=bool(len(tri_tex_a) and np.any(tri_tex_a[:, 0] > 0)),
        )
        return arrays, static

    def build(self, device="cuda", leaf_size: int = 4, cluster_size: int = 128,
              builder: str = "sah", native: Optional[bool] = None
              ) -> SceneData:
        """Pack the scene (:meth:`pack`) into a SceneData on ``device``.

        The default is the GPU; without one this raises, and a caller who
        wants the CPU says ``device="cpu"``.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Scene.build: no CUDA device for device={str(device)!r}; "
                "pass device='cpu' to build on the CPU")
        arrays, static = self.pack(leaf_size, cluster_size, builder, native)
        return scenedata_from_arrays(arrays, static, device)
