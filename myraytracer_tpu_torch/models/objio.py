"""Wavefront OBJ and OFF mesh readers, and an OBJ writer (NumPy).

Counterpart of ``myraytracer_tpu/models/objio.py``, onto the port's
``TriangleMesh`` and ``Material``. OBJ: ``v``, ``vt`` and ``f`` are read;
``vn``, ``mtllib``, ``usemtl``, ``o``, ``g`` and ``s`` are ignored (the
mesh computes its own vertex normals). Faces with more than three
vertices are fan-triangulated, and ``v/vt/vn`` index syntax (negative
indices included) is taken. OFF: the header, the counts line, the
vertices and the faces, with ``#`` comments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import PHONG, TriangleMesh


def read_obj(
    path: str,
    material: Optional[Material] = None,
    draw_mode: int = PHONG,
    texture: Optional[np.ndarray] = None,
) -> TriangleMesh:
    """Parse an OBJ file into a TriangleMesh."""
    verts, uvs_u, uvs_v = [], [], []
    faces, uv_faces = [], []
    has_uv_idx = False

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs_u.append(float(parts[1]))
                uvs_v.append(float(parts[2]) if len(parts) > 2 else 0.0)
            elif tag == "f":
                corners = []
                uv_corners = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    corners.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(comps) > 1 and comps[1]:
                        ti = int(comps[1])
                        uv_corners.append(ti - 1 if ti > 0 else len(uvs_u) + ti)
                    else:
                        uv_corners.append(0)
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])
                    uv_faces.append([uv_corners[0], uv_corners[k],
                                     uv_corners[k + 1]])
                    if any(uv_corners):
                        has_uv_idx = True

    kwargs = {}
    if uvs_u and has_uv_idx:
        kwargs.update(
            uv_indices=np.asarray(uv_faces, np.int32),
            u_coords=np.asarray(uvs_u, np.float32),
            v_coords=np.asarray(uvs_v, np.float32),
            texture=texture,
        )
    return TriangleMesh(np.asarray(verts, np.float32),
                        np.asarray(faces, np.int32),
                        material=material or Material(), draw_mode=draw_mode,
                        **kwargs)


def read_off(
    path: str,
    material: Optional[Material] = None,
    draw_mode: int = PHONG,
) -> TriangleMesh:
    """Parse an OFF file (header 'OFF', counts line, verts, faces)."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if not tokens or tokens[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    verts = np.asarray(tokens[pos:pos + 3 * nv], np.float32).reshape(nv, 3)
    pos += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[pos])
        idx = [int(t) for t in tokens[pos + 1:pos + 1 + k]]
        pos += 1 + k
        for j in range(1, k - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
    return TriangleMesh(verts, np.asarray(faces, np.int32),
                        material=material or Material(), draw_mode=draw_mode)


def read_mesh(path: str, **kwargs) -> TriangleMesh:
    """Read a mesh by its extension: ``.off`` with :func:`read_off` (which
    takes no texture), anything else with :func:`read_obj`."""
    if path.lower().endswith(".off"):
        kwargs.pop("texture", None)
        return read_off(path, **kwargs)
    return read_obj(path, **kwargs)


def write_obj(path: str, mesh: TriangleMesh) -> None:
    """Write a TriangleMesh to OBJ (vertices, faces and UVs if it has them)."""
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.u_coords is not None:
            for u, vv in zip(mesh.u_coords, mesh.v_coords):
                f.write(f"vt {u} {vv}\n")
            for tri, uvt in zip(mesh.triangles, mesh.uv_indices):
                f.write(f"f {tri[0]+1}/{uvt[0]+1} {tri[1]+1}/{uvt[1]+1} "
                        f"{tri[2]+1}/{uvt[2]+1}\n")
        else:
            for tri in mesh.triangles:
                f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
