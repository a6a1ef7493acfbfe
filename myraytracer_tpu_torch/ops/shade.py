"""Hit kinds, the secondary-ray offset and the packed shading rows (torch).

Counterpart of the packing half of ``myraytracer_tpu/ops/shade.py``.
``pack_shade_geom`` builds the per-triangle row table that the pre
kernel (ops/cuda_shade.py) reads by hit id, with the reference layout:

  tri_pack [T, 48] f32
    [:, 0:16]   p0 p1 p2 (9) | u0 u1 u2 v0 v1 v2 (6) | pad
    [:, 16:32]  n0 n1 n2 (9) | phong flag (1) | mat id (1) |
                tex W, H, offset as floats (3, cols 27-29) | pad
    [:, 32:48]  the triangle's mat16 row
  mat16 [Mt, 16] f32
    diffuse3 ambient3 specular3 shininess mirror shadowable | pad

Only triangle-only scenes are packed (the 48-column layout); scenes with
spheres, planes or cylinders are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# hit kinds
KIND_MISS = 0
KIND_SPHERE = 1
KIND_PLANE = 2
KIND_TRI = 3
KIND_CYL = 4

#: self-intersection offset for secondary rays
EPS_OFFSET = 1e-4


class ShadeGeom(NamedTuple):
    """Packed per-triangle and per-material rows (layout in module doc)."""

    tri_pack: torch.Tensor  # [T, 48]
    mat16: torch.Tensor     # [Mt, 16]


def pack_mat16(scene) -> torch.Tensor:
    """[Mt, 16] material rows."""
    nm = scene.mat_diffuse.shape[0]
    return torch.cat([
        scene.mat_diffuse, scene.mat_ambient, scene.mat_specular,
        scene.mat_shininess[:, None], scene.mat_mirror[:, None],
        scene.mat_shadowable[:, None],
        scene.mat_diffuse.new_zeros((nm, 4)),
    ], dim=1)


def pack_shade_geom(scene) -> ShadeGeom:
    """Build the packed rows of a triangle-only scene."""
    if not scene.n_tris or (scene.n_spheres or scene.n_planes
                            or scene.n_cylinders):
        raise NotImplementedError(
            "the port packs triangle-only scenes; spheres, planes and "
            "cylinders are not ported yet")
    mat16 = pack_mat16(scene)
    tv = scene.tri_vidx.long()
    T = tv.shape[0]
    vp = scene.vertex_pos
    pos9 = torch.cat([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], dim=1)
    if scene.has_textures:
        uv = scene.tri_uvidx.long()
        uv6 = torch.stack([
            scene.uv_u[uv[:, 0]], scene.uv_u[uv[:, 1]], scene.uv_u[uv[:, 2]],
            scene.uv_v[uv[:, 0]], scene.uv_v[uv[:, 1]], scene.uv_v[uv[:, 2]],
        ], dim=1)
    else:
        uv6 = vp.new_zeros((T, 6))
    vn = scene.vertex_normal
    nrm9 = torch.cat([vn[tv[:, 0]], vn[tv[:, 1]], vn[tv[:, 2]]], dim=1)
    flag = (scene.tri_flags == 1).float()[:, None]
    # col 26: the material id as a float, exact for ids < 2^24
    mat_f = scene.tri_mat.float()[:, None]
    tex_f = scene.tri_tex.float()
    tri_pack = torch.cat([pos9, uv6, vp.new_zeros((T, 1)),          # 0:16
                          nrm9, flag, mat_f, tex_f, vp.new_zeros((T, 2)),
                          mat16[scene.tri_mat.long()]], dim=1)     # 32:48
    return ShadeGeom(tri_pack=tri_pack.contiguous(), mat16=mat16.contiguous())
