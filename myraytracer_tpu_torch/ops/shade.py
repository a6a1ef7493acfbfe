"""Hit kinds, the secondary-ray offset and the packed shading rows (torch).

Counterpart of ``myraytracer_tpu/ops/shade.py`` for triangle-only
scenes: the packed rows and the differentiable hit resolve.
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
spheres, planes or cylinders are not ported yet. The pack is an ordinary
differentiable function of the scene's tensors (no detach): built once
per training pass, its gather backward carries the row cotangents back
to ``vertex_pos``, ``vertex_normal`` and the material table once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myraytracer_tpu_torch.ops import intersect as isx
from myraytracer_tpu_torch.utils import vecmath as vm

# hit kinds
KIND_MISS = 0
KIND_SPHERE = 1
KIND_PLANE = 2
KIND_TRI = 3
KIND_CYL = 4

#: self-intersection offset for secondary rays
EPS_OFFSET = 1e-4


class Hit(NamedTuple):
    """Differentiable per-ray surface interaction."""

    valid: torch.Tensor       # [R] bool
    t: torch.Tensor           # [R]
    point: torch.Tensor       # [R, 3]
    normal: torch.Tensor      # [R, 3] (unnormalised for PHONG meshes)
    diffuse: torch.Tensor     # [R, 3]
    ambient: torch.Tensor     # [R, 3]
    specular: torch.Tensor    # [R, 3]
    mirror: torch.Tensor      # [R]
    shininess: torch.Tensor   # [R]
    shadowable: torch.Tensor  # [R] float 0/1


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


def resolve_hit(scene, o, d, kind, idx, geom: ShadeGeom) -> Hit:
    """Recompute the surface interaction of each ray's recorded hit.

    The triangle branch of the reference's ``resolve_hit``: one row
    gather from ``tri_pack``, the Cramer re-solve, the flat normal from
    the vertices (PHONG meshes interpolate the corner normals,
    unnormalised), the point re-projected onto the triangle plane and
    the material from columns 32:48. Rays that hit no triangle get t 0,
    a zero normal and mirror 0; every consumer gates on ``valid``.
    """
    ti = torch.clamp(torch.clamp(idx, min=0), max=scene.n_tris - 1).long()
    rows48 = geom.tri_pack[ti]                        # [R, 48] one gather
    p0, p1, p2 = rows48[:, 0:3], rows48[:, 3:6], rows48[:, 6:9]
    t_t, alpha, beta = isx.ray_triangle(o, d, p0, p1, p2)
    gamma = 1.0 - alpha - beta
    n_flat = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    n0, n1, n2 = rows48[:, 16:19], rows48[:, 19:22], rows48[:, 22:25]
    n_phong = alpha[:, None] * n0 + beta[:, None] * n1 + gamma[:, None] * n2
    is_phong = rows48[:, 25] > 0.5
    n_t = torch.where(is_phong[:, None], n_phong, n_flat)

    is_t = kind == KIND_TRI
    zero = torch.zeros_like(t_t)
    t = torch.where(is_t, t_t, zero)
    normal = torch.where(is_t[:, None], n_t, torch.zeros_like(n_t))
    valid = kind != KIND_MISS
    point = o + t[:, None] * d
    # fp32 re-projection onto the exact plane (the identity in real
    # arithmetic): keeps near-tangent hits from self-shadowing
    point = torch.where(
        is_t[:, None],
        point - vm.dot(n_flat, point - p2)[:, None] * n_flat, point)
    mat = rows48[:, 32:48]
    return Hit(valid=valid, t=t, point=point, normal=normal,
               diffuse=mat[:, 0:3], ambient=mat[:, 3:6],
               specular=mat[:, 6:9],
               mirror=torch.where(valid, mat[:, 10], zero),
               shininess=mat[:, 9], shadowable=mat[:, 11])
