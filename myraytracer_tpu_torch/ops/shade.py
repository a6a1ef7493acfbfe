"""Hit kinds, the secondary-ray offset and the packed shading rows (torch).

Counterpart of ``myraytracer_tpu/ops/shade.py``: the packed rows and
the differentiable hit resolve. ``pack_shade_geom`` builds the row
tables that the pre kernel (ops/cuda_shade.py) reads by hit id, with the
reference layout:

  tri_pack [T, 48] f32 (triangle-only scenes) or [T, 32] (scenes that
  also hold spheres, planes or cylinders; [1, 32] zeros without
  triangles)
    [:, 0:16]   p0 p1 p2 (9) | u0 u1 u2 v0 v1 v2 (6) | pad
    [:, 16:32]  n0 n1 n2 (9) | phong flag (1) | mat id (1) |
                tex W, H, offset as floats (3, cols 27-29) | pad
    [:, 32:48]  the triangle's mat16 row
  ana16 [A, 16] f32: spheres, then planes, then cylinders ([1, 16]
  zeros without any)
    center (0-2) | aux (3-5: plane normal, cylinder axis) | radius (6) |
    height (7) | mat id (8) | pad
  mat16 [Mt, 16] f32
    diffuse3 ambient3 specular3 shininess mirror shadowable | pad

The pack is an ordinary differentiable function of the scene's tensors
(no detach): built once per training pass, its gather backward carries
the row cotangents back to ``vertex_pos``, ``vertex_normal`` and the
material table once. :func:`resolve_hit` (the training replay) covers
the triangle branch only.
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

    tri_pack: torch.Tensor  # [T, 48] or [T, 32]
    mat16: torch.Tensor     # [Mt, 16]
    ana16: torch.Tensor     # [A, 16]


def has_analytic(scene) -> bool:
    """Does the scene hold spheres, planes or cylinders?"""
    return bool(scene.n_spheres or scene.n_planes or scene.n_cylinders)


def pack_mat16(scene) -> torch.Tensor:
    """[Mt, 16] material rows."""
    nm = scene.mat_diffuse.shape[0]
    return torch.cat([
        scene.mat_diffuse, scene.mat_ambient, scene.mat_specular,
        scene.mat_shininess[:, None], scene.mat_mirror[:, None],
        scene.mat_shadowable[:, None],
        scene.mat_diffuse.new_zeros((nm, 4)),
    ], dim=1)


def _pack_ana16(scene) -> torch.Tensor:
    """[A, 16] analytic rows: spheres, then planes, then cylinders."""
    f32 = dict(dtype=torch.float32, device=scene.device)
    rows = []
    if scene.n_spheres:
        S = scene.n_spheres
        rows.append(torch.cat([
            scene.sphere_center, torch.zeros((S, 3), **f32),
            scene.sphere_radius[:, None], torch.zeros((S, 1), **f32),
            scene.sphere_mat.float()[:, None], torch.zeros((S, 7), **f32)],
            dim=1))
    if scene.n_planes:
        P = scene.n_planes
        rows.append(torch.cat([
            scene.plane_center, scene.plane_normal, torch.zeros((P, 2), **f32),
            scene.plane_mat.float()[:, None], torch.zeros((P, 7), **f32)],
            dim=1))
    if scene.n_cylinders:
        C = scene.n_cylinders
        rows.append(torch.cat([
            scene.cyl_center, scene.cyl_axis, scene.cyl_radius[:, None],
            scene.cyl_height[:, None], scene.cyl_mat.float()[:, None],
            torch.zeros((C, 7), **f32)], dim=1))
    return (torch.cat(rows).contiguous() if rows
            else torch.zeros((1, 16), **f32))


def pack_shade_geom(scene) -> ShadeGeom:
    """Build the packed rows of a scene (layout in the module doc)."""
    mat16 = pack_mat16(scene)
    ana16 = _pack_ana16(scene)
    if not scene.n_tris:
        return ShadeGeom(tri_pack=mat16.new_zeros((1, 32)),
                         mat16=mat16.contiguous(), ana16=ana16)
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
    parts = [pos9, uv6, vp.new_zeros((T, 1)),                       # 0:16
             nrm9, flag, mat_f, tex_f, vp.new_zeros((T, 2))]        # 16:32
    if not has_analytic(scene):
        parts.append(mat16[scene.tri_mat.long()])                   # 32:48
    return ShadeGeom(tri_pack=torch.cat(parts, dim=1).contiguous(),
                     mat16=mat16.contiguous(), ana16=ana16)


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
