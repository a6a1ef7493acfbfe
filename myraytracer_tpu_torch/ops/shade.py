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
material table once; the material gather's backward is K12
(ops/row_sum.py) where the table requires a gradient.
:func:`resolve_hit` (the training replay) resolves every kind and the
texture override.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myraytracer_tpu_torch.ops import intersect as isx
from myraytracer_tpu_torch.ops import row_sum
from myraytracer_tpu_torch.ops import texture as tex
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


def pack_ana16(scene) -> torch.Tensor:
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


def pack_shade_geom(scene, plain: bool = False) -> ShadeGeom:
    """Build the packed rows of a scene (layout in the module doc).

    ``plain``: the material gather's backward runs K12's plain version
    (``row_sum.gather_rows``) on any device."""
    mat16 = pack_mat16(scene)
    ana16 = pack_ana16(scene)
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
        parts.append(                                               # 32:48
            row_sum.gather_rows(mat16, scene.tri_mat, plain))
    return ShadeGeom(tri_pack=torch.cat(parts, dim=1).contiguous(),
                     mat16=mat16.contiguous(), ana16=ana16)


def ray_t_sphere(o, d, center, radius):
    """Differentiable sphere-hit distance of a known hit (no miss mask).

    The double ``where`` guards the root: rays that did not select this
    sphere still evaluate the branch, and sqrt'(0) = inf would turn
    their zero cotangents into NaN.
    """
    oc = o - center
    b = 2.0 * vm.dot(oc, d)
    a = vm.dot(d, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    pos = disc > 1e-12
    sq = vm.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    sq = torch.where(pos, sq, torch.zeros_like(sq))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return torch.where(t0 > isx.EPS_HIT, t0, t1)


def resolve_hit(scene, o, d, kind, idx, geom: ShadeGeom,
                texture_filter: str = "nearest",
                need_colors: bool = True) -> Hit:
    """Recompute the surface interaction of each ray's recorded hit.

    The reference's ``resolve_hit``: every kind's branch runs for every
    ray and ``kind`` selects. Spheres, planes and cylinders re-solve t
    from the scene's own tensors (the cylinder's normal flipped toward
    the viewer); triangles take one row gather from ``tri_pack``, the
    Cramer re-solve (which keeps the recorded hit,
    ``intersect.keeps_recorded_hit``), the flat normal from the vertices
    (PHONG meshes interpolate the corner normals, unnormalised). Every
    point is re-projected onto its surface in fp32. The material row
    comes from ``tri_pack`` columns 32:48 in triangle-only scenes and
    from ``mat16[mat_id]`` otherwise; a textured triangle's diffuse is
    the texel of ``texture.sample_nearest`` or ``sample_bilinear``
    (``texture_filter``). ``need_colors=False`` skips the colours:
    diffuse, ambient, specular and shininess come back as zeros. Rays of
    no kind get t 0, a zero normal and mirror 0; every consumer gates on
    ``valid``.
    """
    R = o.shape[0]
    safe = torch.clamp(idx, min=0).long()
    zero = o.new_zeros(R)
    t = zero
    normal = o.new_zeros((R, 3))
    override = o.new_zeros((R, 3))
    has_override = torch.zeros(R, dtype=torch.bool, device=o.device)
    mat_id = torch.zeros(R, dtype=torch.int64, device=o.device)

    if scene.n_spheres:
        si = torch.clamp(safe, max=scene.n_spheres - 1)
        c = scene.sphere_center[si]
        r = scene.sphere_radius[si]
        t_s = ray_t_sphere(o, d, c, r)
        n_s = vm.normalize(o + t_s[:, None] * d - c)
        is_s = kind == KIND_SPHERE
        t = torch.where(is_s, t_s, t)
        normal = torch.where(is_s[:, None], n_s, normal)
        mat_id = torch.where(is_s, scene.sphere_mat[si].long(), mat_id)

    if scene.n_planes:
        pi = torch.clamp(safe, max=scene.n_planes - 1)
        n_p = scene.plane_normal[pi]
        c_p = scene.plane_center[pi]
        denom = vm.dot(n_p, d)
        denom = torch.where(denom.abs() > isx.EPS_PARALLEL, denom,
                            torch.ones_like(denom))
        t_p = (vm.dot(n_p, c_p) - vm.dot(n_p, o)) / denom
        is_p = kind == KIND_PLANE
        t = torch.where(is_p, t_p, t)
        normal = torch.where(is_p[:, None], n_p, normal)
        mat_id = torch.where(is_p, scene.plane_mat[pi].long(), mat_id)

    if scene.n_cylinders:
        ci = torch.clamp(safe, max=scene.n_cylinders - 1)
        cc, ca = scene.cyl_center[ci], scene.cyl_axis[ci]
        cr, ch = scene.cyl_radius[ci], scene.cyl_height[ci]
        t_c = isx.ray_cylinder(o, d, cc, ca, cr, ch)
        t_c = torch.where(t_c < isx.INF, t_c, torch.zeros_like(t_c))
        rel = o + t_c[:, None] * d - cc
        n_c = vm.normalize(rel - vm.dot(rel, ca)[:, None] * ca)
        # the outward normal flips toward the viewer inside the tube
        n_c = torch.where(vm.dot(n_c, d)[:, None] > 0, -n_c, n_c)
        is_c = kind == KIND_CYL
        t = torch.where(is_c, t_c, t)
        normal = torch.where(is_c[:, None], n_c, normal)
        mat_id = torch.where(is_c, scene.cyl_mat[ci].long(), mat_id)

    tri_only = bool(scene.n_tris) and geom.tri_pack.shape[1] == 48
    if scene.n_tris:
        ti = torch.clamp(safe, max=scene.n_tris - 1)
        rows48 = geom.tri_pack[ti]                   # [R, 32 or 48]
        p0, p1, p2 = rows48[:, 0:3], rows48[:, 3:6], rows48[:, 6:9]
        t_t, alpha, beta = isx.ray_triangle(o, d, p0, p1, p2, recorded=True)
        gamma = 1.0 - alpha - beta
        n_flat = vm.normalize(vm.cross(p1 - p0, p2 - p0))
        n0, n1, n2 = rows48[:, 16:19], rows48[:, 19:22], rows48[:, 22:25]
        n_phong = (alpha[:, None] * n0 + beta[:, None] * n1
                   + gamma[:, None] * n2)
        is_phong = rows48[:, 25] > 0.5
        n_t = torch.where(is_phong[:, None], n_phong, n_flat)
        is_t = kind == KIND_TRI
        t = torch.where(is_t, t_t, t)
        normal = torch.where(is_t[:, None], n_t, normal)
        if not tri_only:
            # col 26: the material id as a float (exact below 2^24)
            mat_id = torch.where(is_t, rows48[:, 26].detach().long(), mat_id)
        if need_colors and scene.has_textures:
            u = (alpha * rows48[:, 9] + beta * rows48[:, 10]
                 + gamma * rows48[:, 11])
            v = (alpha * rows48[:, 12] + beta * rows48[:, 13]
                 + gamma * rows48[:, 14])
            rec = rows48[:, 27:30].detach().to(torch.int32)
            sampler = (tex.sample_bilinear if texture_filter == "bilinear"
                       else tex.sample_nearest)
            texel = sampler(scene.texels, rec, u, v)
            textured = is_t & (rec[:, 0] > 0)
            override = torch.where(textured[:, None], texel, override)
            has_override = has_override | textured

    valid = kind != KIND_MISS
    point = o + t[:, None] * d
    # fp32 re-projection onto the exact surface (the identity in real
    # arithmetic): keeps near-tangent hits from self-shadowing
    if scene.n_spheres:
        point = torch.where(is_s[:, None],
                            c + r[:, None] * vm.normalize(point - c), point)
    if scene.n_planes:
        point = torch.where(
            is_p[:, None],
            point - vm.dot(n_p, point - c_p)[:, None] * n_p, point)
    if scene.n_cylinders:
        foot = cc + vm.dot(point - cc, ca)[:, None] * ca
        point = torch.where(
            is_c[:, None], foot + cr[:, None] * vm.normalize(point - foot),
            point)
    if scene.n_tris:
        point = torch.where(
            is_t[:, None],
            point - vm.dot(n_flat, point - p2)[:, None] * n_flat, point)
    mat = rows48[:, 32:48] if tri_only else geom.mat16[mat_id]   # [R, 16]
    if need_colors:
        diffuse = torch.where(has_override[:, None], override, mat[:, 0:3])
        ambient, specular = mat[:, 3:6], mat[:, 6:9]
        shininess = mat[:, 9]
    else:
        diffuse = override
        ambient = specular = o.new_zeros((R, 3))
        shininess = zero
    return Hit(valid=valid, t=t, point=point, normal=normal,
               diffuse=diffuse, ambient=ambient, specular=specular,
               mirror=torch.where(valid, mat[:, 10], zero),
               shininess=shininess, shadowable=mat[:, 11])
