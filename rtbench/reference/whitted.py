"""The plain reference: a Whitted ray tracer in PyTorch, written from the
scene's arrays alone.

It imports nothing of the program. It takes the arrays a frozen
generator emits (``rtbench/scenes/common.py``) and works out everything
itself: triangle corners, face and vertex normals, the material table,
the camera's rays, and every hit by testing each ray against every
primitive (no acceleration structure). The semantics are the upstream
renderer's, as the program also implements them:

  closest hit  spheres, then planes, then triangles, merged with a strict
               <; a hit closer than EPS_HIT along the ray is none
  surface      the hit point re-projected onto its surface; a sphere's
               normal from its centre, a plane's its own, a triangle's the
               face normal (FLAT) or the barycentric blend of its corners'
               angle-weighted vertex normals, not renormalised (PHONG)
  shadows      per light, a ray from EPS_OFFSET off the surface toward the
               light, cast only from a shadowable material facing it;
               occluded by any primitive closer than the light
  Phong        ambience * ambient + sum over lights of colour * lit *
               (diffuse * max(n.l, 0) + specular * max(r.v, 0)^shininess),
               r the normalised mirror of l about n, the specular term 0
               unless both dot products are positive
  Whitted      a hit adds weight * (1 - mirror) * Phong, a miss adds weight
               * background; a hit goes on along d - 2 (d.n) n with weight
               * mirror, up to max_depth bounces
  lights       a light of zero colour adds nothing and is dropped, as the
               authoring model drops it (so its colour is no parameter)
  AA           the 4-neighbourhood colour deviation of the clamped 1-spp
               image, the largest ``budget`` share of pixels above the
               threshold traced again on a subp x subp grid, averaged and
               clamped to 1
  ties         where two surfaces of different materials lie at the same
               distance within rounding (coplanar faces: the office's
               return panel on its back room's right wall), no precision
               decides which is seen; ``render_aa(..., ties=True)`` marks
               the pixels whose colour such a tie can decide

Precision: ``dtype`` is the working precision (float32 for the
reference, bfloat16 for the control). In float32 the triangle test's
determinants are products of float64 factors rounded once to float32, so
the reference is no less exact than a direct float32 solve.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

EPS_HIT = 1e-5
EPS_OFFSET = 1e-4
EPS_DET = 1e-10
EPS_PARALLEL = 1e-9

KIND_MISS, KIND_SPHERE, KIND_PLANE, KIND_TRI = 0, 1, 2, 3

#: ray x primitive pairs per block of the dense tests
PAIRS = 1 << 25

#: two hits within this share of their distance are a tie
TIE = 1e-5


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Angle-weighted vertex normals of a mesh (the upstream's rule: each
    face adds its unit normal to its corners with weight 1 / (|u| |v| +
    u.v), u and v the corner's edges), in float64, then normalised."""
    v = v.astype(np.float64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = np.cross(b - a, c - a)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    out = np.zeros_like(v)
    for corner, (p, q, r) in enumerate(((a, b, c), (b, c, a), (c, a, b))):
        u, w = q - p, r - p
        wt = np.linalg.norm(u, axis=1) * np.linalg.norm(w, axis=1) + np.sum(
            u * w, axis=1)
        ok = np.abs(wt) > 1e-12
        np.add.at(out, f[:, corner],
                  np.where(ok[:, None], fn / np.where(ok, wt, 1.0)[:, None],
                           0.0))
    return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)


class RefScene:
    """The scene's arrays as tensors on ``device`` in ``dtype``."""

    def __init__(self, arrays: dict, device, dtype=torch.float32) -> None:
        self.device, self.dtype = torch.device(device), dtype

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt or dtype,
                                   device=self.device)

        lc = np.asarray(arrays["light_color"], np.float32).reshape(-1, 3)
        live = np.any(lc != 0.0, axis=1)
        self.light_pos = t(np.asarray(arrays["light_pos"]).reshape(-1, 3)[live])
        self.light_color = t(lc[live])
        self.ambience = t(arrays["ambience"])
        self.background = t(arrays["background"])
        self.max_depth = int(arrays["max_depth"])
        self.mat_ambient = t(arrays["mat_ambient"])
        self.mat_diffuse = t(arrays["mat_diffuse"])
        self.mat_specular = t(arrays["mat_specular"])
        self.mat_mirror = t(arrays["mat_mirror"])
        self.mat_shininess = t(arrays["mat_shininess"])
        self.mat_shadowable = t(arrays["mat_shadowable"])
        self.sphere_center = t(arrays["sphere_center"]).reshape(-1, 3)
        self.sphere_radius = t(arrays["sphere_radius"])
        self.sphere_mat = t(arrays["sphere_mat"], torch.long)
        pn = np.asarray(arrays["plane_normal"], np.float64).reshape(-1, 3)
        pn = (pn / np.linalg.norm(pn, axis=1, keepdims=True)).astype(np.float32)
        self.plane_center = t(arrays["plane_center"]).reshape(-1, 3)
        self.plane_normal = t(pn)
        self.plane_mat = t(arrays["plane_mat"], torch.long)
        corners, nrm, mats, phong = [], [], [], []
        for m in arrays["meshes"]:
            v, f = np.asarray(m["vertices"], np.float32), np.asarray(m["faces"])
            corners.append(v[f].reshape(-1, 9))
            vn = (vertex_normals(v, f).astype(np.float32) if m["mode"] == 1
                  else np.zeros_like(v))
            nrm.append(vn[f].reshape(-1, 9))
            mats.append(np.full(f.shape[0], m["mat"]))
            phong.append(np.full(f.shape[0], m["mode"] == 1))
        cat = (lambda xs, w: np.concatenate(xs) if xs
               else np.zeros((0, w), np.float32))
        self.corners = t(cat(corners, 9)).reshape(-1, 3, 3)     # [T, 3, 3]
        self.corner_normals = t(cat(nrm, 9)).reshape(-1, 3, 3)
        self.tri_mat = t(cat(mats, 1).reshape(-1), torch.long)
        self.tri_phong = t(cat(phong, 1).reshape(-1), torch.bool)
        self._tri_table = None

    @property
    def n_tris(self) -> int:
        return self.corners.shape[0]

    def tri_table(self) -> torch.Tensor:
        """[10, 4, T]: the triangle factors of :func:`_tri_t`, in
        the precision of the determinants (float64 for a float32 scene)."""
        if self._tri_table is None:
            dt = _det_dtype(self.dtype)
            p0, p1, p2 = self.corners.to(dt).unbind(1)
            e1, e2 = p0 - p2, p1 - p2
            n = torch.linalg.cross(e1, e2, dim=-1)
            z3 = torch.zeros_like(n)
            z1 = torch.zeros_like(n[:, :1])
            s = torch.cat([z3, -n, z3, z1], 1)
            ts = torch.cat([z3, z3, n, -(p2 * n).sum(1, keepdim=True)], 1)
            a_s = torch.cat([-e2, torch.linalg.cross(p2, e2, dim=-1), z3, z1], 1)
            b_s = torch.cat([e1, torch.linalg.cross(e1, p2, dim=-1), z3, z1], 1)
            self._tri_table = torch.stack([s, ts, a_s, b_s], 1).permute(
                2, 1, 0).contiguous()                            # [10, 4, T]
        return self._tri_table


def _det_dtype(dtype):
    return torch.float64 if dtype == torch.float32 else dtype


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    n2 = _dot(a, a)
    return a * torch.where(n2 > 1e-20, torch.rsqrt(n2.clamp(min=1e-20)),
                           torch.zeros_like(n2))[..., None]


def _tri_t(scene: RefScene, o, d):
    """t of every ray against every triangle -> [R, T], inf on a miss.

    With p0 - p2 = e1, p1 - p2 = e2, n = e1 x e2 and q = d x o, the solve
    o + t d = alpha p0 + beta p1 + (1 - alpha - beta) p2 has the
    determinants s = -d.n, t s = (o - p2).n, alpha s = -e2.q + d.(p2 x e2)
    and beta s = e1.q + d.(e1 x p2): one product of the rays' [q, d, o, 1]
    with the triangle table, in the table's precision, rounded once."""
    dt = _det_dtype(scene.dtype)
    o, d = o.to(dt), d.to(dt)
    q = torch.linalg.cross(d, o, dim=-1)
    feat = torch.cat([q, d, o, torch.ones_like(o[:, :1])], 1)   # [R, 10]
    num = (feat @ scene.tri_table().reshape(10, -1)).to(scene.dtype)
    s, ts, a_s, b_s = num.reshape(o.shape[0], 4, -1).unbind(1)
    sgn = torch.where(s < 0, -1.0, 1.0).to(s.dtype)
    sa = s.abs()
    a, b, tt = a_s * sgn, b_s * sgn, ts * sgn
    ok = (sa > EPS_DET) & (a >= 0) & (b >= 0) & (a + b <= sa) & (
        tt > EPS_HIT * sa)
    return torch.where(ok, tt / sa, torch.full_like(sa, math.inf))


def _sphere_t(scene: RefScene, o, d):
    """[R, S] nearest sphere distance above EPS_HIT, inf on a miss."""
    oc = o[:, None, :] - scene.sphere_center[None]
    b = _dot(oc, d[:, None, :])
    a = _dot(d, d)[:, None]
    c = _dot(oc, oc) - scene.sphere_radius[None] ** 2
    disc = b * b - a * c
    sq = torch.sqrt(disc.clamp(min=0))
    t0, t1 = (-b - sq) / a, (-b + sq) / a
    t = torch.where(t0 > EPS_HIT, t0, t1)
    return torch.where((disc >= 0) & (t > EPS_HIT), t,
                       torch.full_like(t, math.inf))


def _plane_t(scene: RefScene, o, d):
    """[R, P] plane distance above EPS_HIT, inf if parallel or behind."""
    n = scene.plane_normal
    cos = d @ n.T
    num = (scene.plane_center * n).sum(1)[None] - o @ n.T
    par = cos.abs() < EPS_PARALLEL
    t = num / torch.where(par, torch.ones_like(cos), cos)
    return torch.where(~par & (t > EPS_HIT), t, torch.full_like(t, math.inf))


def _blocks(n_rays: int, n_prims: int):
    step = max(1, PAIRS // max(n_prims, 1))
    return [slice(i, min(i + step, n_rays)) for i in range(0, n_rays, step)]


def closest_hit(scene: RefScene, o, d, ties: bool = False):
    """Closest primitive of each ray -> (kind [R], index [R], t [R]), and
    with ``ties`` also ``tied`` [R]: whether a primitive of another
    material lies within TIE of that distance (coplanar surfaces of two
    materials, whose nearer one no float rounding decides)."""
    R = o.shape[0]
    kind = torch.zeros(R, dtype=torch.long, device=o.device)
    idx = torch.zeros(R, dtype=torch.long, device=o.device)
    best = torch.full((R,), math.inf, dtype=scene.dtype, device=o.device)
    mat = torch.full((R,), -1, dtype=torch.long, device=o.device)
    best2 = best.clone()
    mat2 = mat.clone()
    tests = [(KIND_SPHERE, scene.sphere_center.shape[0], _sphere_t,
              scene.sphere_mat),
             (KIND_PLANE, scene.plane_center.shape[0], _plane_t,
              scene.plane_mat),
             (KIND_TRI, scene.n_tris, _tri_t, scene.tri_mat)]
    for k, n, fn, mats in tests:
        if not n:
            continue
        for sl in _blocks(R, n):
            t_all = fn(scene, o[sl], d[sl])
            if ties and n > 1:
                tt, ii = torch.topk(t_all, 2, dim=1, largest=False)
                tk, ik, tb, ib = tt[:, 0], ii[:, 0], tt[:, 1], ii[:, 1]
            else:
                tk, ik = t_all.min(1)
                tb, ib = torch.full_like(tk, math.inf), ik
            better = tk < best[sl]
            if ties:
                # the second nearest: the old best if the new one wins,
                # else the nearer of the old second and the new one
                c_t = torch.where(better, best[sl], tk)
                c_m = torch.where(better, mat[sl], mats[ik])
                c_t2 = torch.where(better, tb, best2[sl])
                c_m2 = torch.where(better, mats[ib], mat2[sl])
                near = c_t <= c_t2
                best2[sl] = torch.where(near, c_t, c_t2)
                mat2[sl] = torch.where(near, c_m, c_m2)
                mat[sl] = torch.where(better, mats[ik], mat[sl])
            best[sl] = torch.where(better, tk, best[sl])
            kind[sl] = torch.where(better, k, kind[sl])
            idx[sl] = torch.where(better, ik, idx[sl])
    if not ties:
        return kind, idx, best
    tied = (torch.isfinite(best2) & (best2 - best <= TIE * best)
            & (mat2 != mat))
    return kind, idx, best, tied


def occluded(scene: RefScene, o, d, dist):
    """Is any primitive closer than ``dist`` along each ray? [R] bool."""
    _, _, t = closest_hit(scene, o, d)
    return t < dist


class Surface(NamedTuple):
    """What a segment's hits resolve to (rows of the live rays)."""

    hit: torch.Tensor       # [R] bool
    point: torch.Tensor     # [R, 3]
    normal: torch.Tensor    # [R, 3] (PHONG normals not renormalised)
    mat: torch.Tensor       # [R] long material row


def resolve(scene: RefScene, o, d, kind, idx, t) -> Surface:
    """Point, normal and material of each ray's closest hit."""
    hit = kind != KIND_MISS
    tz = torch.where(hit, t, torch.zeros_like(t))
    g = o + tz[:, None] * d
    point, normal = torch.zeros_like(o), torch.zeros_like(o)
    mat = torch.zeros_like(idx)
    if scene.sphere_center.shape[0]:
        m = kind == KIND_SPHERE
        c = scene.sphere_center[idx[m]]
        n = _normalize(g[m] - c)
        point[m] = c + scene.sphere_radius[idx[m]][:, None] * n
        normal[m] = n
        mat[m] = scene.sphere_mat[idx[m]]
    if scene.plane_center.shape[0]:
        m = kind == KIND_PLANE
        n, c = scene.plane_normal[idx[m]], scene.plane_center[idx[m]]
        point[m] = g[m] - _dot(g[m] - c, n)[:, None] * n
        normal[m] = n
        mat[m] = scene.plane_mat[idx[m]]
    if scene.n_tris:
        m = kind == KIND_TRI
        i = idx[m]
        p0, p1, p2 = scene.corners[i].unbind(1)
        om, dm = o[m], d[m]
        # barycentrics of the hit (Moller-Trumbore on its triangle)
        e1, e2 = p1 - p0, p2 - p0
        pv = torch.linalg.cross(dm, e2, dim=-1)
        det = _dot(e1, pv)
        inv = 1.0 / torch.where(det.abs() > 0, det, torch.ones_like(det))
        tv = om - p0
        u = _dot(tv, pv) * inv
        qv = torch.linalg.cross(tv, e1, dim=-1)
        v = _dot(dm, qv) * inv
        nf = _normalize(torch.linalg.cross(p1 - p0, p2 - p0, dim=-1))
        n0, n1, n2 = scene.corner_normals[i].unbind(1)
        nph = (1 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
        gm = g[m]
        point[m] = gm - _dot(gm - p0, nf)[:, None] * nf
        normal[m] = torch.where(scene.tri_phong[i][:, None], nph, nf)
        mat[m] = scene.tri_mat[i]
    return Surface(hit, point, normal, mat)


class Lighting(NamedTuple):
    """Per light [L, R]: the unshadowed share and the Phong factors."""

    lit: torch.Tensor
    diff: torch.Tensor
    spec: torch.Tensor


def lighting(scene: RefScene, d, surf: Surface) -> Lighting:
    """Shadow rays and the Phong factors of each light at each hit."""
    lits, diffs, specs = [], [], []
    shadowable = scene.mat_shadowable[surf.mat] > 0.5
    shin = scene.mat_shininess[surf.mat]
    for lp in scene.light_pos:
        lv = lp[None] - surf.point
        dist = torch.sqrt(_dot(lv, lv))
        ldir = lv / dist.clamp(min=1e-30)[:, None]
        ndl = _dot(surf.normal, ldir)
        cast = surf.hit & shadowable & (ndl > 0)
        lit = torch.ones_like(dist)
        ci = torch.nonzero(cast)[:, 0]
        if ci.numel():
            occ = occluded(scene, surf.point[ci] + EPS_OFFSET * ldir[ci],
                           ldir[ci], dist[ci])
            lit[ci] = torch.where(occ, 0.0, 1.0).to(lit.dtype)
        diff = ndl.clamp(min=0)
        r = _normalize(2.0 * ndl[:, None] * surf.normal - ldir)
        cos_rv = (-_dot(r, d)).clamp(min=0)
        gate = (diff > 0) & (cos_rv > 0)
        spec = torch.where(gate, torch.where(gate, cos_rv, 1.0) ** shin, 0.0)
        lits.append(lit)
        diffs.append(diff)
        specs.append(spec.to(diff.dtype))
    z = surf.point.new_zeros((0, surf.point.shape[0]))
    st = (lambda xs: torch.stack(xs) if xs else z)
    return Lighting(st(lits), st(diffs), st(specs))


class Segment(NamedTuple):
    """The record of one Whitted segment over the rays still live."""

    rows: torch.Tensor      # [n] long: which rays of the batch
    weight: torch.Tensor    # [n]
    surf: Surface
    light: Lighting
    tied: Optional[torch.Tensor] = None     # [n] bool (closest_hit)


def trace_segments(scene: RefScene, o, d, ties: bool = False):
    """Follow every ray through its Whitted segments -> [Segment], each
    with its ties where ``ties``."""
    R = o.shape[0]
    rows = torch.arange(R, device=o.device)
    w = torch.ones(R, dtype=scene.dtype, device=o.device)
    out = []
    for _ in range(scene.max_depth + 1):
        if not rows.numel():
            break
        kind, idx, t, *tied = closest_hit(scene, o, d, ties)
        surf = resolve(scene, o, d, kind, idx, t)
        out.append(Segment(rows, w, surf, lighting(scene, d, surf),
                           tied[0] if tied else None))
        mirror = torch.where(surf.hit, scene.mat_mirror[surf.mat], 0.0)
        go = surf.hit & (mirror > 0)
        refl = d - 2.0 * _dot(d, surf.normal)[:, None] * surf.normal
        o = (surf.point + EPS_OFFSET * refl)[go]
        d = refl[go]
        w = (w * mirror)[go]
        rows = rows[go]
    return out


def shade(scene: RefScene, d_rows, segments, R: int,
          diffuse: Optional[torch.Tensor] = None,
          light_color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, 3] linear colour of the recorded segments; ``diffuse`` [M, 3]
    and ``light_color`` [L, 3] replace the scene's (the fitted leaves,
    through which autograd differentiates)."""
    kd = scene.mat_diffuse if diffuse is None else diffuse
    lc = scene.light_color if light_color is None else light_color
    color = kd.new_zeros((R, 3))
    for seg in segments:
        s = seg.surf
        local = scene.ambience[None] * scene.mat_ambient[s.mat]
        for li in range(lc.shape[0]):
            term = (kd[s.mat] * seg.light.diff[li][:, None]
                    + scene.mat_specular[s.mat] * seg.light.spec[li][:, None])
            local = local + lc[li][None] * seg.light.lit[li][:, None] * term
        mirror = scene.mat_mirror[s.mat]
        add = torch.where(s.hit[:, None],
                          (seg.weight * (1 - mirror))[:, None] * local,
                          seg.weight[:, None] * scene.background[None])
        color = color.index_add(0, seg.rows, add.to(color.dtype))
    return color


def trace(scene: RefScene, o, d, ties: bool = False):
    """[R, 3] linear (unclamped) Whitted colour of each ray, and with
    ``ties`` also [R] bool: whether any of its segments hit a tie."""
    segs = trace_segments(scene, o, d, ties)
    color = shade(scene, d, segs, o.shape[0])
    if not ties:
        return color
    tied = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for seg in segs:
        tied[seg.rows] |= seg.tied
    return color, tied


def camera_rays(cam: dict, xs, ys, dtype=torch.float32):
    """Pinhole rays through fractional pixel coordinates (pixel centres at
    integers, row 0 at the top) -> (o, d) [N, 3], d unit."""
    dev = xs.device

    def v(k):
        return torch.tensor(cam[k], dtype=torch.float32, device=dev)

    eye, center, up = v("eye"), v("center"), v("up")
    view = _normalize(center - eye)
    right = _normalize(torch.linalg.cross(view, up, dim=-1))
    up2 = torch.linalg.cross(right, view, dim=-1)
    W, H = cam["width"], cam["height"]
    th = math.tan(float(cam["fovy"]) * math.pi / 360.0)
    u = ((xs + 0.5) / W) * 2.0 - 1.0
    vv = 1.0 - ((ys + 0.5) / H) * 2.0
    d = _normalize(view + (u * th * (W / H))[:, None] * right
                   + (vv * th)[:, None] * up2)
    o = eye.expand_as(d)
    return o.to(dtype).contiguous(), d.to(dtype).contiguous()


def pixel_grid(cam: dict, device):
    """Raster-order pixel coordinates (xs, ys), each [H * W] float32."""
    W, H = cam["width"], cam["height"]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _trace_pixels(scene: RefScene, cam: dict, xs, ys, rows: int):
    """Colours and ties of the rays through pixel coordinates (xs, ys),
    ``rows`` rays at a time."""
    cols, tied = [], []
    for i in range(0, xs.shape[0], rows):
        o, d = camera_rays(cam, xs[i:i + rows], ys[i:i + rows], scene.dtype)
        c, t = trace(scene, o, d, ties=True)
        cols.append(c)
        tied.append(t)
    if not cols:
        z = xs.new_zeros((0,))
        return z.new_zeros((0, 3), dtype=scene.dtype), z.bool()
    return torch.cat(cols), torch.cat(tied)


def render(scene: RefScene, cam: dict, rows: int = 1 << 18,
           ties: bool = False):
    """[H, W, 3] clamped 1-spp image, and with ``ties`` also [H, W] bool:
    the pixels whose ray hit a tie."""
    xs, ys = pixel_grid(cam, scene.device)
    c, t = _trace_pixels(scene, cam, xs, ys, rows)
    H, W = cam["height"], cam["width"]
    img = c.reshape(H, W, 3).clamp(max=1.0)
    return (img, t.reshape(H, W)) if ties else img


def deviation(img: torch.Tensor) -> torch.Tensor:
    """[H, W] sum of squared colour differences to the 4 neighbours; 0 on
    the one-pixel border."""
    dev = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    dx = ((img[:, 1:] - img[:, :-1]) ** 2).sum(-1)
    dy = ((img[1:] - img[:-1]) ** 2).sum(-1)
    dev[:, :-1] += dx
    dev[:, 1:] += dx
    dev[:-1] += dy
    dev[1:] += dy
    dev[0], dev[-1], dev[:, 0], dev[:, -1] = 0, 0, 0, 0
    return dev


def _grow(m: torch.Tensor) -> torch.Tensor:
    """[H, W] bool with each set pixel's 4 neighbours set too."""
    out = m.clone()
    out[1:] |= m[:-1]
    out[:-1] |= m[1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def render_aa(scene: RefScene, cam: dict, budget: float, subp: int,
              threshold: float, rows: int = 1 << 18, ties: bool = False):
    """[H, W, 3] image with adaptive supersampling: of the pixels whose
    deviation exceeds ``threshold``, at most ``budget`` of the image (the
    largest deviations) are traced on a subp x subp grid of cell centres,
    averaged and clamped to 1. With ``ties`` also [H, W] bool, the pixels
    whose colour a tie can decide: a pixel whose ray, or a 4-neighbour's
    (which moves its deviation), hit a tie, and a refined pixel one of
    whose subrays did."""
    img, tied = render(scene, cam, rows, ties=True)
    H, W = img.shape[:2]
    K = min(max(1, int(H * W * budget)), H * W)
    top, pix = torch.topk(deviation(img).reshape(-1), K)
    pix = pix[top > threshold]
    offs = (torch.arange(subp, dtype=torch.float32, device=img.device) / subp
            - 0.5 + 1.0 / (2 * subp))
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")
    xs = ((pix % W).float()[:, None] + ox.reshape(-1)[None]).reshape(-1)
    ys = ((pix // W).float()[:, None] + oy.reshape(-1)[None]).reshape(-1)
    cols, sub_tied = _trace_pixels(scene, cam, xs, ys, rows)
    n = pix.shape[0]
    flat = img.reshape(-1, 3).clone()
    unsure = _grow(tied).reshape(-1)
    if n:
        avg = cols.reshape(n, subp * subp, 3).mean(1).clamp(max=1.0)
        flat[pix] = avg.to(flat.dtype)
        unsure[pix] |= sub_tied.reshape(n, -1).any(1)
    out = flat.reshape(H, W, 3)
    return (out, unsure.reshape(H, W)) if ties else out


def rotate_pose(cam: dict, yaw_deg: float, pitch_deg: float) -> dict:
    """The camera with its eye orbited about the look-at point: ``yaw``
    about the up axis, then ``pitch`` about the camera's right axis."""
    eye = np.asarray(cam["eye"], np.float64)
    center = np.asarray(cam["center"], np.float64)
    up = np.asarray(cam["up"], np.float64)
    up = up / np.linalg.norm(up)

    def rot(v, axis, ang):
        axis = axis / np.linalg.norm(axis)
        c, s = math.cos(ang), math.sin(ang)
        return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)

    rel = rot(eye - center, up, math.radians(yaw_deg))
    right = np.cross(-rel, up)
    rel = rot(rel, right, math.radians(pitch_deg))
    out = dict(cam)
    out["eye"] = tuple(float(x) for x in center + rel)
    return out


def state_dict(scene: RefScene) -> Dict[str, torch.Tensor]:
    """The fitted leaves' starting values, by the authoring model's names."""
    return {"mat_diffuse": scene.mat_diffuse, "light_color": scene.light_color}
