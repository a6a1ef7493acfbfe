"""Fused shading over the K3/K4 CUDA kernels, with plain versions.

Counterpart of ``myraytracer_tpu/ops/pallas_shade.py``. Two kernels per
Whitted segment, for every primitive kind and for textured meshes:

  pre    (K3, :func:`shade_pre`)    resolve each ray's hit by its kind:
         a triangle from its tri_pack row (barycentrics, flat or
         unnormalized Phong normal, the point re-projected onto the
         triangle plane, the material id from column 26, the
         nearest-texel atlas index of a textured triangle); a sphere,
         plane or cylinder from its ana16 row (the point snapped onto
         the surface, the outward normal, a cylinder's flipped toward
         the viewer). Then the LIGHT-major shadow-ray batch for the
         any-hit scan.
  phong  (K4, :func:`shade_phong`)  ambient + per-light diffuse/specular
         under the shadow mask, with a textured ray's texel in place of
         the diffuse colour, the Whitted blend, the mirror bounce.

Each wrapper runs its ``*_plain`` version for CPU tensors and launches
its kernel for CUDA tensors.

K3 also keeps its segment's counters where it is given them (``counts``,
an int64 [3] tensor on the rays' device, added to in place): the rays
that enter the segment alive (``live``), and, where the 0-d bool
``cond`` holds (or ``cond`` is None), one body run and its R rays. The
kernel adds them with atomics inside its own launch, so a captured
graph counts on every replay with no node of its own
(ops/tracer.live_rays).
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.intersect import EPS_DET
from myraytracer_tpu_torch.ops.shade import (EPS_OFFSET, KIND_CYL, KIND_PLANE,
                                             KIND_SPHERE, KIND_TRI)
from myraytracer_tpu_torch.utils.vecmath import EPS_NORMALIZE

#: mat16 columns: kd kd kd ka ka ka ks ks ks shin mirror shadowable
_M_KD, _M_KA, _M_KS, _M_SHIN, _M_MIRROR, _M_SHADOW = 0, 3, 6, 9, 10, 11

#: the atlas index is computed on float32 integers: exact below 2^24
MAX_ATLAS = 1 << 24


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _safe_rsqrt(n2):
    """vecmath.normalize's guard: near-zero vectors normalize to 0."""
    return torch.where(n2 > EPS_NORMALIZE,
                       torch.rsqrt(torch.clamp(n2, min=EPS_NORMALIZE)),
                       torch.zeros_like(n2))


def _mat_cols(mat16, mid, cols):
    """mat16[mid, c] per ray for each c in cols (0 for ids out of range)."""
    Mt = mat16.shape[0]
    ok = (mid >= 0) & (mid < Mt)
    rows = mat16[torch.where(ok, mid, torch.zeros_like(mid)).long()]
    zero = torch.zeros_like(rows[:, 0])
    return [torch.where(ok, rows[:, c], zero) for c in cols]


def _atlas_hi(atlas_size: int) -> int:
    if atlas_size >= MAX_ATLAS:
        raise ValueError(f"texture atlas of {atlas_size} texels: the atlas "
                         f"index is exact only below {MAX_ATLAS}")
    return max(int(atlas_size) - 1, 0)


def _count_plain(counts, live, cond) -> None:
    """K3's counters: live rays; where ``cond`` holds, a body and its rays."""
    ran = (torch.ones((), dtype=torch.int64, device=live.device)
           if cond is None else cond.to(torch.int64))
    counts += torch.stack([(live > 0).sum(), ran, ran * live.shape[0]])


def shade_pre_plain(o, d, t, kind, live, tri_idx, aidx, tri_pack, ana16,
                    mat16, light_pos, atlas_size: int = 1, counts=None,
                    cond=None):
    """Plain version of K3; arguments and results as :func:`shade_pre`."""
    atlas_hi = _atlas_hi(atlas_size)
    if counts is not None:
        _count_plain(counts, live, cond)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    valid = kind > 0
    zero = torch.zeros_like(t)
    # misses carry t = INF: o + INF*d would poison the gated lanes
    tt = torch.where(valid, t, zero)
    gx, gy, gz = ox + tt * dx, oy + tt * dy, oz + tt * dz

    is_t = kind == KIND_TRI
    c = tri_pack[tri_idx.long()].unbind(1)
    p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z = c[0:9]
    c1x, c1y, c1z = p0x - p2x, p0y - p2y, p0z - p2z
    c2x, c2y, c2z = p1x - p2x, p1y - p2y, p1z - p2z
    nx, ny, nz = _cross3(c1x, c1y, c1z, c2x, c2y, c2z)     # N = c1 x c2
    wx, wy, wz = _cross3(ox, oy, oz, dx, dy, dz)           # w = o x d
    k2x, k2y, k2z = _cross3(p2x, p2y, p2z, c2x, c2y, c2z)  # p2 x c2
    k1x, k1y, k1z = _cross3(c1x, c1y, c1z, p2x, p2y, p2z)  # c1 x p2

    s = -_dot3(nx, ny, nz, dx, dy, dz)
    s_ok = s.abs() > EPS_DET
    inv_s = torch.where(s_ok, 1.0 / torch.where(s_ok, s, torch.ones_like(s)),
                        zero)
    alpha = (_dot3(c2x, c2y, c2z, wx, wy, wz)
             + _dot3(k2x, k2y, k2z, dx, dy, dz)) * inv_s
    beta = (-_dot3(c1x, c1y, c1z, wx, wy, wz)
            + _dot3(k1x, k1y, k1z, dx, dy, dz)) * inv_s
    gamma = 1.0 - alpha - beta

    # unit flat normal; Phong normal left unnormalized
    inv_n = _safe_rsqrt(_dot3(nx, ny, nz, nx, ny, nz))
    fx, fy, fz = nx * inv_n, ny * inv_n, nz * inv_n
    phong = c[25] > 0.5
    tnx = torch.where(phong, alpha * c[16] + beta * c[19] + gamma * c[22], fx)
    tny = torch.where(phong, alpha * c[17] + beta * c[20] + gamma * c[23], fy)
    tnz = torch.where(phong, alpha * c[18] + beta * c[21] + gamma * c[24], fz)

    # hit point re-projected onto the triangle plane
    off = _dot3(fx, fy, fz, gx - p2x, gy - p2y, gz - p2z)
    px = torch.where(is_t, gx - off * fx, gx)
    py = torch.where(is_t, gy - off * fy, gy)
    pz = torch.where(is_t, gz - off * fz, gz)
    nmx = torch.where(is_t, tnx, zero)
    nmy = torch.where(is_t, tny, zero)
    nmz = torch.where(is_t, tnz, zero)
    midf = torch.where(is_t, c[26], zero)

    # nearest-texel atlas index: clamp UV, flip v, round half to even,
    # all on float32 integers
    u = alpha * c[9] + beta * c[10] + gamma * c[11]
    v = alpha * c[12] + beta * c[13] + gamma * c[14]
    tw = torch.clamp(c[27], min=1.0)
    th = torch.clamp(c[28], min=1.0)
    toff = torch.clamp(c[29], min=0.0)
    fpx = torch.round(torch.clamp(u, 0.0, 1.0) * (tw - 1.0))
    fpy = torch.round((1.0 - torch.clamp(v, 0.0, 1.0)) * (th - 1.0))
    flat = torch.clamp(toff + fpy * tw + fpx, 0.0, float(atlas_hi))
    texid = torch.where(is_t & (c[27] > 0.5), flat.to(torch.int32),
                        torch.full_like(kind, -1))

    # analytic kinds from their ana16 rows
    is_s, is_p, is_c = kind == KIND_SPHERE, kind == KIND_PLANE, kind == KIND_CYL
    a = ana16[aidx.long()].unbind(1)
    cx, cy, cz, bx, by, bz, rr = a[0:7]
    relx, rely, relz = gx - cx, gy - cy, gz - cz
    # sphere: n = normalize(p - c), snap p = c + r n
    inv_r = _safe_rsqrt(_dot3(relx, rely, relz, relx, rely, relz))
    nsx, nsy, nsz = relx * inv_r, rely * inv_r, relz * inv_r
    psx, psy, psz = cx + rr * nsx, cy + rr * nsy, cz + rr * nsz
    # plane: normal = aux, snap = projection onto the plane
    offp = _dot3(bx, by, bz, relx, rely, relz)
    ppx, ppy, ppz = gx - offp * bx, gy - offp * by, gz - offp * bz
    # cylinder: snap with the unflipped normal, then flip it toward the
    # viewer for rays inside the tube
    axial = _dot3(relx, rely, relz, bx, by, bz)
    fcx, fcy, fcz = relx - axial * bx, rely - axial * by, relz - axial * bz
    inv_f = _safe_rsqrt(_dot3(fcx, fcy, fcz, fcx, fcy, fcz))
    n0x, n0y, n0z = fcx * inv_f, fcy * inv_f, fcz * inv_f
    pcx = (cx + axial * bx) + rr * n0x
    pcy = (cy + axial * by) + rr * n0y
    pcz = (cz + axial * bz) + rr * n0z
    flip = _dot3(n0x, n0y, n0z, dx, dy, dz) > 0
    ncx = torch.where(flip, -n0x, n0x)
    ncy = torch.where(flip, -n0y, n0y)
    ncz = torch.where(flip, -n0z, n0z)

    def pick(s_, p_, c_, other):
        return torch.where(is_s, s_, torch.where(is_p, p_,
                                                 torch.where(is_c, c_, other)))

    px = pick(psx, ppx, pcx, px)
    py = pick(psy, ppy, pcy, py)
    pz = pick(psz, ppz, pcz, pz)
    nmx = pick(nsx, bx, ncx, nmx)
    nmy = pick(nsy, by, ncy, nmy)
    nmz = pick(nsz, bz, ncz, nmz)
    midf = torch.where(is_s | is_p | is_c, a[8], midf)
    mid = torch.where(valid, midf, zero).to(torch.int32)

    (shadowable,) = _mat_cols(mat16, mid, (_M_SHADOW,))
    cast = valid & (live > 0) & (shadowable > 0.5)
    so, sd, st, sact = [], [], [], []
    for lx, ly, lz in light_pos.unbind(0):
        lvx, lvy, lvz = lx - px, ly - py, lz - pz
        dist2 = _dot3(lvx, lvy, lvz, lvx, lvy, lvz)
        inv = _safe_rsqrt(dist2)
        ldx, ldy, ldz = lvx * inv, lvy * inv, lvz * inv
        facing = _dot3(nmx, nmy, nmz, ldx, ldy, ldz) > 0.0
        so.append(torch.stack([px + EPS_OFFSET * ldx, py + EPS_OFFSET * ldy,
                               pz + EPS_OFFSET * ldz, zero], dim=1))
        sd.append(torch.stack([ldx, ldy, ldz, zero + 1.0], dim=1))
        st.append(torch.sqrt(dist2))
        sact.append((cast & facing).to(torch.int32))
    point = torch.stack([px, py, pz], dim=1)
    normal = torch.stack([nmx, nmy, nmz], dim=1)
    if not so:
        empty4 = o.new_zeros((0, 4))
        return (point, normal, mid, texid, empty4, empty4, o.new_zeros((0,)),
                torch.zeros(0, dtype=torch.int32, device=o.device))
    # LIGHT-major [L*R, .]
    return (point, normal, mid, texid, torch.cat(so), torch.cat(sd),
            torch.cat(st), torch.cat(sact))


def shade_pre(o, d, t, kind, live, tri_idx, aidx, tri_pack, ana16, mat16,
              light_pos, atlas_size: int = 1, counts=None, cond=None):
    """Resolve + shadow setup for a flat ray batch (K3 on CUDA tensors).

    Args: o, d [R, 3] f32; t [R] f32 closest-hit distance (INF on miss);
    kind [R] i32 hit kind (KIND_MISS for dead rays); live [R] i32;
    tri_idx [R] i32 the tri_pack row of a triangle hit, aidx [R] i32 the
    ana16 row of an analytic hit (each in range; the kernel reads them
    unchecked, and only for rays of their kind); tri_pack [T, 32 or 48]
    f32; ana16 [A, 16] f32; mat16 [Mt, 16] f32; light_pos [L, 3] f32;
    atlas_size: rows of the texture atlas (below 2^24, else ValueError);
    counts: None or the segment's int64 [3] counters (live rays, bodies
    run, their rays), added to in place; cond: None or a 0-d bool, the
    segment's condition (a body and its rays count only where it holds).
    Returns (point [R, 3], normal [R, 3], mid [R] i32, texid [R] i32 the
    atlas row of a textured triangle hit and -1 elsewhere, so [L*R, 4],
    sd [L*R, 4], st [L*R], sact [L*R] i32): the shadow batch in
    LIGHT-major order, 4-wide for the any-hit cluster scan.
    """
    if o.device.type == "cpu":
        return shade_pre_plain(o, d, t, kind, live, tri_idx, aidx, tri_pack,
                               ana16, mat16, light_pos, atlas_size, counts,
                               cond)
    atlas_hi = _atlas_hi(atlas_size)
    dev = o.device
    _build.check_inputs("shade_pre", dev, widths=dict(ana16_f=16, mat16_f=16),
                        o_f=o, d_f=d, t_f=t, kind_i=kind,
                        live_i=live, tri_idx_i=tri_idx, aidx_i=aidx,
                        tri_pack_f=tri_pack, ana16_f=ana16, mat16_f=mat16,
                        light_pos_f=light_pos, **{
                            k: v for k, v in (("counts_l", counts),
                                              ("cond_b", cond))
                            if v is not None})
    if counts is not None and counts.shape != (3,):
        raise ValueError(f"shade_pre: counts must be [3], got "
                         f"{tuple(counts.shape)}")
    R, L = o.shape[0], light_pos.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    point = torch.empty((R, 3), **f32)
    normal = torch.empty((R, 3), **f32)
    mid = torch.empty(R, **i32)
    texid = torch.empty(R, **i32)
    so = torch.empty((L * R, 4), **f32)
    sd = torch.empty((L * R, 4), **f32)
    st = torch.empty(L * R, **f32)
    sact = torch.empty(L * R, **i32)
    _build.launch("mrt_shade_pre", "shade_pre", dev,
                  o.data_ptr(), d.data_ptr(), t.data_ptr(), kind.data_ptr(),
                  live.data_ptr(), tri_idx.data_ptr(), aidx.data_ptr(),
                  tri_pack.data_ptr(), tri_pack.shape[1], ana16.data_ptr(),
                  light_pos.data_ptr(), mat16.data_ptr(), mat16.shape[0],
                  atlas_hi, L, R, point.data_ptr(), normal.data_ptr(),
                  mid.data_ptr(), texid.data_ptr(), so.data_ptr(),
                  sd.data_ptr(), st.data_ptr(), sact.data_ptr(),
                  None if counts is None else counts.data_ptr(),
                  None if cond is None else cond.data_ptr())
    return point, normal, mid, texid, so, sd, st, sact


def shade_phong_plain(o, d, weight, valid, live, mid, texid, point, normal,
                      shadow, mat16, texels, light_pos, light_color, env):
    """Plain version of K4; arguments and results as :func:`shade_phong`."""
    dx, dy, dz = d.unbind(1)
    is_valid = valid > 0
    is_live = live > 0
    px, py, pz = point.unbind(1)
    nmx, nmy, nmz = normal.unbind(1)
    (kdx, kdy, kdz, kax, kay, kaz, ksx, ksy, ksz, shin, mir) = _mat_cols(
        mat16, mid, (_M_KD, _M_KD + 1, _M_KD + 2, _M_KA, _M_KA + 1, _M_KA + 2,
                     _M_KS, _M_KS + 1, _M_KS + 2, _M_SHIN, _M_MIRROR))
    # a textured hit's texel replaces the diffuse colour
    tm = texid >= 0
    tex = texels[torch.clamp(texid, min=0).long()]
    kdx = torch.where(tm, tex[:, 0], kdx)
    kdy = torch.where(tm, tex[:, 1], kdy)
    kdz = torch.where(tm, tex[:, 2], kdz)
    zero = torch.zeros_like(weight)
    mirror = torch.where(is_valid, mir, zero)

    cr, cg, cb = env[0] * kax, env[1] * kay, env[2] * kaz
    for li in range(light_pos.shape[0]):
        lx, ly, lz = light_pos[li].unbind(0)
        lvx, lvy, lvz = lx - px, ly - py, lz - pz
        inv = _safe_rsqrt(_dot3(lvx, lvy, lvz, lvx, lvy, lvz))
        ldx, ldy, ldz = lvx * inv, lvy * inv, lvz * inv
        diff = torch.clamp(_dot3(nmx, nmy, nmz, ldx, ldy, ldz), min=0.0)
        # specular: r = 2 (l.n) n - l against the raw view -d
        ln = _dot3(ldx, ldy, ldz, nmx, nmy, nmz)
        rx = 2.0 * ln * nmx - ldx
        ry = 2.0 * ln * nmy - ldy
        rz = 2.0 * ln * nmz - ldz
        rinv = _safe_rsqrt(_dot3(rx, ry, rz, rx, ry, rz))
        cos_rv = torch.clamp(-_dot3(rx, ry, rz, dx, dy, dz) * rinv, min=0.0)
        gate = (diff > 0.0) & (cos_rv > 0.0)
        base = torch.where(gate, cos_rv, zero + 1.0)
        spec = torch.where(gate, torch.exp(shin * torch.log(base)), zero)
        lit = 1.0 - shadow[li].float()
        cr = cr + light_color[li, 0] * lit * (kdx * diff + ksx * spec)
        cg = cg + light_color[li, 1] * lit * (kdy * diff + ksy * spec)
        cb = cb + light_color[li, 2] * lit * (kdz * diff + ksz * spec)

    h = is_live & is_valid
    miss = is_live & ~is_valid
    wf = weight * (1.0 - mirror)
    hf, mf = h.float(), miss.float()
    add = torch.stack([hf * wf * cr + mf * weight * env[3],
                       hf * wf * cg + mf * weight * env[4],
                       hf * wf * cb + mf * weight * env[5]], dim=1)
    # mirror bounce with the raw shading normal: d - 2 (d.n) n
    dn = _dot3(dx, dy, dz, nmx, nmy, nmz)
    rf = torch.stack([dx - 2.0 * dn * nmx, dy - 2.0 * dn * nmy,
                      dz - 2.0 * dn * nmz], dim=1)
    h3 = h[:, None]
    o2 = torch.where(h3, point + EPS_OFFSET * rf, o)
    d2 = torch.where(h3, rf, d)
    w2 = torch.where(h, weight * mirror, zero)
    return add, o2, d2, w2


def shade_phong(o, d, weight, valid, live, mid, texid, point, normal, shadow,
                mat16, texels, light_pos, light_color, env):
    """Lighting + Whitted blend + bounce (K4 on CUDA tensors).

    Args: o, d, point, normal [R, 3] f32; weight [R] f32; valid, live,
    mid [R] i32; texid [R] i32 the atlas row of a textured hit, -1
    elsewhere (the kernel reads texels[texid] unchecked where >= 0);
    shadow [L, R] i32 (1 = occluded, LIGHT-major); mat16 [Mt, 16] f32;
    texels [X, 3] f32; light_pos, light_color [L, 3] f32;
    env [6] f32 (ambience, background).
    Returns (add [R, 3], o2 [R, 3], d2 [R, 3], w2 [R]).
    """
    if o.device.type == "cpu":
        return shade_phong_plain(o, d, weight, valid, live, mid, texid, point,
                                 normal, shadow, mat16, texels, light_pos,
                                 light_color, env)
    dev = o.device
    _build.check_inputs("shade_phong", dev,
                        widths=dict(mat16_f=16, texels_f=3),
                        o_f=o, d_f=d, weight_f=weight,
                        valid_i=valid, live_i=live, mid_i=mid, texid_i=texid,
                        point_f=point, normal_f=normal, shadow_i=shadow,
                        mat16_f=mat16, texels_f=texels, light_pos_f=light_pos,
                        light_color_f=light_color, env_f=env)
    R, L = o.shape[0], light_pos.shape[0]
    add = torch.empty((R, 3), dtype=torch.float32, device=dev)
    o2 = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d2 = torch.empty((R, 3), dtype=torch.float32, device=dev)
    w2 = torch.empty(R, dtype=torch.float32, device=dev)
    _build.launch("mrt_shade_phong", "shade_phong", dev,
                  o.data_ptr(), d.data_ptr(), weight.data_ptr(),
                  valid.data_ptr(), live.data_ptr(), mid.data_ptr(),
                  texid.data_ptr(), point.data_ptr(), normal.data_ptr(),
                  shadow.data_ptr(), texels.data_ptr(), light_pos.data_ptr(),
                  light_color.data_ptr(), env.data_ptr(), mat16.data_ptr(),
                  mat16.shape[0], L, R, add.data_ptr(), o2.data_ptr(),
                  d2.data_ptr(), w2.data_ptr())
    return add, o2, d2, w2
