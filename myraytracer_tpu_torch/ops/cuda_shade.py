"""Fused shading over the K3/K4 CUDA kernels, with plain versions.

Counterpart of ``myraytracer_tpu/ops/pallas_shade.py`` for triangle-only,
untextured scenes. Two kernels per Whitted segment:

  pre    (K3, :func:`shade_pre`)    resolve the hit from the triangle's
         tri_pack row, read by hit id in the kernel: barycentrics,
         flat or (unnormalized) Phong normal, the hit point re-projected
         onto the triangle plane, the material id from column 26; then
         the LIGHT-major shadow-ray batch for the any-hit scan.
  phong  (K4, :func:`shade_phong`)  ambient + per-light diffuse/specular
         under the shadow mask, the Whitted blend, the mirror bounce.

Each wrapper runs its ``*_plain`` version for CPU tensors and launches
its kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.intersect import EPS_DET
from myraytracer_tpu_torch.ops.shade import EPS_OFFSET, KIND_TRI
from myraytracer_tpu_torch.utils.vecmath import EPS_NORMALIZE

#: mat16 columns: kd kd kd ka ka ka ks ks ks shin mirror shadowable
_M_KD, _M_KA, _M_KS, _M_SHIN, _M_MIRROR, _M_SHADOW = 0, 3, 6, 9, 10, 11


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


def shade_pre_plain(o, d, t, kind, live, tri_idx, tri_pack, mat16, light_pos):
    """Plain version of K3; arguments and results as :func:`shade_pre`."""
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
        return (point, normal, mid, empty4, empty4, o.new_zeros((0,)),
                torch.zeros(0, dtype=torch.int32, device=o.device))
    # LIGHT-major [L*R, .]
    return (point, normal, mid, torch.cat(so), torch.cat(sd), torch.cat(st),
            torch.cat(sact))


def shade_pre(o, d, t, kind, live, tri_idx, tri_pack, mat16, light_pos):
    """Resolve + shadow setup for a flat ray batch (K3 on CUDA tensors).

    Args: o, d [R, 3] f32; t [R] f32 closest-hit distance (INF on miss);
    kind [R] i32 hit kind (KIND_MISS for dead rays); live [R] i32;
    tri_idx [R] i32 the tri_pack row of each ray, in [0, T) (0 for
    non-triangle hits; the kernel reads it unchecked); tri_pack [T, 48]
    f32; mat16 [Mt, 16] f32; light_pos [L, 3] f32.
    Returns (point [R, 3], normal [R, 3], mid [R] i32, so [L*R, 4],
    sd [L*R, 4], st [L*R], sact [L*R] i32): the shadow batch in LIGHT-major
    order, 4-wide for the any-hit cluster scan.
    """
    if o.device.type == "cpu":
        return shade_pre_plain(o, d, t, kind, live, tri_idx, tri_pack, mat16,
                               light_pos)
    dev = o.device
    _build.check_inputs("shade_pre", dev, o_f=o, d_f=d, t_f=t, kind_i=kind,
                        live_i=live, tri_idx_i=tri_idx, tri_pack_f=tri_pack,
                        mat16_f=mat16, light_pos_f=light_pos)
    R, L = o.shape[0], light_pos.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    point = torch.empty((R, 3), **f32)
    normal = torch.empty((R, 3), **f32)
    mid = torch.empty(R, **i32)
    so = torch.empty((L * R, 4), **f32)
    sd = torch.empty((L * R, 4), **f32)
    st = torch.empty(L * R, **f32)
    sact = torch.empty(L * R, **i32)
    _build.launch("mrt_shade_pre", "shade_pre", dev,
                  o.data_ptr(), d.data_ptr(), t.data_ptr(), kind.data_ptr(),
                  live.data_ptr(), tri_idx.data_ptr(), tri_pack.data_ptr(),
                  tri_pack.shape[1], light_pos.data_ptr(), mat16.data_ptr(),
                  mat16.shape[0], L, R, point.data_ptr(), normal.data_ptr(),
                  mid.data_ptr(), so.data_ptr(), sd.data_ptr(), st.data_ptr(),
                  sact.data_ptr())
    return point, normal, mid, so, sd, st, sact


def shade_phong_plain(o, d, weight, valid, live, mid, point, normal, shadow,
                      mat16, light_pos, light_color, env):
    """Plain version of K4; arguments and results as :func:`shade_phong`."""
    dx, dy, dz = d.unbind(1)
    is_valid = valid > 0
    is_live = live > 0
    px, py, pz = point.unbind(1)
    nmx, nmy, nmz = normal.unbind(1)
    (kdx, kdy, kdz, kax, kay, kaz, ksx, ksy, ksz, shin, mir) = _mat_cols(
        mat16, mid, (_M_KD, _M_KD + 1, _M_KD + 2, _M_KA, _M_KA + 1, _M_KA + 2,
                     _M_KS, _M_KS + 1, _M_KS + 2, _M_SHIN, _M_MIRROR))
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


def shade_phong(o, d, weight, valid, live, mid, point, normal, shadow, mat16,
                light_pos, light_color, env):
    """Lighting + Whitted blend + bounce (K4 on CUDA tensors).

    Args: o, d, point, normal [R, 3] f32; weight [R] f32; valid, live,
    mid [R] i32; shadow [L, R] i32 (1 = occluded, LIGHT-major);
    mat16 [Mt, 16] f32; light_pos, light_color [L, 3] f32;
    env [6] f32 (ambience, background).
    Returns (add [R, 3], o2 [R, 3], d2 [R, 3], w2 [R]).
    """
    if o.device.type == "cpu":
        return shade_phong_plain(o, d, weight, valid, live, mid, point,
                                 normal, shadow, mat16, light_pos,
                                 light_color, env)
    dev = o.device
    _build.check_inputs("shade_phong", dev, o_f=o, d_f=d, weight_f=weight,
                        valid_i=valid, live_i=live, mid_i=mid, point_f=point,
                        normal_f=normal, shadow_i=shadow, mat16_f=mat16,
                        light_pos_f=light_pos, light_color_f=light_color,
                        env_f=env)
    R, L = o.shape[0], light_pos.shape[0]
    add = torch.empty((R, 3), dtype=torch.float32, device=dev)
    o2 = torch.empty((R, 3), dtype=torch.float32, device=dev)
    d2 = torch.empty((R, 3), dtype=torch.float32, device=dev)
    w2 = torch.empty(R, dtype=torch.float32, device=dev)
    _build.launch("mrt_shade_phong", "shade_phong", dev,
                  o.data_ptr(), d.data_ptr(), weight.data_ptr(),
                  valid.data_ptr(), live.data_ptr(), mid.data_ptr(),
                  point.data_ptr(), normal.data_ptr(), shadow.data_ptr(),
                  light_pos.data_ptr(), light_color.data_ptr(), env.data_ptr(),
                  mat16.data_ptr(), mat16.shape[0], L, R, add.data_ptr(),
                  o2.data_ptr(), d2.data_ptr(), w2.data_ptr())
    return add, o2, d2, w2
