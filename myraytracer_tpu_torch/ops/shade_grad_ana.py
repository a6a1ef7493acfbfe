"""Differentiable fused shade segment for sphere and plane hits (torch).

The analytic sibling of ops/shade_grad.py: one Whitted segment of the
training replay of a recorded topology for a scene whose hits are
spheres and planes (no triangle, no cylinder, no texture), with the
semantics and operand order of ``shade.resolve_hit`` +
``tracer.lighting_from_mask``: the sphere re-solve (``ray_t_sphere``'s
``disc > 1e-12`` guard, ``t0 > EPS_HIT`` or else ``t1``) with the normal
``normalize(o + t d - c)``, the plane re-solve under the
``EPS_PARALLEL`` guard with the normal ``n_p``, the fp32 re-projection
of the point onto each surface, the material row ``mat16[mat_id]``,
Phong under the recorded shadow mask, the Whitted blend and the mirror
bounce. Each ray reads its row of ``ShadeGeom.ana16`` (spheres, then
planes) and of ``mat16`` by id.

Two kernels (``csrc/shade_grad_ana.cu``), each with its plain PyTorch
version written over component columns like ops/shade_grad.py's:

  K10 :func:`segment_ana_fwd`  (plain :func:`segment_ana_plain`) the
      forward;
  K11 :func:`segment_ana_bwd`  (plain :func:`segment_ana_bwd_plain`) the
      hand-derived reverse, which recomputes the forward first and sums
      each ray's ``ana16`` and ``mat16`` row cotangents, and the light
      and environment cotangents, over the rays. The kernel sums them in
      a fixed order, with no float atomics: the same inputs give the same
      bits, captured or not. :func:`segment_ana_bwd_rows_plain` gives
      the per-ray rows.

:class:`ShadeSegmentAna` binds them as a ``torch.autograd.Function``
whose residuals are its inputs. Each wrapper runs its plain version for
CPU tensors and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.intersect import EPS_HIT, EPS_PARALLEL
from myraytracer_tpu_torch.ops.shade import (EPS_OFFSET, KIND_MISS,
                                             KIND_PLANE, KIND_SPHERE)
from myraytracer_tpu_torch.ops.shade_grad import _dot, _inv_norm
from myraytracer_tpu_torch.utils import vecmath as vm

#: ana16 columns with a cotangent: center (0-2), plane normal (3-5),
#: sphere radius (6)
ANA_COLS = 7
#: mat16 columns with a cotangent: diffuse, ambient, specular (0-8),
#: shininess (9), mirror (10)
MAT_COLS = 11
#: the sphere re-solve's root guard (shade.ray_t_sphere)
DISC_EPS = 1e-12


def _rows(ana16, kind, idx, counts):
    """Each ray's ana16 row (spheres, then planes; 0 on a miss) and
    mat16 row (the ana16 row's column 8; 0 on a miss)."""
    n_s, n_p = counts
    arow = torch.zeros_like(idx, dtype=torch.int64)
    if n_s:
        arow = torch.where(kind == KIND_SPHERE,
                           torch.clamp(idx.long(), 0, n_s - 1), arow)
    if n_p:
        arow = torch.where(kind == KIND_PLANE,
                           n_s + torch.clamp(idx.long(), 0, n_p - 1), arow)
    mid = torch.where(kind != KIND_MISS, ana16[arow, 8].long(), 0)
    return arow, mid


def _fwd_core(o, d, w, ar, mr, lp, lc, amb, bg, kind, h, miss, lit, L):
    """Forward shade segment over component columns.

    o, d: 3-tuples of [R]; w [R]; ar: the ray's ana16 row as a list of
    [R] columns (0-6), mr its mat16 row (0-10); lp, lc: [L][3] and amb,
    bg: [3] of 0-d tensors; kind [R] int; h, miss [R] bool; lit: [L] of
    [R] float. Returns ((add, o2, d2, w2), intermediates). Both kinds'
    branches run for every ray and ``kind`` selects, with ``where``
    only, so a branch that a ray did not take never reaches its
    results or its cotangents.
    """
    is_s = kind == KIND_SPHERE
    is_p = kind == KIND_PLANE
    valid = kind != KIND_MISS
    c = (ar[0], ar[1], ar[2])
    nx = (ar[3], ar[4], ar[5])
    rad = ar[6]

    # sphere (shade.ray_t_sphere, then normalize(o + t d - c))
    oc = tuple(o[i] - c[i] for i in range(3))
    b = 2.0 * _dot(*oc, *d)
    a = _dot(*d, *d)
    cq = _dot(*oc, *oc) - rad * rad
    disc = b * b - 4.0 * a * cq
    pos = disc > DISC_EPS
    sq = torch.where(pos, vm.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    use0 = t0 > EPS_HIT
    t_s = torch.where(use0, t0, t1)
    v = tuple(o[i] + t_s * d[i] - c[i] for i in range(3))
    okv, invv = _inv_norm(_dot(*v, *v))
    n_s = tuple(v[i] * invv for i in range(3))
    pt_s = tuple(c[i] + rad * n_s[i] for i in range(3))

    # plane
    den0 = _dot(*nx, *d)
    okp = den0.abs() > EPS_PARALLEL
    den = torch.where(okp, den0, 1.0)
    num = _dot(*nx, *c) - _dot(*nx, *o)
    t_p = num / den
    P = tuple(o[i] + t_p * d[i] for i in range(3))
    q = tuple(P[i] - c[i] for i in range(3))
    dd = _dot(*nx, *q)
    pt_p = tuple(P[i] - dd * nx[i] for i in range(3))

    nrm = tuple(torch.where(is_s, n_s[i], torch.where(is_p, nx[i], 0.0))
                for i in range(3))
    point = tuple(torch.where(is_s, pt_s[i], torch.where(is_p, pt_p[i], o[i]))
                  for i in range(3))

    kd = (mr[0], mr[1], mr[2])
    ka = (mr[3], mr[4], mr[5])
    ks = (mr[6], mr[7], mr[8])
    shin = mr[9]
    mirror = torch.where(valid, mr[10], 0.0)

    # Phong with the fixed shadow mask (tracer.lighting_from_mask): the
    # ambient term plus the sum of the lights' terms
    lsum = None
    per_light = []
    for li in range(L):
        lv = tuple(lp[li][i] - point[i] for i in range(3))
        okl, invl = _inv_norm(_dot(*lv, *lv))
        ld = tuple(lv[i] * invl for i in range(3))
        diff = torch.clamp(_dot(*nrm, *ld), min=0.0)
        ln = _dot(*ld, *nrm)
        m = tuple(2.0 * ln * nrm[i] - ld[i] for i in range(3))
        okm, invm = _inv_norm(_dot(*m, *m))
        r = tuple(m[i] * invm for i in range(3))
        cos_rv = torch.clamp(_dot(*r, -d[0], -d[1], -d[2]), min=0.0)
        gate = (diff > 0.0) & (cos_rv > 0.0)
        base = torch.where(gate, cos_rv, 1.0)
        spec = torch.where(gate, torch.pow(base, shin), 0.0)
        term = [lc[li][i] * lit[li] * (kd[i] * diff + ks[i] * spec)
                for i in range(3)]
        lsum = term if lsum is None else [lsum[i] + term[i] for i in range(3)]
        per_light.append(dict(lv=lv, okl=okl, invl=invl, ld=ld, diff=diff,
                              ln=ln, m=m, okm=okm, invm=invm, r=r,
                              cos_rv=cos_rv, gate=gate, base=base,
                              spec=spec))
    col = [amb[i] * ka[i] + lsum[i] for i in range(3)]

    wf = w * (1.0 - mirror)
    add = tuple(torch.where(h, wf * col[i], 0.0)
                + torch.where(miss, w * bg[i], 0.0) for i in range(3))

    # mirror bounce
    dn = _dot(*d, *nrm)
    refl = tuple(d[i] - 2.0 * dn * nrm[i] for i in range(3))
    o2 = tuple(torch.where(h, point[i] + EPS_OFFSET * refl[i], o[i])
               for i in range(3))
    d2 = tuple(torch.where(h, refl[i], d[i]) for i in range(3))
    w2 = torch.where(h, w * mirror, 0.0)

    inter = dict(is_s=is_s, is_p=is_p, valid=valid, c=c, nx=nx, rad=rad,
                 oc=oc, b=b, a=a, cq=cq, pos=pos, sq=sq, inv2a=inv2a, t0=t0,
                 t1=t1, use0=use0, t_s=t_s, v=v, okv=okv, invv=invv, n_s=n_s,
                 okp=okp, den=den, num=num, t_p=t_p, q=q, dd=dd, nrm=nrm,
                 kd=kd, ka=ka, ks=ks, shin=shin, mirror=mirror, col=col,
                 per_light=per_light, dn=dn, wf=wf)
    return (add, o2, d2, w2), inter


def _bwd_core(o, d, w, ar, mr, lp, lc, amb, bg, kind, h, miss, lit, L,
              g_add, g_o2, g_d2, g_w2):
    """Hand-derived reverse of :func:`_fwd_core` (not autograd).

    Returns (g_o(3), g_d(3), g_w, g_ana [7] (the ray's ana16 row
    cotangent, zero on a miss), g_mat [11] (its mat16 row cotangent,
    zero on a miss), g_lp [L][3], g_lc [L][3], g_amb(3), g_bg(3)), all
    per ray. The lighting, blend and bounce reverses are ops/shade_grad's
    (the normalize reverses form ``v * (2 g)``); the geometry reverse is
    each kind's, selected with ``where``.
    """
    _, iv = _fwd_core(o, d, w, ar, mr, lp, lc, amb, bg, kind, h, miss, lit,
                      L)
    z = torch.zeros_like(w)
    is_s, is_p, valid = iv["is_s"], iv["is_p"], iv["valid"]
    nrm, mirror, col = iv["nrm"], iv["mirror"], iv["col"]
    kd, ka, ks, shin = iv["kd"], iv["ka"], iv["ks"], iv["shin"]

    # bounce reverse
    g_refl = [torch.where(h, EPS_OFFSET * g_o2[i] + g_d2[i], 0.0)
              for i in range(3)]
    g_point = [torch.where(h, g_o2[i], 0.0) for i in range(3)]
    g_o = [torch.where(h, 0.0, g_o2[i]) for i in range(3)]
    g_d = [torch.where(h, 0.0, g_d2[i]) for i in range(3)]
    g_w = torch.where(h, mirror * g_w2, 0.0)
    g_mirror = torch.where(h, w * g_w2, 0.0)
    ngr = _dot(*nrm, *g_refl)
    dn = iv["dn"]
    for i in range(3):
        g_d[i] = g_d[i] + (g_refl[i] - 2.0 * nrm[i] * ngr)
    g_nrm = [-2.0 * (d[i] * ngr + dn * g_refl[i]) for i in range(3)]

    # blend reverse
    wf = iv["wf"]
    g_col = [torch.where(h, wf * g_add[i], 0.0) for i in range(3)]
    gdotc = g_add[0] * col[0] + g_add[1] * col[1] + g_add[2] * col[2]
    g_w = g_w + torch.where(h, (1.0 - mirror) * gdotc, 0.0)
    g_mirror = g_mirror + torch.where(h, -w * gdotc, 0.0)
    g_bg = [torch.where(miss, w * g_add[i], 0.0) for i in range(3)]
    g_w = g_w + torch.where(
        miss, g_add[0] * bg[0] + g_add[1] * bg[1] + g_add[2] * bg[2], 0.0)

    # lighting reverse
    g_amb = [g_col[i] * ka[i] for i in range(3)]
    g_ka = [g_col[i] * amb[i] for i in range(3)]
    g_kd = [z, z, z]
    g_ks = [z, z, z]
    g_shin = z
    g_lp, g_lc = [], []
    for li in range(L):
        pl_ = iv["per_light"][li]
        ld, diff, spec = pl_["ld"], pl_["diff"], pl_["spec"]
        g_lc.append([g_col[i] * lit[li] * (kd[i] * diff + ks[i] * spec)
                     for i in range(3)])
        g_diff = z
        g_spec = z
        for i in range(3):
            g_kd[i] = g_kd[i] + g_col[i] * lc[li][i] * lit[li] * diff
            g_ks[i] = g_ks[i] + g_col[i] * lc[li][i] * lit[li] * spec
            g_diff = g_diff + g_col[i] * lc[li][i] * lit[li] * kd[i]
            g_spec = g_spec + g_col[i] * lc[li][i] * lit[li] * ks[i]
        gate, base, cos_rv = pl_["gate"], pl_["base"], pl_["cos_rv"]
        # off the gate base = 1: pow and log stay finite there
        g_base = torch.where(
            gate, shin * torch.pow(base, shin - 1.0) * g_spec, 0.0)
        g_shin = g_shin + torch.where(
            gate, spec * torch.log(base) * g_spec, 0.0)
        rvg = torch.where((cos_rv > 0.0) & gate, g_base, 0.0)
        r = pl_["r"]
        # cos_rv = r . (-d)
        g_r = [rvg * (-d[i]) for i in range(3)]
        for i in range(3):
            g_d[i] = g_d[i] + -rvg * r[i]
        # r = normalize(m)
        m, invm, okm = pl_["m"], pl_["invm"], pl_["okm"]
        g_invm = g_r[0] * m[0] + g_r[1] * m[1] + g_r[2] * m[2]
        g_n2m = torch.where(okm, -0.5 * invm * invm * invm * g_invm, 0.0)
        g_m = [g_r[i] * invm + m[i] * (2.0 * g_n2m) for i in range(3)]
        # m = 2 (ld.n) n - ld
        ln = pl_["ln"]
        ngm = _dot(*nrm, *g_m)
        g_ld = [2.0 * ngm * nrm[i] - g_m[i] for i in range(3)]
        for i in range(3):
            g_nrm[i] = g_nrm[i] + 2.0 * (ngm * ld[i] + ln * g_m[i])
        # diff = max(0, n.ld)
        gd_ = torch.where(diff > 0.0, g_diff, 0.0)
        for i in range(3):
            g_nrm[i] = g_nrm[i] + gd_ * ld[i]
            g_ld[i] = g_ld[i] + gd_ * nrm[i]
        # ld = normalize(lv), lv = lp - point
        lv, invl, okl = pl_["lv"], pl_["invl"], pl_["okl"]
        g_invl = g_ld[0] * lv[0] + g_ld[1] * lv[1] + g_ld[2] * lv[2]
        g_n2l = torch.where(okl, -0.5 * invl * invl * invl * g_invl, 0.0)
        g_lv = [g_ld[i] * invl + lv[i] * (2.0 * g_n2l) for i in range(3)]
        g_lp.append(g_lv)
        for i in range(3):
            g_point[i] = g_point[i] + -g_lv[i]
    g_mirr = torch.where(valid, g_mirror, 0.0)

    c, nx, rad = iv["c"], iv["nx"], iv["rad"]
    # sphere: point = c + rad n, n = normalize(v), v = o + t d - c
    g_n_s = [torch.where(is_s, g_nrm[i] + rad * g_point[i], 0.0)
             for i in range(3)]
    g_ps = [torch.where(is_s, g_point[i], 0.0) for i in range(3)]
    n_s, v, invv, okv = iv["n_s"], iv["v"], iv["invv"], iv["okv"]
    g_rad = _dot(*n_s, *g_ps)
    g_cs = list(g_ps)
    g_invv = g_n_s[0] * v[0] + g_n_s[1] * v[1] + g_n_s[2] * v[2]
    g_n2v = torch.where(okv, -0.5 * invv * invv * invv * g_invv, 0.0)
    g_v = [g_n_s[i] * invv + v[i] * (2.0 * g_n2v) for i in range(3)]
    t_s = iv["t_s"]
    g_os = list(g_v)
    g_ds = [t_s * g_v[i] for i in range(3)]
    g_ts = _dot(*d, *g_v)
    for i in range(3):
        g_cs[i] = g_cs[i] - g_v[i]
    # t = (-b -+ sq) * inv2a
    b, a, cq, sq, inv2a = iv["b"], iv["a"], iv["cq"], iv["sq"], iv["inv2a"]
    use0, pos, oc = iv["use0"], iv["pos"], iv["oc"]
    g_nm = g_ts * inv2a
    g_b = -g_nm
    g_sq = torch.where(use0, -g_nm, g_nm)
    g_inv2a = g_ts * torch.where(use0, -b - sq, -b + sq)
    # inv2a = 0.5 / a
    g_a = -(g_inv2a * inv2a) / a
    # sq = sqrt(disc) where disc > DISC_EPS, else 0
    g_disc = torch.where(pos, g_sq * 0.5 / torch.where(pos, sq, 1.0), 0.0)
    # disc = b b - 4 a cq
    g_b = g_b + 2.0 * b * g_disc
    g_a = g_a + -4.0 * cq * g_disc
    g_cq = -4.0 * a * g_disc
    # cq = oc.oc - rad rad; b = 2 oc.d; a = d.d
    g_rad = g_rad + -2.0 * rad * g_cq
    for i in range(3):
        g_oc = 2.0 * g_cq * oc[i] + 2.0 * g_b * d[i]
        g_ds[i] = g_ds[i] + 2.0 * g_b * oc[i] + 2.0 * g_a * d[i]
        g_os[i] = g_os[i] + g_oc
        g_cs[i] = g_cs[i] - g_oc

    # plane: point = P - dd nx, dd = nx.(P - c), P = o + t d,
    # t = (nx.c - nx.o) / den, den = nx.d where |nx.d| > EPS_PARALLEL
    g_pp = [torch.where(is_p, g_point[i], 0.0) for i in range(3)]
    q, dd, t_p, den, num, okp = (iv["q"], iv["dd"], iv["t_p"], iv["den"],
                                 iv["num"], iv["okp"])
    g_dd = -_dot(*g_pp, *nx)
    g_nx = [torch.where(is_p, g_nrm[i], 0.0) - dd * g_pp[i] + g_dd * q[i]
            for i in range(3)]
    g_P = [g_pp[i] + g_dd * nx[i] for i in range(3)]
    g_cp = [-(g_dd * nx[i]) for i in range(3)]
    g_op = list(g_P)
    g_dp = [t_p * g_P[i] for i in range(3)]
    g_tp = _dot(*d, *g_P)
    g_num = g_tp / den
    g_den = torch.where(okp, -(g_tp * t_p) / den, 0.0)
    for i in range(3):
        g_nx[i] = g_nx[i] + g_den * d[i] + g_num * c[i] - g_num * o[i]
        g_dp[i] = g_dp[i] + g_den * nx[i]
        g_cp[i] = g_cp[i] + g_num * nx[i]
        g_op[i] = g_op[i] - g_num * nx[i]

    # a miss keeps point = o
    for i in range(3):
        g_o[i] = g_o[i] + torch.where(
            is_s, g_os[i], torch.where(is_p, g_op[i], g_point[i]))
        g_d[i] = g_d[i] + torch.where(is_s, g_ds[i],
                                      torch.where(is_p, g_dp[i], 0.0))
    g_ana = ([torch.where(is_s, g_cs[i], torch.where(is_p, g_cp[i], 0.0))
              for i in range(3)]
             + [torch.where(is_p, g_nx[i], 0.0) for i in range(3)]
             + [torch.where(is_s, g_rad, 0.0)])
    g_mat = [torch.where(valid, x, 0.0)
             for x in (*g_kd, *g_ka, *g_ks, g_shin)] + [g_mirr]
    return g_o, g_d, g_w, g_ana, g_mat, g_lp, g_lc, g_amb, g_bg


def _core_args(o, d, w, ana16, mat16, kind, idx, h, miss, shadow, light_pos,
               light_color, ambience, background, counts):
    L = light_pos.shape[0]
    arow, mid = _rows(ana16, kind, idx, counts)
    ar = ana16[arow].unbind(1)
    mr = mat16[mid].unbind(1)
    lit = (~shadow).to(o.dtype)
    lp = [light_pos[li].unbind(0) for li in range(L)]
    lc = [light_color[li].unbind(0) for li in range(L)]
    return (o.unbind(1), d.unbind(1), w, ar, mr, lp, lc, ambience.unbind(0),
            background.unbind(0), kind, h, miss, lit.unbind(0), L)


def _cots(g, w, n):
    """An output cotangent as n columns like ``w`` (itself where n is 0),
    zeros where it is None."""
    if g is None:
        return [torch.zeros_like(w)] * n if n else torch.zeros_like(w)
    return g.unbind(1) if n else g


def segment_ana_plain(o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                      light_pos, light_color, ambience, background, counts):
    """Plain version of K10; arguments and results as
    :func:`segment_ana_fwd`."""
    (add, o2, d2, w2), _ = _fwd_core(*_core_args(
        o, d, w, ana16, mat16, kind, idx, h, miss, shadow, light_pos,
        light_color, ambience, background, counts))
    return (torch.stack(add, dim=1), torch.stack(o2, dim=1),
            torch.stack(d2, dim=1), w2)


def segment_ana_bwd_rows_plain(o, d, w, ana16, mat16, kind, idx, h, miss,
                               shadow, light_pos, light_color, ambience,
                               background, counts, g_add, g_o2, g_d2, g_w2):
    """K11's reverse before the sums: (g_o [R, 3], g_d [R, 3], g_w [R],
    g_ana_rows [R, 7], g_mat_rows [R, 11], the per-ray rows of ``ana16``
    and ``mat16``'s cotangents (zero on a miss), g_light_pos [L, 3],
    g_light_color [L, 3], g_ambience [3], g_background [3]), the last
    four summed over the rays. A cotangent given as None is zero."""
    g_o, g_d, g_w, g_ana, g_mat, g_lp, g_lc, g_amb, g_bg = _bwd_core(
        *_core_args(o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                    light_pos, light_color, ambience, background, counts),
        _cots(g_add, w, 3), _cots(g_o2, w, 3), _cots(g_d2, w, 3),
        _cots(g_w2, w, 0))

    def total(rows):
        if not rows:
            return light_pos.new_zeros((0, 3))
        return torch.stack([torch.stack([x.sum() for x in row])
                            for row in rows])

    return (torch.stack(g_o, dim=1), torch.stack(g_d, dim=1), g_w,
            torch.stack(g_ana, dim=1), torch.stack(g_mat, dim=1),
            total(g_lp), total(g_lc), torch.stack([x.sum() for x in g_amb]),
            torch.stack([x.sum() for x in g_bg]))


def segment_ana_bwd_plain(o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                          light_pos, light_color, ambience, background,
                          counts, g_add, g_o2, g_d2, g_w2, need=None):
    """Plain version of K11; arguments and results as
    :func:`segment_ana_bwd`: the per-ray rows, then ``index_add_`` into
    the ``ana16`` and ``mat16`` cotangents."""
    g_o, g_d, g_w, g_ana_rows, g_mat_rows, *env = segment_ana_bwd_rows_plain(
        o, d, w, ana16, mat16, kind, idx, h, miss, shadow, light_pos,
        light_color, ambience, background, counts, g_add, g_o2, g_d2, g_w2)
    arow, mid = _rows(ana16, kind, idx, counts)
    g_ana = torch.zeros_like(ana16)
    g_ana[:, :ANA_COLS].index_add_(0, arow, g_ana_rows)
    g_mat = torch.zeros_like(mat16)
    g_mat[:, :MAT_COLS].index_add_(0, mid, g_mat_rows)
    out = (g_o, g_d, g_w, g_ana, g_mat, *env)
    return out if need is None else tuple(
        g if n else None for g, n in zip(out, _expand(need)))


#: the inputs the wrappers check, with the dtype letter check_inputs
#: reads (f float32, i int32, b bool)
_ARGS = dict(o="f", d="f", w="f", ana16="f", mat16="f", kind="i", idx="i",
             h="b", miss="b", shadow="b", light_pos="f", light_color="f",
             ambience="f", background="f")
_COTS = ("g_add", "g_o2", "g_d2", "g_w2")


def _check(name, tensors, cots=()):
    """Raise ValueError unless the wrapper's tensors have the dtypes,
    device, contiguity and shapes the kernels read; returns (device, R, L).
    ``cots`` are the backward's output cotangents (None for zero)."""
    named = dict(zip(_ARGS, tensors))
    o = named["o"]
    R, L = o.shape[0], named["light_pos"].shape[0]
    given = {k: t for k, t in zip(_COTS, cots) if t is not None}
    _build.check_inputs(
        name, o.device, widths=dict(ana16_f=16, mat16_f=16),
        **{f"{k}_{v}": named[k] for k, v in _ARGS.items()},
        **{f"{k}_f": t for k, t in given.items()})
    shapes = dict(o=(R, 3), d=(R, 3), w=(R,), kind=(R,), idx=(R,), h=(R,),
                  miss=(R,), shadow=(L, R), light_pos=(L, 3),
                  light_color=(L, 3), ambience=(3,), background=(3,),
                  g_add=(R, 3), g_o2=(R, 3), g_d2=(R, 3), g_w2=(R,))
    for k, t in {**named, **given}.items():
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
    if L < 1:
        raise ValueError(f"{name}: the segment needs a light")
    return o.device, R, L


def _counts(counts, ana16, name) -> Tuple[int, int]:
    n_s, n_p = (int(x) for x in counts)
    if n_s < 0 or n_p < 0 or n_s + n_p > ana16.shape[0]:
        raise ValueError(f"{name}: {n_s} spheres and {n_p} planes do not fit "
                         f"ana16's {ana16.shape[0]} rows")
    return n_s, n_p


def segment_ana_fwd(o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                    light_pos, light_color, ambience, background, counts):
    """Forward shade segment on sphere and plane hits (K10 on CUDA
    tensors).

    Args: o, d [R, 3] f32; w [R] f32 ray weight; ana16 [A, 16] f32 and
    mat16 [M, 16] f32 (``ShadeGeom``); kind [R] i32 the recorded hit
    kind (KIND_MISS, KIND_SPHERE or KIND_PLANE), idx [R] i32 its
    per-kind index (clamped into the kind's rows, as ``resolve_hit``
    does); h (live hit), miss (live miss) [R] bool; shadow [L, R] bool
    the recorded occlusion; light_pos, light_color [L, 3] f32, L >= 1;
    ambience, background [3] f32; counts (spheres, planes): ana16's rows
    of each kind, spheres first. The material id of a hit is its ana16
    row's column 8. Returns (add [R, 3], o2 [R, 3], d2 [R, 3], w2 [R]).
    """
    if o.device.type == "cpu":
        return segment_ana_plain(o, d, w, ana16, mat16, kind, idx, h, miss,
                                 shadow, light_pos, light_color, ambience,
                                 background, counts)
    args = (o, d, w, ana16, mat16, kind, idx, h, miss, shadow, light_pos,
            light_color, ambience, background)
    dev, R, L = _check("segment_ana_fwd", args)
    n_s, n_p = _counts(counts, ana16, "segment_ana_fwd")
    f32 = dict(dtype=torch.float32, device=dev)
    add = torch.empty((R, 3), **f32)
    o2 = torch.empty((R, 3), **f32)
    d2 = torch.empty((R, 3), **f32)
    w2 = torch.empty(R, **f32)
    if R:
        _build.launch(
            "mrt_seg_ana_fwd", "seg_ana_fwd", dev,
            *(t.data_ptr() for t in args), n_s, n_p, L, R,
            add.data_ptr(), o2.data_ptr(), d2.data_ptr(), w2.data_ptr())
    return add, o2, d2, w2


#: the cotangents segment_ana_bwd returns, in order
BWD_OUTPUTS = ("o", "d", "w", "ana16", "mat16", "light_pos", "light_color",
               "ambience", "background")


def _expand(need: Optional[Sequence[bool]]) -> Tuple[bool, ...]:
    return (True,) * len(BWD_OUTPUTS) if need is None else tuple(
        bool(n) for n in need)


def segment_ana_bwd(o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                    light_pos, light_color, ambience, background, counts,
                    g_add, g_o2, g_d2, g_w2, need=None):
    """Reverse of :func:`segment_ana_fwd` (K11 on CUDA tensors).

    Arguments as :func:`segment_ana_fwd`, plus the output cotangents
    g_add, g_o2, g_d2 [R, 3] and g_w2 [R] f32 (None for zero), and
    ``need``: which of :data:`BWD_OUTPUTS` to compute (all when None).
    Returns (g_o [R, 3], g_d [R, 3], g_w [R], g_ana16 [A, 16], g_mat16
    [M, 16], g_light_pos [L, 3], g_light_color [L, 3], g_ambience [3],
    g_background [3]), None for each one not needed. g_ana16 holds each
    hit's row cotangent summed into its row (columns 0-6), g_mat16 each
    hit's material cotangent summed into its row (columns 0-10), both
    zero elsewhere; the last four are sums over the rays. The kernel
    sums each of them in a fixed order (module docstring): two calls on
    the same inputs give the same bits.
    """
    need = _expand(need)
    if o.device.type == "cpu":
        return segment_ana_bwd_plain(o, d, w, ana16, mat16, kind, idx, h,
                                     miss, shadow, light_pos, light_color,
                                     ambience, background, counts, g_add,
                                     g_o2, g_d2, g_w2, need)
    args = (o, d, w, ana16, mat16, kind, idx, h, miss, shadow, light_pos,
            light_color, ambience, background)
    cots = (g_add, g_o2, g_d2, g_w2)
    dev, R, L = _check("segment_ana_bwd", args, cots)
    n_s, n_p = _counts(counts, ana16, "segment_ana_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    A, M = ana16.shape[0], mat16.shape[0]
    n_env = 6 * L + 6
    outs = [torch.empty(shape, **f32) if n else None for shape, n in zip(
        ((R, 3), (R, 3), (R,), (A, 16), (M, 16)), need[:5])]
    env_needed = any(need[5:])
    g_env = torch.empty(n_env, **f32) if env_needed else None
    if R:
        # the blocks' partial sums, and the counts of blocks done that
        # find the last ones (integers, zero at the launch)
        lib = _build.library()
        words = lib.mrt_seg_ana_bwd_workspace(
            R, L, M, A, int(need[3]), int(need[4]), int(env_needed))
        work = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        done = torch.zeros(lib.mrt_seg_ana_bwd_counters(R),
                           dtype=torch.int32, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()
        _build.launch(
            "mrt_seg_ana_bwd", "seg_ana_bwd", dev,
            *(t.data_ptr() for t in args), *(ptr(t) for t in cots),
            n_s, n_p, A, M, L, R, *(ptr(t) for t in outs), ptr(g_env),
            work.data_ptr(), done.data_ptr())
    elif g_env is not None:
        g_env.zero_()
        for t in outs[3:]:
            if t is not None:
                t.zero_()
    env = ((None,) * 4 if g_env is None else
           (g_env[:3 * L].view(L, 3), g_env[3 * L:6 * L].view(L, 3),
            g_env[6 * L:6 * L + 3], g_env[6 * L + 3:]))
    return (*outs, *(e if n else None for e, n in zip(env, need[5:])))


class ShadeSegmentAna(torch.autograd.Function):
    """One differentiable shade segment on sphere and plane hits: K10
    forward, K11 backward.

    ``ShadeSegmentAna.apply(o, d, w, ana16, mat16, kind, idx, h, miss,
    shadow, light_pos, light_color, ambience, background, counts,
    plain)`` -> (add, o2, d2, w2), arguments as :func:`segment_ana_fwd`;
    ``plain=True`` runs the plain versions on any device. The saved
    residuals are the inputs. The backward computes only the cotangents
    that autograd asks for (``needs_input_grad``), of o, d, w, ana16,
    mat16, the lights, ambience and background; None for the rest.
    An output's unused cotangent reaches the kernel as zero without
    being made.
    """

    @staticmethod
    def forward(ctx, o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                light_pos, light_color, ambience, background, counts,
                plain):
        args = (o, d, w, ana16, mat16, kind, idx, h, miss, shadow,
                light_pos, light_color, ambience, background)
        ctx.save_for_backward(*args)
        ctx.counts = tuple(counts)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        fwd = segment_ana_plain if plain else segment_ana_fwd
        return fwd(*args, ctx.counts)

    @staticmethod
    def backward(ctx, g_add, g_o2, g_d2, g_w2):
        args = ctx.saved_tensors
        ni = ctx.needs_input_grad
        need = ni[0:5] + ni[10:14]
        bwd = segment_ana_bwd_plain if ctx.plain else segment_ana_bwd

        def c(g):
            return None if g is None else g.contiguous()
        g_o, g_d, g_w, g_ana, g_mat, g_lp, g_lc, g_amb, g_bg = bwd(
            *args, ctx.counts, c(g_add), c(g_o2), c(g_d2), c(g_w2), need)
        return (g_o, g_d, g_w, g_ana, g_mat, None, None, None, None, None,
                g_lp, g_lc, g_amb, g_bg, None, None)
