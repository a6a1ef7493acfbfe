"""Differentiable fused shade segment with a hand-derived VJP (torch).

Counterpart of ``myraytracer_tpu/ops/shade_grad.py``. One Whitted
shading segment of the differentiable replay of a recorded topology:
Cramer re-solve, flat or Phong normal, plane re-projection, Phong under a
fixed shadow mask, Whitted blend, mirror bounce. Triangle-only,
untextured scenes.

Two kernels (``csrc/shade_grad.cu``), each with its plain PyTorch
version written over component columns like the reference's cores:

  K5  :func:`segment_fwd`  (plain :func:`segment_plain`) the forward;
  K6  :func:`segment_bwd`  (plain :func:`segment_bwd_plain`) the
      hand-derived reverse, which recomputes the forward first and sums
      the per-ray ``tri_pack`` row cotangents (``_GRAD_COLS``) into the
      ``tri_pack`` cotangent itself, the reference's ``.at[ti].add``.
      :func:`segment_bwd_rows_plain` gives the per-ray rows.

:class:`ShadeSegment` binds them as a ``torch.autograd.Function``. Its
residuals are its inputs (the shared ``tri_pack`` table plus per-ray
columns), so the replay needs no checkpoint. Each wrapper runs its plain
version for CPU tensors and launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops.intersect import EPS_DET, EPS_HIT, INF
from myraytracer_tpu_torch.ops.shade import EPS_OFFSET
from myraytracer_tpu_torch.utils.vecmath import EPS_NORMALIZE

#: tri_pack columns read: p0 p1 p2 | n0 n1 n2 | phong flag | kd ka ks
#: shin mirror
_COLS = tuple(range(0, 9)) + tuple(range(16, 25)) + (25,) + tuple(
    range(32, 43))

#: the tri_pack column of each row cotangent, in output order (_COLS
#: minus the phong flag)
_GRAD_COLS = tuple(range(0, 9)) + tuple(range(16, 25)) + tuple(
    range(32, 43))


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _inv_norm(n2):
    """vecmath.normalize's guard and op order: 1 / sqrt(max(n2, eps))."""
    ok = n2 > EPS_NORMALIZE
    return ok, torch.where(
        ok, torch.reciprocal(torch.sqrt(torch.clamp(n2, min=EPS_NORMALIZE))),
        0.0)


def _fwd_core(o, d, w, cols, lp, lc, amb, bg, is_t, h, miss, lit, L):
    """Forward shade segment over component columns.

    o, d: 3-tuples of [R]; w [R]; cols: tri_pack column -> [R]; lp, lc:
    [L][3] and amb, bg: [3] of 0-d tensors; is_t, h, miss [R] bool; lit:
    [L] of [R] float. Returns ((add, o2, d2, w2), intermediates).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    p0 = (cols[0], cols[1], cols[2])
    p1 = (cols[3], cols[4], cols[5])
    p2 = (cols[6], cols[7], cols[8])

    # Cramer solve (intersect.ray_triangle)
    c1 = (p0[0] - p2[0], p0[1] - p2[1], p0[2] - p2[2])
    c2 = (p1[0] - p2[0], p1[1] - p2[1], p1[2] - p2[2])
    c3 = (-dx, -dy, -dz)
    c4 = (ox - p2[0], oy - p2[1], oz - p2[2])

    def det3(a, b, c):
        cx, cy, cz = _cross(*b, *c)
        return a[0] * cx + a[1] * cy + a[2] * cz

    s = det3(c1, c2, c3)
    Dt = det3(c1, c2, c4)
    Da = det3(c4, c2, c3)
    Db = det3(c1, c4, c3)
    ok_s = s.abs() > EPS_DET
    inv_s = torch.where(ok_s, 1.0 / torch.where(ok_s, s, 1.0), 0.0)
    t_raw = Dt * inv_s
    alpha = Da * inv_s
    beta = Db * inv_s
    gamma = 1.0 - alpha - beta
    inside = ((alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0)
              & (beta <= 1.0) & (gamma >= 0.0) & (gamma <= 1.0))
    valid = ok_s & (t_raw > EPS_HIT) & inside
    t_inf = torch.where(valid, t_raw, INF)
    t_use = torch.where(is_t, t_inf, 0.0)

    # normals
    e1 = (p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2])
    e2 = (p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2])
    cr = _cross(*e1, *e2)
    okf, invf = _inv_norm(_dot(*cr, *cr))
    nf = (cr[0] * invf, cr[1] * invf, cr[2] * invf)
    n0 = (cols[16], cols[17], cols[18])
    n1 = (cols[19], cols[20], cols[21])
    n2v = (cols[22], cols[23], cols[24])
    phong = cols[25] > 0.5
    nph = tuple(alpha * n0[i] + beta * n1[i] + gamma * n2v[i]
                for i in range(3))
    nsel = tuple(torch.where(phong, nph[i], nf[i]) for i in range(3))
    nrm = tuple(torch.where(is_t, nsel[i], 0.0) for i in range(3))

    # hit point and plane re-projection (shade.resolve_hit)
    P = (ox + t_use * dx, oy + t_use * dy, oz + t_use * dz)
    q = (P[0] - p2[0], P[1] - p2[1], P[2] - p2[2])
    dd = _dot(*nf, *q)
    point = tuple(torch.where(is_t, P[i] - dd * nf[i], P[i])
                  for i in range(3))

    # the triangle's material row (tri_pack columns 32:48)
    kd = (cols[32], cols[33], cols[34])
    ka = (cols[35], cols[36], cols[37])
    ks = (cols[38], cols[39], cols[40])
    shin = cols[41]
    mirror = torch.where(is_t, cols[42], 0.0)

    # Phong with the fixed shadow mask (tracer.lighting_from_mask)
    col = [amb[0] * ka[0], amb[1] * ka[1], amb[2] * ka[2]]
    per_light = []
    for li in range(L):
        lv = (lp[li][0] - point[0], lp[li][1] - point[1],
              lp[li][2] - point[2])
        okl, invl = _inv_norm(_dot(*lv, *lv))
        ld = (lv[0] * invl, lv[1] * invl, lv[2] * invl)
        diff = torch.clamp(_dot(*nrm, *ld), min=0.0)
        ln = _dot(*ld, *nrm)
        m = (2.0 * ln * nrm[0] - ld[0], 2.0 * ln * nrm[1] - ld[1],
             2.0 * ln * nrm[2] - ld[2])
        okm, invm = _inv_norm(_dot(*m, *m))
        r = (m[0] * invm, m[1] * invm, m[2] * invm)
        cos_rv = torch.clamp(_dot(*r, -dx, -dy, -dz), min=0.0)
        gate = (diff > 0.0) & (cos_rv > 0.0)
        base = torch.where(gate, cos_rv, 1.0)
        spec = torch.where(gate, torch.pow(base, shin), 0.0)
        for ci in range(3):
            col[ci] = col[ci] + lc[li][ci] * lit[li] * (
                kd[ci] * diff + ks[ci] * spec)
        per_light.append(dict(lv=lv, okl=okl, invl=invl, ld=ld, diff=diff,
                              ln=ln, m=m, okm=okm, invm=invm, r=r,
                              cos_rv=cos_rv, gate=gate, base=base,
                              spec=spec))

    wf = w * (1.0 - mirror)
    add = tuple(torch.where(h, wf * col[i], 0.0)
                + torch.where(miss, w * bg[i], 0.0) for i in range(3))

    # mirror bounce
    dn = _dot(dx, dy, dz, *nrm)
    refl = (dx - 2.0 * dn * nrm[0], dy - 2.0 * dn * nrm[1],
            dz - 2.0 * dn * nrm[2])
    o2 = tuple(torch.where(h, point[i] + EPS_OFFSET * refl[i], o[i])
               for i in range(3))
    d2 = tuple(torch.where(h, refl[i], d[i]) for i in range(3))
    w2 = torch.where(h, w * mirror, 0.0)

    inter = dict(c1=c1, c2=c2, c3=c3, c4=c4, Dt=Dt, Da=Da, Db=Db,
                 ok_s=ok_s, inv_s=inv_s, alpha=alpha, beta=beta,
                 gamma=gamma, valid=valid, t_use=t_use, e1=e1, e2=e2, cr=cr,
                 okf=okf, invf=invf, nf=nf, n0=n0, n1=n1, n2v=n2v,
                 phong=phong, nrm=nrm, q=q, dd=dd, kd=kd, ka=ka, ks=ks,
                 shin=shin, mirror=mirror, col=col, per_light=per_light,
                 dn=dn, wf=wf)
    return (add, o2, d2, w2), inter


def _bwd_core(o, d, w, cols, lp, lc, amb, bg, is_t, h, miss, lit, L,
              g_add, g_o2, g_d2, g_w2):
    """Hand-derived reverse of :func:`_fwd_core` (not autograd).

    Returns (g_o(3), g_d(3), g_w, g_cols dict, g_lp [L][3], g_lc [L][3],
    g_amb(3), g_bg(3)); the light and env cotangents are per ray.
    Accumulations keep the reference's order, term by term, with one
    change: the normalize reverse forms ``v * (2 g_n2)`` where the
    reference forms ``(2 v) * g_n2``. The two are equal bit for bit,
    except that ``2 v`` overflows to inf when a recorded triangle hit
    fails the re-solve (t = INF puts the point near 3e38) and then
    inf * 0 = NaN poisons the vertex and light gradients; autograd of the
    forward stays finite there, and so does this form.
    """
    _, iv = _fwd_core(o, d, w, cols, lp, lc, amb, bg, is_t, h, miss, lit, L)
    dx, dy, dz = d
    z = torch.zeros_like(w)
    g_o = [z, z, z]
    g_d = [z, z, z]
    g_w = z
    gc = {c: z for c in _GRAD_COLS}
    g_point = [z, z, z]
    g_nrm = [z, z, z]
    g_t = z
    g_alpha = z
    g_beta = z
    g_nf = [z, z, z]
    g_mirror = z
    nrm, mirror, col = iv["nrm"], iv["mirror"], iv["col"]
    kd, ka, ks, shin = iv["kd"], iv["ka"], iv["ks"], iv["shin"]

    # bounce reverse
    g_refl = [torch.where(h, EPS_OFFSET * g_o2[i] + g_d2[i], 0.0)
              for i in range(3)]
    for i in range(3):
        g_point[i] = g_point[i] + torch.where(h, g_o2[i], 0.0)
        g_o[i] = g_o[i] + torch.where(h, 0.0, g_o2[i])
        g_d[i] = g_d[i] + torch.where(h, 0.0, g_d2[i])
    g_w = g_w + torch.where(h, mirror * g_w2, 0.0)
    g_mirror = g_mirror + torch.where(h, w * g_w2, 0.0)
    # refl = d - 2 (d.n) n
    ngr = _dot(*nrm, *g_refl)
    dn = iv["dn"]
    for i in range(3):
        g_d[i] = g_d[i] + (g_refl[i] - 2.0 * nrm[i] * ngr)
    for i, di in enumerate((dx, dy, dz)):
        g_nrm[i] = g_nrm[i] + -2.0 * (di * ngr + dn * g_refl[i])

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
    for i in range(3):
        gc[35 + i] = gc[35 + i] + g_col[i] * amb[i]
    g_lp, g_lc = [], []
    for li in range(L):
        pl_ = iv["per_light"][li]
        ld, diff, spec = pl_["ld"], pl_["diff"], pl_["spec"]
        g_lc.append([g_col[i] * lit[li] * (kd[i] * diff + ks[i] * spec)
                     for i in range(3)])
        g_diff = z
        g_spec = z
        for i in range(3):
            gc[32 + i] = gc[32 + i] + g_col[i] * lc[li][i] * lit[li] * diff
            gc[38 + i] = gc[38 + i] + g_col[i] * lc[li][i] * lit[li] * spec
            g_diff = g_diff + g_col[i] * lc[li][i] * lit[li] * kd[i]
            g_spec = g_spec + g_col[i] * lc[li][i] * lit[li] * ks[i]
        gate, base, cos_rv = pl_["gate"], pl_["base"], pl_["cos_rv"]
        # off the gate base = 1: pow and log stay finite there
        g_base = torch.where(
            gate, shin * torch.pow(base, shin - 1.0) * g_spec, 0.0)
        gc[41] = gc[41] + torch.where(
            gate, spec * torch.log(base) * g_spec, 0.0)
        g_cos = g_base
        pos = cos_rv > 0.0
        r = pl_["r"]
        # rv = r . (-d)
        rvg = torch.where(pos & gate, g_cos, 0.0)
        g_r = [rvg * (-di) for di in (dx, dy, dz)]
        for i, ri in enumerate(r):
            g_d[i] = g_d[i] + -rvg * ri
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
        # ld = normalize(lv)
        lv, invl, okl = pl_["lv"], pl_["invl"], pl_["okl"]
        g_invl = g_ld[0] * lv[0] + g_ld[1] * lv[1] + g_ld[2] * lv[2]
        g_n2l = torch.where(okl, -0.5 * invl * invl * invl * g_invl, 0.0)
        g_lv = [g_ld[i] * invl + lv[i] * (2.0 * g_n2l) for i in range(3)]
        g_lp.append(g_lv)
        for i in range(3):
            g_point[i] = g_point[i] + -g_lv[i]

    # mirror leaf
    gc[42] = gc[42] + torch.where(is_t, g_mirror, 0.0)

    # point / re-projection reverse
    nf, q, dd = iv["nf"], iv["q"], iv["dd"]
    g_pr = [torch.where(is_t, g_point[i], 0.0) for i in range(3)]
    g_P = [torch.where(is_t, 0.0, g_point[i]) for i in range(3)]
    nfg = _dot(*nf, *g_pr)
    for i in range(3):
        g_P[i] = g_P[i] + (g_pr[i] - nf[i] * nfg)
        gc[6 + i] = gc[6 + i] + nf[i] * nfg                # p2 via q
        g_nf[i] = g_nf[i] + -(q[i] * nfg + dd * g_pr[i])
    # P = o + t d
    t_use = iv["t_use"]
    for i, di in enumerate((dx, dy, dz)):
        g_o[i] = g_o[i] + g_P[i]
        g_d[i] = g_d[i] + t_use * g_P[i]
        g_t = g_t + di * g_P[i]

    # normal select reverse
    phong, alpha, beta, gamma = (iv["phong"], iv["alpha"], iv["beta"],
                                 iv["gamma"])
    n0, n1, n2v = iv["n0"], iv["n1"], iv["n2v"]
    g_nsel = [torch.where(is_t, g_nrm[i], 0.0) for i in range(3)]
    g_nph = [torch.where(phong, g_nsel[i], 0.0) for i in range(3)]
    g_nf2 = [torch.where(phong, 0.0, g_nsel[i]) for i in range(3)]
    for i in range(3):
        g_nf[i] = g_nf[i] + g_nf2[i]
        gc[16 + i] = gc[16 + i] + alpha * g_nph[i]
        gc[19 + i] = gc[19 + i] + beta * g_nph[i]
        gc[22 + i] = gc[22 + i] + gamma * g_nph[i]
        g_alpha = g_alpha + g_nph[i] * (n0[i] - n2v[i])
        g_beta = g_beta + g_nph[i] * (n1[i] - n2v[i])

    # flat normal reverse
    cr, invf, okf = iv["cr"], iv["invf"], iv["okf"]
    e1, e2 = iv["e1"], iv["e2"]
    g_invf = g_nf[0] * cr[0] + g_nf[1] * cr[1] + g_nf[2] * cr[2]
    g_n2f = torch.where(okf, -0.5 * invf * invf * invf * g_invf, 0.0)
    g_cr = [g_nf[i] * invf + cr[i] * (2.0 * g_n2f) for i in range(3)]
    g_e1 = _cross(*e2, *g_cr)
    g_e2 = _cross(*g_cr, *e1)
    for i in range(3):
        gc[3 + i] = gc[3 + i] + g_e1[i]                    # p1
        gc[6 + i] = gc[6 + i] + g_e2[i]                    # p2
        gc[0 + i] = gc[0 + i] + (-g_e1[i] - g_e2[i])       # p0

    # Cramer reverse; inv_s = 0 off ok_s, and g_s is selected there
    Dt, Da, Db = iv["Dt"], iv["Da"], iv["Db"]
    ok_s, inv_s, valid = iv["ok_s"], iv["inv_s"], iv["valid"]
    c1, c2, c3, c4 = iv["c1"], iv["c2"], iv["c3"], iv["c4"]
    g_t_raw = torch.where(is_t & valid, g_t, 0.0)
    g_Dt = g_t_raw * inv_s
    g_Da = g_alpha * inv_s
    g_Db = g_beta * inv_s
    g_inv_s = g_t_raw * Dt + g_alpha * Da + g_beta * Db
    g_s = torch.where(ok_s, -inv_s * inv_s * g_inv_s, 0.0)
    g_c = {k: [z, z, z] for k in (1, 2, 3, 4)}
    cv = {1: c1, 2: c2, 3: c3, 4: c4}

    def acc_det(gv, ia, ib, ic):
        a, b, c = cv[ia], cv[ib], cv[ic]
        bxc = _cross(*b, *c)
        cxa = _cross(*c, *a)
        axb = _cross(*a, *b)
        for i in range(3):
            g_c[ia][i] = g_c[ia][i] + gv * bxc[i]
            g_c[ib][i] = g_c[ib][i] + gv * cxa[i]
            g_c[ic][i] = g_c[ic][i] + gv * axb[i]

    acc_det(g_s, 1, 2, 3)
    acc_det(g_Dt, 1, 2, 4)
    acc_det(g_Da, 4, 2, 3)
    acc_det(g_Db, 1, 4, 3)
    for i in range(3):
        gc[0 + i] = gc[0 + i] + g_c[1][i]
        gc[3 + i] = gc[3 + i] + g_c[2][i]
        gc[6 + i] = gc[6 + i] + (-g_c[1][i] - g_c[2][i] - g_c[4][i])
        g_o[i] = g_o[i] + g_c[4][i]
        g_d[i] = g_d[i] + -g_c[3][i]

    return g_o, g_d, g_w, gc, g_lp, g_lc, g_amb, g_bg


def _core_args(o, d, w, tri_pack, tri_idx, light_pos, light_color,
               ambience, background, is_t, h, miss, lit):
    L = light_pos.shape[0]
    rows = tri_pack[tri_idx.long()]
    cols = {c: rows[:, c] for c in _COLS}
    lp = [light_pos[li].unbind(0) for li in range(L)]
    lc = [light_color[li].unbind(0) for li in range(L)]
    return (o.unbind(1), d.unbind(1), w, cols, lp, lc, ambience.unbind(0),
            background.unbind(0), is_t, h, miss, lit.unbind(0), L)


def segment_plain(o, d, w, tri_pack, tri_idx, light_pos, light_color,
                  ambience, background, is_t, h, miss, lit):
    """Plain version of K5; arguments and results as :func:`segment_fwd`."""
    (add, o2, d2, w2), _ = _fwd_core(*_core_args(
        o, d, w, tri_pack, tri_idx, light_pos, light_color, ambience,
        background, is_t, h, miss, lit))
    return (torch.stack(add, dim=1), torch.stack(o2, dim=1),
            torch.stack(d2, dim=1), w2)


def segment_bwd_rows_plain(o, d, w, tri_pack, tri_idx, light_pos,
                           light_color, ambience, background, is_t, h, miss,
                           lit, g_add, g_o2, g_d2, g_w2):
    """K6's reverse before the row sum: arguments and results as
    :func:`segment_bwd`, with g_rows [R, 29], each ray's ``tri_pack`` row
    cotangent in ``_GRAD_COLS`` order, in place of g_pack."""
    g_o, g_d, g_w, gc, g_lp, g_lc, g_amb, g_bg = _bwd_core(
        *_core_args(o, d, w, tri_pack, tri_idx, light_pos, light_color,
                    ambience, background, is_t, h, miss, lit),
        g_add.unbind(1), g_o2.unbind(1), g_d2.unbind(1), g_w2)

    def total(rows):
        if not rows:
            return light_pos.new_zeros((0, 3))
        return torch.stack([torch.stack([x.sum() for x in row])
                            for row in rows])

    return (torch.stack(g_o, dim=1), torch.stack(g_d, dim=1), g_w,
            torch.stack([gc[c] for c in _GRAD_COLS], dim=1),
            total(g_lp), total(g_lc),
            torch.stack([x.sum() for x in g_amb]),
            torch.stack([x.sum() for x in g_bg]))


def segment_bwd_plain(o, d, w, tri_pack, tri_idx, light_pos, light_color,
                      ambience, background, is_t, h, miss, lit,
                      g_add, g_o2, g_d2, g_w2):
    """Plain version of K6; arguments and results as :func:`segment_bwd`:
    the per-ray rows, then ``index_add_`` into the ``_GRAD_COLS``
    columns."""
    g_o, g_d, g_w, g_rows, *env = segment_bwd_rows_plain(
        o, d, w, tri_pack, tri_idx, light_pos, light_color, ambience,
        background, is_t, h, miss, lit, g_add, g_o2, g_d2, g_w2)
    g_pack = torch.zeros_like(tri_pack)
    # _GRAD_COLS is three runs of columns; slices keep the index on the
    # host (a list index would be copied to the device)
    for a, b, k in ((0, 9, 0), (16, 25, 9), (32, 43, 18)):
        g_pack[:, a:b].index_add_(0, tri_idx.long(), g_rows[:, k:k + b - a])
    return (g_o, g_d, g_w, g_pack, *env)


#: argument names of the wrappers, then the backward's cotangents, with
#: the dtype letter check_inputs reads (f float32, i int32, b bool)
_ARGS = dict(o="f", d="f", w="f", tri_pack="f", tri_idx="i", light_pos="f",
             light_color="f", ambience="f", background="f", is_t="b", h="b",
             miss="b", lit="f", g_add="f", g_o2="f", g_d2="f", g_w2="f")


def _check(name, tensors):
    """Raise ValueError unless the wrapper's tensors have the dtypes,
    device, contiguity and shapes the kernels read; returns (device, R, L).
    """
    named = dict(zip(_ARGS, tensors))
    o, tri_pack = named["o"], named["tri_pack"]
    R, L = o.shape[0], named["light_pos"].shape[0]
    _build.check_inputs(name, o.device,
                        **{f"{k}_{_ARGS[k]}": t for k, t in named.items()})
    shapes = dict(o=(R, 3), d=(R, 3), w=(R,), tri_idx=(R,),
                  light_pos=(L, 3), light_color=(L, 3), ambience=(3,),
                  background=(3,), is_t=(R,), h=(R,), miss=(R,), lit=(L, R),
                  g_add=(R, 3), g_o2=(R, 3), g_d2=(R, 3), g_w2=(R,))
    for k, t in named.items():
        if k in shapes and tuple(t.shape) != shapes[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {shapes[k]}")
    if tri_pack.dim() != 2 or tri_pack.shape[1] < 43:
        raise ValueError(f"{name}: tri_pack must be [T, 48], got "
                         f"{tuple(tri_pack.shape)}")
    return o.device, R, L


def segment_fwd(o, d, w, tri_pack, tri_idx, light_pos, light_color,
                ambience, background, is_t, h, miss, lit):
    """Forward shade segment (K5 on CUDA tensors).

    Args: o, d [R, 3] f32; w [R] f32 ray weight; tri_pack [T, 48] f32;
    tri_idx [R] i32 the recorded triangle of each ray, in [0, T) (read
    unchecked by the kernel); light_pos, light_color [L, 3] f32;
    ambience, background [3] f32; is_t (the ray hit a triangle), h (live
    hit), miss (live miss) [R] bool; lit [L, R] f32 (1 = unshadowed).
    Returns (add [R, 3], o2 [R, 3], d2 [R, 3], w2 [R]).
    """
    if o.device.type == "cpu":
        return segment_plain(o, d, w, tri_pack, tri_idx, light_pos,
                             light_color, ambience, background, is_t, h,
                             miss, lit)
    dev, R, L = _check("segment_fwd", (o, d, w, tri_pack, tri_idx, light_pos,
                                       light_color, ambience, background,
                                       is_t, h, miss, lit))
    f32 = dict(dtype=torch.float32, device=dev)
    add = torch.empty((R, 3), **f32)
    o2 = torch.empty((R, 3), **f32)
    d2 = torch.empty((R, 3), **f32)
    w2 = torch.empty(R, **f32)
    if R:
        _build.launch(
            "mrt_seg_fwd", "seg_fwd", dev, o.data_ptr(), d.data_ptr(),
            w.data_ptr(), tri_idx.data_ptr(), tri_pack.data_ptr(),
            tri_pack.shape[1], is_t.data_ptr(), h.data_ptr(), miss.data_ptr(),
            lit.data_ptr(), light_pos.data_ptr(), light_color.data_ptr(),
            ambience.data_ptr(), background.data_ptr(), L, R, add.data_ptr(),
            o2.data_ptr(), d2.data_ptr(), w2.data_ptr())
    return add, o2, d2, w2


def segment_bwd(o, d, w, tri_pack, tri_idx, light_pos, light_color,
                ambience, background, is_t, h, miss, lit,
                g_add, g_o2, g_d2, g_w2):
    """Reverse of :func:`segment_fwd` (K6 on CUDA tensors).

    Arguments as :func:`segment_fwd`, plus the output cotangents g_add,
    g_o2, g_d2 [R, 3] and g_w2 [R] f32. Returns (g_o [R, 3], g_d [R, 3],
    g_w [R], g_pack [T, 48] the ``tri_pack`` cotangent (each ray's row
    cotangent summed into its triangle's ``_GRAD_COLS`` columns, zero
    elsewhere), g_light_pos [L, 3], g_light_color [L, 3], g_ambience [3],
    g_background [3]); g_pack and the last four are sums over the rays
    (in the kernel by warp and block reductions and atomics, so their
    order of summation varies from run to run).
    """
    if o.device.type == "cpu":
        return segment_bwd_plain(o, d, w, tri_pack, tri_idx, light_pos,
                                 light_color, ambience, background, is_t, h,
                                 miss, lit, g_add, g_o2, g_d2, g_w2)
    dev, R, L = _check("segment_bwd", (o, d, w, tri_pack, tri_idx, light_pos,
                                       light_color, ambience, background,
                                       is_t, h, miss, lit, g_add, g_o2, g_d2,
                                       g_w2))
    f32 = dict(dtype=torch.float32, device=dev)
    g_o = torch.empty((R, 3), **f32)
    g_d = torch.empty((R, 3), **f32)
    g_w = torch.empty(R, **f32)
    g_pack = torch.zeros_like(tri_pack)
    # g_light_pos | g_light_color | g_ambience | g_background
    g_env = torch.zeros(6 * L + 6, **f32)
    if R:
        _build.launch(
            "mrt_seg_bwd", "seg_bwd", dev, o.data_ptr(), d.data_ptr(),
            w.data_ptr(), tri_idx.data_ptr(), tri_pack.data_ptr(),
            tri_pack.shape[1], is_t.data_ptr(), h.data_ptr(), miss.data_ptr(),
            lit.data_ptr(), light_pos.data_ptr(), light_color.data_ptr(),
            ambience.data_ptr(), background.data_ptr(), g_add.data_ptr(),
            g_o2.data_ptr(), g_d2.data_ptr(), g_w2.data_ptr(), L, R,
            g_o.data_ptr(), g_d.data_ptr(), g_w.data_ptr(), g_pack.data_ptr(),
            g_env.data_ptr())
    return (g_o, g_d, g_w, g_pack, g_env[:3 * L].view(L, 3),
            g_env[3 * L:6 * L].view(L, 3), g_env[6 * L:6 * L + 3],
            g_env[6 * L + 3:])


class ShadeSegment(torch.autograd.Function):
    """One differentiable shade segment: K5 forward, K6 backward.

    ``ShadeSegment.apply(o, d, w, tri_pack, tri_idx, light_pos,
    light_color, ambience, background, is_t, h, miss, lit, plain)`` ->
    (add, o2, d2, w2), with arguments as :func:`segment_fwd`;
    ``plain=True`` runs the plain versions on any device. The saved
    residuals are the inputs. The backward returns the cotangents of o,
    d, w, tri_pack, the lights, ambience and background, and None for the
    index, the masks, lit and ``plain``.
    """

    @staticmethod
    def forward(ctx, o, d, w, tri_pack, tri_idx, light_pos, light_color,
                ambience, background, is_t, h, miss, lit, plain):
        args = (o, d, w, tri_pack, tri_idx, light_pos, light_color,
                ambience, background, is_t, h, miss, lit)
        ctx.save_for_backward(*args)
        ctx.plain = plain
        return (segment_plain if plain else segment_fwd)(*args)

    @staticmethod
    def backward(ctx, g_add, g_o2, g_d2, g_w2):
        args = ctx.saved_tensors
        bwd = segment_bwd_plain if ctx.plain else segment_bwd
        g_o, g_d, g_w, g_pack, g_lp, g_lc, g_amb, g_bg = bwd(
            *args, g_add.contiguous(), g_o2.contiguous(), g_d2.contiguous(),
            g_w2.contiguous())
        return (g_o, g_d, g_w, g_pack, None, g_lp, g_lc, g_amb, g_bg,
                None, None, None, None, None)

