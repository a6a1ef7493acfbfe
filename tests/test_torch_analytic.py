"""The port's analytic and texture paths vs the reference.

Covers what the golden gallery adds to the forward render: the sphere,
plane and cylinder intersectors, the dense closest-hit merge and the
analytic occlusion, the analytic and texture branches of the K3/K4 plain
versions, the nearest-texel fetch, and ``render_aa``. The reference runs
its Pallas kernels in interpret mode; the port runs the plain PyTorch
versions (CPU tensors). Both get the same packed scene.

Tolerances: the intersectors' t to the bit (the same fp32 expressions in
the same order); the merge's kinds and ids equal, t within rtol 1e-6;
K3/K4 within rtol 1e-4 / atol 3e-5 with integer outputs equal (the
reference's own bar for its fused shading against its XLA shading); the
render >= 99.5% of pixels within 1e-4 (a flipped fp tie changes a
pixel's hit, not the image).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import (FLAT as RFLAT, PHONG as RPHONG,
                                         TriangleMesh as RMesh)
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import intersect as risx
from myraytracer_tpu.ops import pallas_shade as rps
from myraytracer_tpu.ops import shade as rshade
from myraytracer_tpu.ops import texture as rtex
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import render_aa as r_render_aa
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.kernels import _build as kbuild
from myraytracer_tpu_torch.ops import cuda_analytic as ca
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import intersect as isx
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade, texture
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.scenes import kinds

from test_torch_scene import to_port

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)
KTOL = dict(rtol=1e-4, atol=3e-5)

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


#: the reference's authoring API, in the order scenes/kinds.py takes it
REF_API = (RScene, RMaterial, RMesh, RPHONG, RFLAT, r_uv_sphere)


#: (scene builder, kwargs) of the K3/K4 and render cases
SCENES = {
    "mixed": (kinds.mixed_scene, {}),
    "mixed_mirror_nocyl": (kinds.mixed_scene, dict(mirror=0.35, cyl=False)),
    "triless": (kinds.mixed_scene, dict(tris=False)),
    "textured": (kinds.textured_scene, {}),
}


def _build(name, w=40, h=40):
    """(reference Scene, its SceneData, that data carried to the port,
    the port's camera of the same scene)."""
    make, kw = SCENES[name]
    s = make(w=w, h=h, api=REF_API, **kw)
    ref = s.build()
    return s, ref, to_port(ref), make(w=w, h=h, **kw).camera


def _pixel_rays(s):
    xs, ys = s.camera.pixel_grid()
    o, d = s.camera.primary_rays(xs.ravel(), ys.ravel())
    return np.array(o), np.array(d)


# ---------------------------------------------------------------------------
# intersectors
# ---------------------------------------------------------------------------

def _random_rays(rng, n):
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 8] = [0.0, 1.0, 0.0]          # parallel to the planes and axes
    d[n // 8: n // 4] *= rng.uniform(0.1, 3.0, (n // 8, 1)).astype(np.float32)
    return o, d


def _prims(rng, P):
    c = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    n = rng.normal(size=(P, 3)).astype(np.float32)
    n[: P // 3] = [0.0, 1.0, 0.0]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r = rng.uniform(0.2, 2.0, P).astype(np.float32)
    h = rng.uniform(0.5, 3.0, P).astype(np.float32)
    return c, n, r, h


@pytest.mark.parametrize("kind", ["sphere", "plane", "cylinder"])
def test_intersector_matches_reference(kind):
    rng = np.random.default_rng({"sphere": 0, "plane": 1, "cylinder": 2}[kind])
    o, d = _random_rays(rng, 600)
    c, n, r, h = _prims(rng, 9)
    args = [o[:, None], d[:, None], c[None]]
    if kind == "sphere":
        args += [r[None]]
    elif kind == "plane":
        args += [n[None]]
    else:
        args += [n[None], r[None], h[None]]
    fn = dict(sphere="ray_sphere", plane="ray_plane", cylinder="ray_cylinder")[kind]
    want = np.asarray(getattr(risx, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(isx, fn)(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in args)).numpy()
    assert got.shape == want.shape == (600, 9)
    hit = want < np.float32(isx.INF)
    assert 0.02 < hit.mean() < 0.98
    np.testing.assert_array_equal(got, want)


def test_dot_last_matches_reference():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 50, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        isx.dot_last(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(risx.dot_last(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# the dense closest-hit merge and the analytic occlusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixed", "triless"])
def test_closest_analytic_matches_reference(name, monkeypatch):
    s, ref, port, _ = _build(name)
    o, d = _pixel_rays(s)
    want = [np.asarray(x) for x in rtr._closest_analytic(
        ref, jnp.asarray(o), jnp.asarray(d))]
    # a budget far below the frame forces several ray steps
    monkeypatch.setattr(tr, "ANA_BUDGET", 700)
    got = [x.numpy() for x in tr._closest_analytic(
        port, torch.from_numpy(o), torch.from_numpy(d))]
    for i, nm in enumerate(("kind", "idx", "aidx")):
        np.testing.assert_array_equal(got[i], want[i], err_msg=nm)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    assert len(set(want[0].tolist())) >= 3       # several kinds on screen


def test_analytic_occlusion_matches_reference(monkeypatch):
    s, ref, port, _ = _build("mixed")
    rng = np.random.default_rng(4)
    n = 2000
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) - 0.8
    to = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    to[:, 1] = rng.uniform(1, 5, n)
    v = to - o
    dist = np.linalg.norm(v, axis=1).astype(np.float32)
    d = (v / dist[:, None]).astype(np.float32)
    want = np.asarray(rtr._analytic_occlusion(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist)))
    monkeypatch.setattr(tr, "ANA_BUDGET", 1000)
    got = tr._analytic_occlusion(port, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(dist)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want.mean() < 0.95


def test_mesh_only_scene_skips_the_analytic_tests():
    s, ref, port, _ = _build("textured")
    o, d = (torch.from_numpy(x.copy()) for x in _pixel_rays(s))
    kind, idx, aidx, t = tr._closest_analytic(port, o, d)
    assert (kind == shade.KIND_MISS).all() and (t == isx.INF).all()
    assert not tr._analytic_occlusion(port, o, d, t).any()


def test_analytic_kernel_is_registered():
    """K8 (csrc/analytic.cu) builds without FMA contraction, has its C
    signature, and counts the launches of both modes."""
    assert (kbuild.CSRC_DIR / "analytic.cu").exists()
    assert "analytic.cu" in kbuild.NO_FMA
    assert {"analytic_closest", "analytic_anyhit"} <= set(kbuild.LAUNCHES)
    assert "mrt_analytic" in kbuild._SIGNATURES


def test_analytic_kernel_wrappers_refuse_cpu_tensors():
    o = torch.zeros((4, 3))
    ana16 = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ca.closest_analytic(o, o, ana16, (1, 0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ca.analytic_anyhit(o, o, torch.ones(4), None, ana16, (1, 0, 0))


@pytest.mark.parametrize("plain", [False, True])
def test_cpu_queries_take_the_plain_analytic_tests(plain):
    """closest_hit and shadow_mask on CPU tensors, with and without
    TraceConfig(plain=True), return the plain versions' values and
    launch nothing; the occlusion takes the shadow batch's [R, 4] rows."""
    s, ref, port, _ = _build("triless")
    o, d = (torch.from_numpy(x.copy()) for x in _pixel_rays(s))
    cfg = tr.TraceConfig(plain=plain)
    pack = tr.pack_trace(port, cfg)
    R = o.shape[0]
    live = torch.arange(R) % 7 != 0
    before = dict(kbuild.LAUNCHES)
    kind, pidx, aidx, t = tr.closest_hit(port, pack, o, d, live, cfg)
    want = tr._closest_analytic_plain(port, o, d)
    assert torch.equal(kind, torch.where(live, want[0], shade.KIND_MISS))
    for a, b in zip((pidx, aidx, t), want[1:]):
        assert torch.equal(a, b)

    valid = kind != shade.KIND_MISS
    zero = torch.zeros_like(pidx)
    g = pack.geom
    so, sd, st, sact = cs.shade_pre_plain(
        o, d, t, kind, live.to(torch.int32), zero,
        torch.where(valid, aidx, zero), g.tri_pack, g.ana16, g.mat16,
        port.light_pos, port.texels.shape[0])[4:]
    cast = sact > 0
    occ = tr._analytic_occlusion_plain(port, so[:, :3], sd[:, :3], st)
    assert torch.equal(tr.shadow_mask(port, pack, so, sd, st, sact, cfg),
                       (cast & occ).to(torch.int32))
    assert torch.equal(tr._analytic_occlusion(port, so, sd, st, cast),
                       cast & occ)
    assert bool((cast & occ).any()) and bool((cast & ~occ).any())
    assert kbuild.LAUNCHES == before


# ---------------------------------------------------------------------------
# K3 / K4 plain versions vs the reference kernels
# ---------------------------------------------------------------------------

def _segment_inputs(name, seed):
    """Primary-ray hits of a scene, merged like the port's segment."""
    s, ref, port, _ = _build(name)
    o, d = _pixel_rays(s)
    R = o.shape[0]
    rng = np.random.default_rng(seed)
    live = rng.uniform(size=R) > 0.1
    pack = tr.pack_trace(port)
    kind, pidx, aidx, t = tr.closest_hit(
        port, pack, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(live))
    kind, pidx, aidx, t = (x.numpy() for x in (kind, pidx, aidx, t))
    valid = kind != shade.KIND_MISS
    return dict(s=s, ref=ref, port=port, pack=pack, o=o, d=d, live=live,
                kind=kind, t=t, valid=valid, rng=rng,
                tri_idx=np.where(kind == shade.KIND_TRI, pidx, 0).astype(np.int32),
                aidx=np.where(valid, aidx, 0).astype(np.int32))


def _port_pre(x, mat16=None):
    g = x["pack"].geom
    T = torch.from_numpy
    return cs.shade_pre(
        T(x["o"]), T(x["d"]), T(x["t"]), T(x["kind"]),
        T(x["live"].astype(np.int32)), T(x["tri_idx"]), T(x["aidx"]),
        g.tri_pack, g.ana16, g.mat16 if mat16 is None else T(mat16),
        x["port"].light_pos, x["port"].texels.shape[0])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_pre_branches_match_reference(name):
    x = _segment_inputs(name, seed=0)
    ref = x["ref"]
    rg = rshade.pack_shade_geom(ref)
    kind = x["kind"]
    rows = None
    if ref.n_tris:
        rows = rg.tri_pack[jnp.asarray(x["tri_idx"])]
    ana = None
    if shade.has_analytic(ref):
        ana = rg.ana16[jnp.asarray(x["aidx"])]
    want = rps.shade_pre(
        jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(x["t"]),
        jnp.asarray(kind), jnp.asarray(x["live"]), rows, ana, rg.mat16,
        ref.light_pos, want_tex=bool(ref.has_textures) and ref.n_tris > 0,
        atlas_size=ref.texels.shape[0], interpret=True)
    got = [t.numpy() for t in _port_pre(x)]
    point, normal, mid, texid, so, sd, st, sact = want
    for nm, a, b in (("point", got[0], point), ("normal", got[1], normal),
                     ("so", got[4], so), ("sd", got[5], sd), ("st", got[6], st)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=nm, **KTOL)
    np.testing.assert_array_equal(got[2], np.asarray(mid))
    np.testing.assert_array_equal(got[7], np.asarray(sact))
    if texid is None:
        assert (got[3] == -1).all()
    else:
        np.testing.assert_array_equal(got[3], np.asarray(texid))
        assert (got[3] >= 0).mean() > 0.2
    present = set(kind[x["valid"]].tolist())
    want_kinds = {"mixed": {1, 2, 3, 4}, "mixed_mirror_nocyl": {1, 2, 3},
                  "triless": {1, 2, 4}, "textured": {3}}[name]
    assert present == want_kinds


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_phong_branches_match_reference(name):
    x = _segment_inputs(name, seed=1)
    ref, rng = x["ref"], x["rng"]
    R = x["o"].shape[0]
    L = ref.n_lights
    mat16 = x["pack"].geom.mat16.numpy().copy()
    mat16[:, 10] = np.linspace(0.0, 0.5, mat16.shape[0])    # mirrors
    pre = [t.numpy() for t in _port_pre(x, mat16)]
    point, normal, mid, texid = pre[:4]
    weight = np.where(rng.uniform(size=R) < 0.1, 0.0,
                      rng.uniform(0.2, 1.0, R)).astype(np.float32)
    live = x["live"] & (weight > 0)
    valid = x["valid"]
    shadow = rng.uniform(size=(L, R)) < 0.3
    env = np.concatenate([np.asarray(ref.ambience),
                          np.asarray(ref.background)]).astype(np.float32)
    texel = textured = None
    if ref.has_textures:
        texel = ref.texels[jnp.asarray(np.maximum(texid, 0))]
        textured = jnp.asarray(texid >= 0)
    want = rps.shade_phong(
        jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(weight),
        jnp.asarray(valid), jnp.asarray(live), jnp.asarray(mid),
        jnp.asarray(point), jnp.asarray(normal), jnp.asarray(shadow),
        jnp.asarray(mat16), ref.light_pos, ref.light_color,
        jnp.asarray(env[:3]), jnp.asarray(env[3:]), texel=texel,
        textured=textured, interpret=True)
    T = torch.from_numpy
    got = cs.shade_phong(
        T(x["o"]), T(x["d"]), T(weight), T(valid.astype(np.int32)),
        T(live.astype(np.int32)), T(mid), T(texid), T(point), T(normal),
        T(shadow.astype(np.int32)), T(mat16), x["port"].texels,
        x["port"].light_pos, x["port"].light_color, T(env))
    for nm, a, b in zip(("add", "o2", "d2", "w2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=nm,
                                   **KTOL)
    assert (got[3].numpy() > 0).any() or not (mat16[mid, 10] > 0).any()


def test_texel_index_matches_sample_nearest():
    """K3's float atlas index fetches the texel that the reference's
    integer sample_nearest does, and the port's sample_nearest agrees."""
    x = _segment_inputs("textured", seed=2)
    texid = _port_pre(x)[3]
    port = x["port"]
    is_t = x["kind"] == shade.KIND_TRI
    ti = torch.from_numpy(x["tri_idx"]).long()
    tri_pack = x["pack"].geom.tri_pack
    # barycentrics of the hit from the re-solve on the packed corners
    rows = tri_pack[ti]
    o, d = torch.from_numpy(x["o"]), torch.from_numpy(x["d"])
    _, alpha, beta = isx.ray_triangle(o, d, rows[:, 0:3], rows[:, 3:6],
                                      rows[:, 6:9])
    gamma = 1.0 - alpha - beta
    u = alpha * rows[:, 9] + beta * rows[:, 10] + gamma * rows[:, 11]
    v = alpha * rows[:, 12] + beta * rows[:, 13] + gamma * rows[:, 14]
    rec = port.tri_tex[ti]
    got = texture.sample_nearest(port.texels, rec, u, v).numpy()
    want = np.asarray(rtex.sample_nearest(
        jnp.asarray(port.texels.numpy()), jnp.asarray(rec.numpy()),
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy())))
    np.testing.assert_array_equal(got, want)
    tex = (rec[:, 0] > 0).numpy() & is_t
    assert tex.mean() > 0.2
    fetched = port.texels[texid.clamp(min=0).long()].numpy()
    # the two index forms agree on all but rays whose u or v lands within
    # an ulp of a rounding boundary
    same = (fetched[tex] == got[tex]).all(axis=1)
    assert same.mean() >= 0.99
    assert ((texid.numpy() >= 0) == tex).all()


@pytest.mark.parametrize("name,filt", [("mixed", "nearest"),
                                       ("mixed_mirror_nocyl", "nearest"),
                                       ("triless", "nearest"),
                                       ("textured", "nearest"),
                                       ("textured", "bilinear")])
def test_resolve_hit_matches_reference(name, filt):
    """resolve_hit's every branch on the first segment's recorded hits:
    t, point, normal, diffuse, mirror and shadowable within 1e-5."""
    s, ref, port, cam = _build(name)
    o, d = prender.primary_rays_blocked(cam, "cpu")
    topo = tr.trace_topology(port, o, d)
    kind, idx = topo.kind[0], topo.idx[0]
    got = shade.resolve_hit(port, o, d, kind, idx,
                            shade.pack_shade_geom(port), filt)
    want = rshade.resolve_hit(ref, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()),
                              jnp.asarray(kind.numpy()),
                              jnp.asarray(idx.numpy()), filt)
    for f in ("t", "point", "normal", "diffuse", "mirror", "shadowable"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    kinds_hit = set(kind[got.valid].tolist())
    want_kinds = {"mixed": {1, 2, 3, 4}, "mixed_mirror_nocyl": {1, 2, 3},
                  "triless": {1, 2, 4}, "textured": {3}}[name]
    assert kinds_hit == want_kinds
    # need_colors=False keeps the geometry and drops the colours
    bare = shade.resolve_hit(port, o, d, kind, idx,
                             shade.pack_shade_geom(port), filt,
                             need_colors=False)
    assert torch.equal(bare.point, got.point)
    assert not bare.diffuse.any() and not bare.specular.any()


def test_sample_bilinear_matches_reference():
    """Values and gradients (texels, u, v) against jax.grad."""
    rng = np.random.default_rng(8)
    texels = rng.uniform(size=(13 * 9 + 6 * 17, 3)).astype(np.float32)
    R = 400
    rec = np.where(rng.uniform(size=(R, 1)) < 0.5, [[13, 9, 0]],
                   [[6, 17, 13 * 9]]).astype(np.int32)
    u = rng.uniform(-0.1, 1.1, R).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, R).astype(np.float32)
    cot = rng.normal(size=(R, 3)).astype(np.float32)

    def r_loss(tx, uu, vv):
        return jnp.sum(rtex.sample_bilinear(tx, jnp.asarray(rec), uu, vv)
                       * jnp.asarray(cot))

    want = np.asarray(rtex.sample_bilinear(
        jnp.asarray(texels), jnp.asarray(rec), jnp.asarray(u),
        jnp.asarray(v)))
    r_grads = jax.grad(r_loss, argnums=(0, 1, 2))(
        jnp.asarray(texels), jnp.asarray(u), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (texels, u, v)]
    got = texture.sample_bilinear(leaves[0], torch.from_numpy(rec), *leaves[1:])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), leaves)
    for nm, a, b in zip(("texels", "u", "v"), grads, r_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=nm)
    assert np.abs(np.asarray(r_grads[1])).max() > 0


def test_atlas_limit_raises():
    x = _segment_inputs("textured", seed=3)
    g = x["pack"].geom
    T = torch.from_numpy
    with pytest.raises(ValueError, match="atlas"):
        cs.shade_pre(T(x["o"]), T(x["d"]), T(x["t"]), T(x["kind"]),
                     T(x["live"].astype(np.int32)), T(x["tri_idx"]),
                     T(x["aidx"]), g.tri_pack, g.ana16, g.mat16,
                     x["port"].light_pos, 1 << 24)


def test_packing_of_mixed_scenes_matches_reference():
    for name in ("mixed", "triless", "textured"):
        _, ref, port, _ = _build(name)
        rg, pg = rshade.pack_shade_geom(ref), shade.pack_shade_geom(port)
        for f in ("tri_pack", "mat16", "ana16"):
            np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                          np.asarray(getattr(rg, f)),
                                          err_msg=f"{name}.{f}")


# ---------------------------------------------------------------------------
# the trace and render_aa
# ---------------------------------------------------------------------------

def _agree(got, want, frac=0.995):
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-4).mean() >= frac, (diff <= 1e-4).mean()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_matches_reference(name):
    s, ref, port, _ = _build(name)
    o, d = _pixel_rays(s)
    fused = REF_CFG._replace(fused_shade=True)
    want = np.asarray(rtr.trace(ref, jnp.asarray(o), jnp.asarray(d), fused))
    got = tr.trace(port, torch.from_numpy(o), torch.from_numpy(d)).numpy()
    _agree(got, want)


@pytest.mark.parametrize("name", ["mixed", "mixed_mirror_nocyl"])
def test_render_aa_matches_reference(name):
    s, ref, port, cam = _build(name, w=48, h=40)
    img1 = prender.render(port, cam)
    frac = float((prender._deviation(img1) > prender.AA_THRESHOLD).float().mean())
    budget = min(1.0, 1.25 * frac + 0.01)
    assert prender.aa_budget_covered(img1, budget)
    want = np.asarray(r_render_aa(ref, s.camera, cfg=REF_CFG,
                                  budget_frac=budget))
    got = prender.render_aa(port, cam, budget_frac=budget)
    assert got.shape == (40, 48, 3)
    got = got.numpy()
    _agree(got, want)
    # the AA pass changed the edge pixels it selected
    assert np.abs(got - img1.numpy()).max() > 1e-3


def test_aa_pieces_match_reference():
    from myraytracer_tpu.ops import render as rrender

    s, ref, port, cam = _build("mixed", w=48, h=40)
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    img[10:20, 10:20] = 0.5
    np.testing.assert_allclose(
        prender._deviation(torch.from_numpy(img)).numpy(),
        np.asarray(rrender._deviation(jnp.asarray(img))), rtol=1e-6)
    # deviations all distinct: the top-k set is unique
    want = rrender._aa_rays(s.camera, jnp.asarray(img), 4, 0.02, 0.3)
    got = prender._aa_rays(cam, torch.from_numpy(img), 4, 0.02, 0.3)
    for nm, a, b in zip(("top_idx", "sel", "o", "d"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=nm)
    assert prender.AA_SUBP == rrender.AA_SUBP
    assert prender.AA_THRESHOLD == rrender.AA_THRESHOLD


def test_render_aa_tiled_equals_whole():
    _, _, port, cam = _build("mixed_mirror_nocyl", w=48, h=40)
    whole = prender.render_aa(port, cam, budget_frac=0.2)
    tiled = prender.render_aa(port, cam, tile=1000, budget_frac=0.2)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())
