"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test needs a CUDA device (marker ``needs_cuda``) and skips without
one. The file imports neither JAX nor the reference package, so it runs
on a machine with only PyTorch and nvcc; there the repository's
conftest.py (which sets up JAX) is left out:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels_cuda.py

Tolerances: phase-1 keys and shading outputs within rtol 1e-5 / atol
1e-6 with integer outputs exact (same fp32 expressions in the same order;
the shading kernels are built without FMA contraction). The cluster scan
is built with contraction: hit ids and occlusion agree on >= 99.5% of
rays, t within rtol 5e-5 where the ids agree (the reference's bars). The
shade-segment backward (K6) sums its light and env cotangents with
atomics, and index_add_ sums the row cotangents per triangle, both in a
run-dependent order: cotangents within 3e-5 * max|plain| (the
reference's bar for its hand-derived VJP).
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.kernels import LAUNCHES, build
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import shade, tracer as tr
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.ops.render import primary_rays_blocked, render
from myraytracer_tpu_torch.scenes.golden import scene_08_office

pytestmark = pytest.mark.needs_cuda

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build()
    return torch.device("cuda:0")


def _random_scene(seed, n, dev, spread=8.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    tri = (base + rng.normal(size=(n, 3, 3)) * 0.5).astype(np.float32)
    s = Scene()
    s.add_light((2, 9, 4), (0.8, 0.8, 0.8))
    s.add_mesh(TriangleMesh(tri.reshape(-1, 3), np.arange(3 * n).reshape(n, 3),
                            material=Material(), draw_mode=FLAT))
    return s.build(device=dev), rng


def _rays(rng, R, dev, spread=15.0):
    o = rng.uniform(-spread, spread, size=(R, 3)).astype(np.float32)
    d = rng.uniform(-6, 6, size=(R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _scan_inputs(data, o, d, t_max=None, active=None, any_hit=False):
    o4, d4, t0, act = cc.pad_rays(o, d, t_max, active)
    key = cc.phase1_keys(data, o4, d4, t0, act, any_hit, t_max is not None)
    order, lb, n = cc.visit_lists(key)
    return (o4, d4, t0, act, cc.cluster_boxes(data),
            cc.pack_cluster_constants(data), order, lb, n, data.cl_first,
            data.cl_count, any_hit)


def test_phase1_exact_kernel_matches_plain(cuda):
    data, rng = _random_scene(1, 700, cuda)
    o, d = _rays(rng, 3000, cuda)
    t0 = torch.where(torch.rand(3000, device=cuda) < 0.3,
                     torch.rand(3000, device=cuda) * 20, INF)
    o4, d4, t0p, act = cc.pad_rays(o, d, t0,
                                   torch.rand(3000, device=cuda) > 0.1)
    bb = cc.cluster_boxes(data)
    before = LAUNCHES["phase1_exact"]
    got = cc.phase1_exact(o4, d4, t0p, act, bb)
    assert LAUNCHES["phase1_exact"] == before + 1
    want = cc.phase1_exact_plain(o4, d4, t0p, act, bb)
    torch.testing.assert_close((got < INF), (want < INF))
    fin = want < INF
    torch.testing.assert_close(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_scan_kernel_matches_plain(cuda, any_hit):
    data, rng = _random_scene(2, 900, cuda)
    o, d = _rays(rng, 5000, cuda)
    t_max = active = None
    if any_hit:
        t_max = torch.rand(5000, device=cuda) * 25
        active = torch.rand(5000, device=cuda) > 0.2
    args = _scan_inputs(data, o, d, t_max, active, any_hit)
    tk, ik = cc.cluster_scan(*args)
    tp, ip = cc.cluster_scan_plain(*args)
    assert float((ik == ip).float().mean()) >= 0.995
    if any_hit:
        assert float(((ik >= 0) == (ip >= 0)).float().mean()) >= 0.995
        assert bool((ik >= 0).any())
    else:
        same = (ik == ip) & (ik >= 0)
        assert bool(same.any())
        torch.testing.assert_close(tk[same], tp[same], rtol=5e-5, atol=ATOL)


def test_shading_kernels_match_plain(cuda):
    s = scene_08_office(tess=2, resolution=(96, 64))
    data = s.build(device=cuda)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    R = o.shape[0]
    hit = cc.intersect_clusters(data, o, d, cl_const=pack.cl_const)
    live = (torch.rand(R, device=cuda) > 0.1).to(torch.int32)
    valid = (hit.idx >= 0) & (live > 0)
    kind = torch.where(valid, shade.KIND_TRI, shade.KIND_MISS).to(torch.int32)
    tri_idx = torch.where(valid, hit.idx.clamp(min=0),
                          torch.zeros_like(hit.idx)).contiguous()
    pre_args = (o, d, hit.t, kind, live, tri_idx, pack.geom.tri_pack,
                pack.geom.mat16, data.light_pos)
    pre, pre_p = cs.shade_pre(*pre_args), cs.shade_pre_plain(*pre_args)
    for a, b in zip(pre, pre_p):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)

    mat16 = pack.geom.mat16.clone()
    mat16[:, 10] = 0.3          # mirrors: exercise the bounce outputs
    L = data.n_lights
    shadow = (torch.rand((L, R), device=cuda) < 0.3).to(torch.int32)
    weight = torch.rand(R, device=cuda)
    ph_args = (o, d, weight, valid.to(torch.int32), live, pre[2], pre[0],
               pre[1], shadow, mat16, data.light_pos, data.light_color,
               pack.env)
    for a, b in zip(cs.shade_phong(*ph_args), cs.shade_phong_plain(*ph_args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_render_kernels_match_plain(cuda):
    s = scene_08_office(tess=3, resolution=(160, 90))
    data = s.build(device=cuda)
    got = render(data, s.camera)
    want = render(data, s.camera, cfg=tr.TraceConfig(plain=True))
    diff = (got - want).abs().amax(dim=-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.995
    assert bool(torch.isfinite(got).all())


def test_mirror_scene_tiled_kernels_match_plain(cuda):
    """Two lights, a mirror material (three Whitted segments) and a tiled
    frame: the kernel paths the office 1080p run does not take."""
    from myraytracer_tpu_torch.models.mesh import PHONG
    from myraytracer_tpu_torch.scenes.shapes import uv_sphere

    s = Scene()
    s.set_camera(eye=(0, 0.8, 4.5), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=96, height=64)
    s.add_light((2, 4, 3), (0.7, 0.7, 0.65))
    s.add_light((-3, 2, 1), (0.3, 0.2, 0.2))
    s.max_depth = 2
    v, f = uv_sphere(0.7, 8, 12, center=(0.6, 0.1, 0))
    s.add_mesh(TriangleMesh(v, f, material=Material(
        diffuse=(0.6, 0.2, 0.2), specular=(0.5, 0.5, 0.5), shininess=30,
        mirror=0.4), draw_mode=PHONG))
    v, f = uv_sphere(0.5, 6, 9, center=(-0.8, -0.1, 0.3))
    s.add_mesh(TriangleMesh(v, f, material=Material(diffuse=(0.2, 0.5, 0.3))))
    floor = np.asarray([[-3, -0.9, -3], [3, -0.9, -3], [3, -0.9, 3],
                        [-3, -0.9, 3]], np.float32)
    s.add_mesh(TriangleMesh(floor, [[0, 2, 1], [0, 3, 2]],
                            material=Material(mirror=0.2)))
    data = s.build(device=cuda)
    assert data.n_segments == 3 and data.n_lights == 2
    got = render(data, s.camera, tile=2048)
    want = render(data, s.camera, cfg=tr.TraceConfig(plain=True))
    diff = (got - want).abs().amax(dim=-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.995


def test_wrappers_reject_bad_inputs(cuda):
    data, rng = _random_scene(3, 50, cuda)
    o, d = _rays(rng, 512, cuda)
    o4, d4, t0, act = cc.pad_rays(o, d)
    with pytest.raises(ValueError, match="act"):
        cc.phase1_exact(o4, d4, t0, act.float(), cc.cluster_boxes(data))
    with pytest.raises(ValueError, match="bb"):
        cc.phase1_exact(o4, d4, t0, act, cc.cluster_boxes(data).cpu())


def _segment_inputs(dev, n_lights, seed=7, R=5000):
    """Rays that really hit their recorded triangle (random barycentrics),
    plus misses, dead rays, degenerate triangles and unlit rays."""
    data, rng = _random_scene(seed, 400, dev)
    tri_pack = shade.pack_shade_geom(data).tri_pack.clone()
    T = tri_pack.shape[0]
    degen = torch.arange(T, device=dev) < 20          # zero-area rows
    tri_pack[degen, 3:6] = tri_pack[degen, 0:3]
    tri_pack[T // 2:, 25] = 1.0                       # half PHONG
    tri_pack[:, 16:25] = torch.from_numpy(
        rng.normal(size=(T, 9)).astype(np.float32)).to(dev)
    tri_pack[:, 42] = 0.3                             # mirrors
    ti = rng.integers(0, T, R)
    bary = rng.dirichlet((1.0, 1.0, 1.0), R).astype(np.float32)
    pk = tri_pack.cpu().numpy()
    hitp = (bary[:, :1] * pk[ti, 0:3] + bary[:, 1:2] * pk[ti, 3:6]
            + bary[:, 2:3] * pk[ti, 6:9])
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = hitp - rng.uniform(1.0, 20.0, (R, 1)).astype(np.float32) * d
    u = rng.uniform(size=R)
    is_t = u < 0.75
    h = is_t.copy()
    miss = (u >= 0.75) & (u < 0.9)                    # the rest are dead
    L = n_lights
    lp = rng.uniform(-8, 8, (L, 3)).astype(np.float32)
    lc = rng.uniform(0.2, 1.0, (L, 3)).astype(np.float32)
    lit = (rng.uniform(size=(L, R)) > 0.3).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = (t(o), t(d), t(rng.uniform(0.2, 1.0, R).astype(np.float32)),
            tri_pack.contiguous(), t(ti.astype(np.int32)), t(lp), t(lc),
            t(np.float32([0.2, 0.15, 0.1])), t(np.float32([0.05, 0.1, 0.3])),
            t(is_t), t(h), t(miss), t(lit))
    cots = [t(rng.normal(size=s).astype(np.float32))
            for s in ((R, 3), (R, 3), (R, 3), (R,))]
    # a ray on a degenerate row keeps the point at t = INF: no bounce
    # cotangent there, or the exact reverse is inf * 0
    on_degen = degen[args[4].long()]
    cots[1][on_degen] = 0.0
    return args, cots


def _close_scaled(got, want, name, rel=3e-5):
    tol = rel * max(float(want.abs().max()), 1e-3)
    assert bool(torch.isfinite(want).all()), name
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol, msg=name)


@pytest.mark.parametrize("n_lights", [1, 2])
def test_shade_segment_kernels_match_plain(cuda, n_lights):
    args, cots = _segment_inputs(cuda, n_lights)
    before = dict(LAUNCHES)
    fwd = sg.segment_fwd(*args)
    assert LAUNCHES["seg_fwd"] == before["seg_fwd"] + 1
    for name, a, b in zip(("add", "o2", "d2", "w2"), fwd,
                          sg.segment_plain(*args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
    bwd = sg.segment_bwd(*args, *cots)
    assert LAUNCHES["seg_bwd"] == before["seg_bwd"] + 1
    names = ("g_o", "g_d", "g_w", "g_rows", "g_light_pos", "g_light_color",
             "g_ambience", "g_background")
    for name, a, b in zip(names, bwd, sg.segment_bwd_plain(*args, *cots)):
        assert a.shape == b.shape, name
        _close_scaled(a, b, name)


def test_shade_segment_function_on_cuda(cuda):
    """ShadeSegment launches K5 and K6 and sums the row cotangents into
    tri_pack like the plain versions."""
    args, cots = _segment_inputs(cuda, 2, seed=8)
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) if i in (0, 1, 2, 3, 5, 6, 7, 8)
                  else a for i, a in enumerate(args)]
        out = sg.ShadeSegment.apply(*leaves, plain)
        loss = sum((o * c).sum() for o, c in zip(out, cots))
        diff = [leaves[i] for i in (0, 1, 2, 3, 5, 6, 7, 8)]
        grads.append(torch.autograd.grad(loss, diff))
    for name, a, b in zip(("o", "d", "w", "tri_pack", "light_pos",
                           "light_color", "ambience", "background"), *grads):
        _close_scaled(a, b, name)


def test_shade_segment_wrappers_reject_bad_inputs(cuda):
    args, cots = _segment_inputs(cuda, 1, seed=9, R=600)
    bad_idx = list(args)
    bad_idx[4] = args[4].long()
    with pytest.raises(ValueError, match="tri_idx"):
        sg.segment_fwd(*bad_idx)
    bad_mask = list(args)
    bad_mask[9] = args[9].int()
    with pytest.raises(ValueError, match="is_t"):
        sg.segment_bwd(*bad_mask, *cots)
    bad_lit = list(args)
    bad_lit[12] = args[12][:, :-1].contiguous()
    with pytest.raises(ValueError, match="lit"):
        sg.segment_fwd(*bad_lit)
    with pytest.raises(ValueError, match="g_w2"):
        sg.segment_bwd(*args, *cots[:3], cots[3].cpu())
