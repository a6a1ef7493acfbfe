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
rays, t within rtol 5e-5 where the ids agree (the reference's bars; on
the edge batches plus 2^-22 of the solve's rounding scale, where origins
near a triangle's plane make its numerator cancel). The
shade-segment backward (K6) sums its light and env cotangents, and each
triangle's row cotangents into the tri_pack cotangent, with atomics in a
run-dependent order: cotangents within 3e-5 * max|plain| (the
reference's bar for its hand-derived VJP), the tri_pack cotangent within
5e-4 * max|plain| (its bar for gradients summed over many rays). The BVH
walk (K7, built without contraction) equals its plain version: ids and t
to the bit.
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
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.ops.render import (primary_rays_blocked, render,
                                               render_aa)
from myraytracer_tpu_torch.scenes import kinds
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
            cc.pack_cluster_rows(data), order, lb, n, data.cl_first,
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


@pytest.mark.parametrize("case", kinds.EDGE_CASES)
def test_edge_batches_kernels_match_plain(cuda, case):
    """K2, K1 and K1' on the cluster scan's edge batches: zero direction
    components, origins on box faces and inside boxes, finite t0,
    inactive subgroups, clusters of one and of M triangles."""
    data = kinds.cluster_edge_scene().build(device=cuda)
    o, d, t_max, active = (
        None if x is None else torch.from_numpy(x).to(cuda)
        for x in kinds.cluster_edge_rays(
            case, data.cl_bbmin.cpu().numpy(), data.cl_bbmax.cpu().numpy(),
            data.cl_count.cpu().numpy()))
    o4, d4, t0p, act = cc.pad_rays(o, d, t_max, active)
    bb = cc.cluster_boxes(data)
    got = cc.phase1_exact(o4, d4, t0p, act, bb)
    want = cc.phase1_exact_plain(o4, d4, t0p, act, bb)
    assert torch.equal(got < INF, want < INF)
    fin = want < INF
    assert bool(fin.any())
    print(f"{case}: phase1_exact max abs err "
          f"{float((got[fin] - want[fin]).abs().max())}")
    torch.testing.assert_close(got[fin], want[fin], rtol=RTOL, atol=ATOL)
    t_any = (torch.rand(o.shape[0], device=cuda) * 40 + 0.5
             if t_max is None else t_max)
    for any_hit in (False, True):
        args = _scan_inputs(data, o, d, t_any if any_hit else t_max, active,
                            any_hit)
        tk, ik = cc.cluster_scan(*args)
        tp, ip = cc.cluster_scan_plain(*args)
        if any_hit:
            assert float(((ik >= 0) == (ip >= 0)).float().mean()) >= 0.995
        else:
            assert float((ik == ip).float().mean()) >= 0.995
            same = (ik == ip) & (ik >= 0)
            assert bool(same.any())
            # the edge batches' t bar: near a triangle's plane (origins
            # inside boxes) o.N - N.p2 cancels, and the kernel contracts
            # it into FMAs
            n_bad, frac = kinds.edge_t_misses(
                args[5], data.cl_first, o4[same], d4[same], ik[same],
                tk[same], tp[same])
            assert n_bad == 0 and frac >= 0.99, (n_bad, frac)


def test_cluster_rows_round_trip_to_constants(cuda):
    """The scan's triangle-major table is the reference layout transposed,
    and a cluster's real triangles are the first count rows of its block."""
    data, _ = _random_scene(6, 700, cuda)
    rows = cc.pack_cluster_rows(data)
    const = cc.pack_cluster_constants(data)
    K, M = data.cl_first.shape[0], data.cl_M
    assert rows.shape == (K, M, 16) and rows.is_contiguous()
    assert rows.data_ptr() % 16 == 0
    assert torch.equal(rows.transpose(1, 2), const)
    assert torch.equal(rows.transpose(1, 2).contiguous().transpose(1, 2),
                       rows)
    flat = rows.reshape(K * M, 16)
    tri = cc.pack_cluster_rows(data, trv.pack_tri_vertices(data))
    assert torch.equal(tri, rows)
    for k in (0, K // 2, K - 1):
        f, c = int(data.cl_first[k]), int(data.cl_count[k])
        # cluster k's first c rows are triangles f .. f + c - 1, the rows
        # the kernel copies (c * 64 bytes from k * M * 64)
        assert torch.equal(flat[k * M:k * M + c], rows[k, :c])
        if k + 1 < K and c < M:
            assert torch.equal(rows[k, c], rows[k + 1, 0])


def test_shading_kernels_match_plain(cuda):
    s = scene_08_office(tess=2, resolution=(96, 64))
    data = s.build(device=cuda)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    R = o.shape[0]
    hit = cc.intersect_clusters(data, o, d, cl_rows=pack.cl_rows)
    live = (torch.rand(R, device=cuda) > 0.1).to(torch.int32)
    valid = (hit.idx >= 0) & (live > 0)
    kind = torch.where(valid, shade.KIND_TRI, shade.KIND_MISS).to(torch.int32)
    tri_idx = torch.where(valid, hit.idx.clamp(min=0),
                          torch.zeros_like(hit.idx)).contiguous()
    aidx = torch.zeros_like(tri_idx)
    _check_shading(data, pack, o, d, hit.t, kind, live, tri_idx, aidx, cuda)


def _check_shading(data, pack, o, d, t, kind, live, tri_idx, aidx, dev):
    """K3 and K4 vs their plain versions on one segment's inputs."""
    R = o.shape[0]
    g = pack.geom
    pre_args = (o, d, t.contiguous(), kind, live, tri_idx, aidx, g.tri_pack,
                g.ana16, g.mat16, data.light_pos, data.texels.shape[0])
    before = LAUNCHES["shade_pre"]
    pre, pre_p = cs.shade_pre(*pre_args), cs.shade_pre_plain(*pre_args)
    assert LAUNCHES["shade_pre"] == before + 1
    for a, b in zip(pre, pre_p):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)

    mat16 = g.mat16.clone()
    mat16[:, 10] = 0.3          # mirrors: exercise the bounce outputs
    L = data.n_lights
    shadow = (torch.rand((L, R), device=dev) < 0.3).to(torch.int32)
    weight = torch.rand(R, device=dev)
    valid = (kind != shade.KIND_MISS).to(torch.int32)
    ph_args = (o, d, weight, valid, live, pre[2], pre[3], pre[0], pre[1],
               shadow, mat16, data.texels, data.light_pos, data.light_color,
               pack.env)
    for a, b in zip(cs.shade_phong(*ph_args), cs.shade_phong_plain(*ph_args)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    return pre


@pytest.mark.parametrize("name", ["mixed", "mixed_nocyl_mirror", "triless",
                                  "textured"])
def test_analytic_and_texture_shading_match_plain(cuda, name):
    """K3's sphere, plane, cylinder and texture branches and K4's texel
    override, on real hits of the scenes that reach them."""
    if name == "textured":
        s = kinds.textured_scene(w=96, h=64)
    else:
        s = kinds.mixed_scene(mirror=0.35 if "mirror" in name else 0.0,
                              cyl="nocyl" not in name, tris=name != "triless",
                              w=96, h=64)
    data = s.build(device=cuda)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    R = o.shape[0]
    live = torch.rand(R, device=cuda) > 0.1
    kind, pidx, aidx, t = tr.closest_hit(data, pack, o, d, live)
    valid = kind != shade.KIND_MISS
    zero = torch.zeros_like(pidx)
    tri_idx = torch.where(kind == shade.KIND_TRI, pidx, zero).contiguous()
    pre = _check_shading(data, pack, o, d, t, kind, live.to(torch.int32),
                         tri_idx, torch.where(valid, aidx, zero).contiguous(),
                         cuda)
    kinds_hit = set(kind[valid].unique().tolist())
    if name == "textured":
        assert bool((pre[3] >= 0).any())
    else:
        assert {shade.KIND_SPHERE, shade.KIND_PLANE} <= kinds_hit
        assert (shade.KIND_CYL in kinds_hit) == ("nocyl" not in name)


@pytest.mark.parametrize("name", ["mixed", "textured"])
def test_render_aa_kernels_match_plain(cuda, name):
    s = (kinds.textured_scene(w=160, h=90) if name == "textured"
         else kinds.mixed_scene(mirror=0.3, w=160, h=90))
    data = s.build(device=cuda)
    before = dict(LAUNCHES)
    got = render_aa(data, s.camera, budget_frac=0.3)
    for k in ("phase1_exact", "cluster_scan_closest", "cluster_scan_anyhit",
              "shade_pre", "shade_phong"):
        assert LAUNCHES[k] > before[k], k
    want = render_aa(data, s.camera, budget_frac=0.3,
                     cfg=tr.TraceConfig(plain=True))
    diff = (got - want).abs().amax(dim=-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.995
    assert bool(torch.isfinite(got).all())


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
    args = list(_scan_inputs(data, o, d))
    with pytest.raises(ValueError, match="cl_rows"):
        cc.cluster_scan(*args[:5], cc.pack_cluster_constants(data),
                        *args[6:])
    with pytest.raises(ValueError, match="sub"):
        cc.phase1_exact(o4, d4, t0, act, cc.cluster_boxes(data), sub=500)


def test_shading_wrappers_reject_bad_tables(cuda):
    s = kinds.textured_scene(w=32, h=32)
    data = s.build(device=cuda)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    R = o.shape[0]
    i0 = torch.zeros(R, dtype=torch.int32, device=cuda)
    t = torch.ones(R, device=cuda)
    g = pack.geom
    with pytest.raises(ValueError, match=r"ana16 must be \[N, 16\]"):
        cs.shade_pre(o, d, t, i0, i0, i0, i0, g.tri_pack,
                     g.ana16[:, :8].contiguous(), g.mat16, data.light_pos,
                     data.texels.shape[0])
    with pytest.raises(ValueError, match=r"texels must be \[N, 3\]"):
        cs.shade_phong(o, d, t, i0, i0, i0, i0 - 1, o, o,
                       i0.reshape(1, R), g.mat16, data.texels.reshape(-1),
                       data.light_pos, data.light_color, pack.env)


def _segment_inputs(dev, n_lights, seed=7, R=5000, tri=None):
    """Rays that really hit their recorded triangle (random barycentrics;
    the triangle of each ray from ``tri`` [R] when given), plus misses,
    dead rays, degenerate triangles and unlit rays."""
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
    if tri is not None:
        ti = np.asarray(tri)
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
    tol = rel * max(float(want.abs().max()) if want.numel() else 0.0, 1e-3)
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
    _check_segment_bwd(args, cots)


#: K6's outputs, and the bar of each against the plain version
SEG_BWD = (("g_o", 3e-5), ("g_d", 3e-5), ("g_w", 3e-5), ("g_pack", 5e-4),
           ("g_light_pos", 3e-5), ("g_light_color", 3e-5),
           ("g_ambience", 3e-5), ("g_background", 3e-5))


def _check_segment_bwd(args, cots):
    """K6 against its plain version; returns the kernel's g_pack."""
    before = LAUNCHES["seg_bwd"]
    bwd = sg.segment_bwd(*args, *cots)
    assert LAUNCHES["seg_bwd"] == before + 1
    for (name, rel), a, b in zip(SEG_BWD, bwd,
                                 sg.segment_bwd_plain(*args, *cots)):
        assert a.shape == b.shape, name
        _close_scaled(a, b, name, rel)
    return bwd[3]


@pytest.mark.parametrize("case", ["one_triangle", "own_triangle", "ragged"])
def test_shade_segment_row_sum_hand_cases(cuda, case):
    """K6's warp row sum: every ray on one triangle (one group of 32 a
    warp), every lane of a warp on its own triangle (32 groups of one),
    and R not a multiple of 32 (the last warp's tail lanes add
    nothing)."""
    R = {"one_triangle": 4096, "own_triangle": 4096, "ragged": 1000}[case]
    # triangles 0-19 of _segment_inputs are degenerate; 400 in all
    tri = {"one_triangle": np.full(R, 25),
           "own_triangle": np.arange(R) % 380 + 20, "ragged": None}[case]
    args, cots = _segment_inputs(cuda, 2, seed=11, R=R, tri=tri)
    g_pack = _check_segment_bwd(args, cots)
    rows_hit = (g_pack.abs().sum(1) > 0).nonzero()[:, 0]
    if case == "one_triangle":
        assert rows_hit.tolist() == [25]
    else:
        assert rows_hit.numel() > 1


def test_shade_segment_kernels_match_plain_on_office(cuda):
    """K6 on the office frame's first segment, with the topology the
    trace records: many rays of a warp share a triangle."""
    s = scene_08_office(tess=3, resolution=(160, 96))
    data = s.build(device=cuda)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    topo = tr.trace_topology(data, o, d, pack=pack)
    R = o.shape[0]
    ti = torch.clamp(topo.idx[0], 0, data.n_tris - 1).to(torch.int32)
    args = (o, d, torch.ones(R, device=cuda), pack.geom.tri_pack,
            ti.contiguous(), data.light_pos, data.light_color, data.ambience,
            data.background, (topo.kind[0] == shade.KIND_TRI).contiguous(),
            topo.hit[0].contiguous(), topo.miss[0].contiguous(),
            (~topo.shadow[0]).float().contiguous())
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    cots = [torch.randn(sh, generator=gen, device=cuda)
            for sh in ((R, 3), (R, 3), (R, 3), (R,))]
    # no cotangent on a hit whose re-solve fails: its point lies at
    # t = INF, and its exact reverse overflows (chip_smoke phase 7 holds
    # those entries equal in both)
    far = sg.segment_plain(*args)[1].abs().amax(1) > 1e30
    for c in cots:
        c[far] = 0.0
    g_pack = _check_segment_bwd(args, cots)
    assert int((g_pack.abs().sum(1) > 0).sum()) > 100


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


def _walk_queries(data, o, d, dev):
    """(name, kwargs) of the walk's queries: closest, any-hit with t_max
    just below the closest t and an active mask, both on [R, 3] rays."""
    closest = trv.traverse_bvh_plain(data, o, d)
    t_max = torch.where(closest.idx >= 0, closest.t * 0.999,
                        torch.full_like(closest.t, 1e30))
    t_max[::3] = 25.0
    active = torch.rand(o.shape[0], device=dev) > 0.2
    return [("closest", {}), ("active", dict(active=active)),
            ("anyhit", dict(t_max=t_max, any_hit=True, active=active))]


def _check_walk(data, o, d, dev, name, kw):
    counter = "bvh_walk_anyhit" if kw.get("any_hit") else "bvh_walk_closest"
    before = LAUNCHES[counter]
    got = trv.traverse_bvh(data, o, d, **kw)
    assert LAUNCHES[counter] == before + 1, name
    want = trv.traverse_bvh_plain(data, o, d, **kw)
    assert torch.equal(got.idx, want.idx), name
    assert torch.equal(got.t, want.t), name
    return got


def test_bvh_walk_kernel_matches_plain(cuda):
    data, rng = _random_scene(4, 900, cuda)
    o, d = _rays(rng, 5003, cuda)                 # not a multiple of 128
    d[:7, 1] = -0.0                               # 1/d = -inf
    # a warp whose rays mix finite, -0, +0 and infinite directions and a
    # non-finite origin: those rays take the NaN-safe slab test, the
    # others the FMNMX one
    d[32:40, 0] = -0.0
    d[40:44, 2] = 0.0
    d[44:48, 1] = float("inf")
    d[48:50, 0] = -float("inf")
    o[50, 1] = float("inf")
    o[51, 2] = float("nan")
    hits = {}
    for name, kw in _walk_queries(data, o, d, cuda):
        hits[name] = _check_walk(data, o, d, cuda, name, kw)
    assert float((hits["closest"].idx >= 0).float().mean()) > 0.1
    # the shadow batch's [R, 4] rows take the same path
    o4, d4 = (torch.nn.functional.pad(x, (0, 1)) for x in (o, d))
    got = trv.traverse_bvh(data, o4, d4)
    assert torch.equal(got.idx, hits["closest"].idx)


def test_bvh_walk_kernel_matches_plain_on_office(cuda):
    """Primary rays and the shadow batch K3 emits for their hits."""
    s = scene_08_office(tess=3, resolution=(160, 90))
    data = s.build(device=cuda)
    pack = tr.pack_trace(data, tr.TraceConfig(tri_method="bvh"))
    o, d = primary_rays_blocked(s.camera, cuda)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    hit = _check_walk(data, o, d, cuda, "primary", dict(tri_flat=pack.tri_flat))
    kind, pidx, aidx, t = tr.closest_hit(data, pack, o, d, live,
                                         tr.TraceConfig(tri_method="bvh"))
    assert torch.equal(torch.where(kind == shade.KIND_TRI, pidx, -1),
                       hit.idx)
    # the cluster scan numbers the triangles the same way
    cl = cc.intersect_clusters(data, o, d)
    assert float((cl.idx == hit.idx).float().mean()) >= 0.995
    g = pack.geom
    pre = cs.shade_pre(o, d, t.contiguous(), kind, live.to(torch.int32),
                       torch.where(kind == shade.KIND_TRI, pidx,
                                   0).contiguous(),
                       torch.zeros_like(pidx), g.tri_pack, g.ana16, g.mat16,
                       data.light_pos, data.texels.shape[0])
    so, sd, st, sact = pre[4:]
    occ = _check_walk(data, so, sd, cuda, "shadow",
                      dict(t_max=st, any_hit=True, active=sact > 0,
                           tri_flat=pack.tri_flat))
    assert bool((occ.idx >= 0).any())


@pytest.mark.parametrize("entry", ["render", "render_aa", "loss_grad"])
def test_bvh_path_launches_the_walk_and_matches_cluster(cuda, entry):
    s = kinds.mixed_scene(mirror=0.3, w=160, h=90)
    data = s.build(device=cuda)
    cfg = tr.TraceConfig(tri_method="bvh")

    def run(c):
        if entry == "render":
            return render(data, s.camera, cfg=c)
        if entry == "render_aa":
            return render_aa(data, s.camera, budget_frac=0.3, cfg=c)
        from myraytracer_tpu_torch.ops.render import render_loss_grad_image
        target = torch.full((s.camera.height, s.camera.width, 3), 0.3,
                            device=cuda)
        return render_loss_grad_image(data, s.camera, target, cfg=c)

    before = dict(LAUNCHES)
    got = run(cfg)
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert launched["bvh_walk_closest"] > 0 and launched["bvh_walk_anyhit"] > 0
    for k in ("phase1_exact", "cluster_scan_closest", "cluster_scan_anyhit"):
        assert launched[k] == 0, k
    want = run(tr.TraceConfig())
    if entry == "loss_grad":
        (loss, grads), (loss_c, grads_c) = got, want
        torch.testing.assert_close(loss, loss_c, rtol=1e-5, atol=0)
        for k in grads:
            _close_scaled(grads[k], grads_c[k], k, rel=5e-4)
    else:
        diff = (got - want).abs().amax(dim=-1)
        assert float((diff <= 1e-4).float().mean()) >= 0.995


def test_bvh_walk_block_matches_its_plain_order(cuda):
    """compact_active orders the any-hit rays by K7's block size."""
    from myraytracer_tpu_torch.kernels import library
    assert library().mrt_bvh_walk_threads() == trv.WALK_BLOCK


def test_bvh_walk_wrapper_rejects_bad_inputs(cuda):
    data, rng = _random_scene(5, 60, cuda)
    o, d = _rays(rng, 300, cuda)
    R = o.shape[0]
    t0 = torch.full((R,), INF, device=cuda)
    act = torch.ones(R, dtype=torch.int32, device=cuda)
    nodes, links = data.bvh_nodes_packed, data.bvh_links_packed
    tri = trv.pack_tri_vertices(data).contiguous()
    with pytest.raises(ValueError, match="act"):
        trv.bvh_walk(o, d, t0, act.bool(), nodes, links, tri, False)
    with pytest.raises(ValueError, match="links"):
        trv.bvh_walk(o, d, t0, act, nodes, links[:-2].contiguous(), tri,
                     False)
    with pytest.raises(ValueError, match="tri_flat"):
        trv.bvh_walk(o, d, t0, act, nodes, links, tri[:, :9].contiguous(),
                     False)
    with pytest.raises(ValueError, match="nodes"):
        trv.bvh_walk(o, d, t0, act, nodes.cpu(), links, tri, False)
