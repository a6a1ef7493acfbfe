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
walk (K7) and the dense analytic tests (K8), both built without
contraction, equal their plain versions: ids and t to the bit. The fused
segment on sphere and plane hits (K10/K11), built without contraction:
per-ray outputs at the shading bar (the same expressions in the same
order); K11's table and environment sums, taken in a fixed order of its
own (no atomics), within 5e-4 and 3e-5 * max|plain| of the plain
version's index_add_ and sum() (their order differs), and equal to the
bit from run to run. The pack's material row sum (K12), which sums in
the plain version's order with no atomics: equal to it to the bit.
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.kernels import LAUNCHES, build
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import cuda_analytic as ca
from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import row_sum as rs
from myraytracer_tpu_torch.ops import shade, tracer as tr
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops import shade_grad_ana as sga
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.ops.render import (primary_rays_blocked, render,
                                               render_aa,
                                               render_loss_grad_image)
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)
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


def _unclamped_loss_grads(data, cam, cfg, target, params=None):
    """The SSE of render(clamp=False) against ``target`` under autograd:
    (loss, gradients of split_params, the image); ``params`` the leaves
    (copies of the scene's by default)."""
    if params is None:
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in split_params(data).items()}
    img = render(merge_params(data, params), cam, cfg=cfg, clamp=False)
    loss = torch.sum((img - target) ** 2)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None else g
                           for k, g in zip(params, got)}, img.detach()


@pytest.mark.parametrize("name", ["office", "textured_bilinear"])
def test_unclamped_render_grads_through_kernels_match_plain(cuda, name):
    """render(clamp=False) under autograd: the topology kernels (and on
    office K5 forward, K6 backward) against the plain versions: the loss
    within rtol 1e-5, every gradient within 5e-4 * max|plain|, the image
    at the render bar; the call is its key's eager warm-up (a later call
    replays graphs) and captures nothing."""
    if name == "office":
        s, cfg = scene_08_office(tess=10, resolution=(480, 270)), (
            tr.TraceConfig())
    else:
        s, cfg = kinds.textured_scene(w=160, h=90), tr.TraceConfig(
            texture_filter="bilinear")
    data = s.build(device=cuda)
    target = 0.9 * render(data, s.camera) + 0.02
    graphs.clear()
    before = dict(LAUNCHES)
    loss, grads, img = _unclamped_loss_grads(data, s.camera, cfg, target)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    fwd = ("phase1_exact", "cluster_scan_closest", "cluster_scan_anyhit",
           "shade_pre", "shade_phong")
    for k in fwd + (("seg_fwd", "seg_bwd") if name == "office" else ()):
        assert launched[k] > 0, k
    assert graphs.cache_size() == 1 and graphs.captured() == 0
    with graphs.disable_graphs():
        loss_p, grads_p, img_p = _unclamped_loss_grads(
            data, s.camera, cfg._replace(plain=True), target)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    for k in grads:
        _close_scaled(grads[k], grads_p[k], k, rel=5e-4)
    if name != "office":
        for k in ("texels", "uv_u", "uv_v"):
            assert float(grads[k].abs().max()) > 0, k
    diff = (img - img_p).abs().amax(dim=-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.995


def test_graphed_unclamped_render_grads_equal_eager(cuda):
    """render(clamp=False) under autograd on office at 256x256: its third
    call replays the forward graph and, at the loss's backward, the
    backward graph, with the launches of the eager call, the image equal
    to eager's bit for bit, the loss within rtol 1e-6 and every gradient
    within 5e-4 * max|eager| (K6 sums with atomics)."""
    graphs.clear()
    data, cam = _graph_office(cuda, 256, 256)
    cfg = tr.TraceConfig()
    target = 0.9 * render(data, cam, cfg) + 0.02
    # one set of leaves for every call: their addresses are in the key
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in split_params(data).items()}
    fn = (lambda: _unclamped_loss_grads(data, cam, cfg, target, params))
    (loss_e, grads_e, img_e), l_eager = _eager(fn)
    (loss, grads, img), l_graph, moved = _three_calls(fn)
    assert moved["replays"] == 1 and moved["backward_replays"] == 1
    assert moved["warm_ups"] == moved["captures"] == 0
    assert moved["pending_eager"] == 0
    assert l_graph == l_eager
    assert torch.equal(img, img_e)
    np.testing.assert_allclose(float(loss), float(loss_e), rtol=1e-6)
    for k in grads_e:
        _close_scaled(grads[k], grads_e[k], k, rel=5e-4)
    graphs.clear()


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


# --- K7's list walk: the bounce segments' queries (traverse_bvh listed) ---

#: ptxas's registers of K7 (closest, any hit), which the list walk, a
#: runtime branch of the same kernel, must leave as they were
K7_REGISTERS = (48, 47)


def _walk_kernels():
    from myraytracer_tpu_torch.kernels import _build
    _, log = _build.build()
    return {k: v for k, v in _build.kernel_resources(log).items()
            if "bvh_walk_kernel" in k or "walk_list_kernel" in k}


def test_bvh_walk_registers_and_no_spills(cuda):
    res = _walk_kernels()
    for any_hit, want in enumerate(K7_REGISTERS):
        (k,) = [k for k in res if f"bvh_walk_kernelILb{any_hit}E" in k]
        assert res[k]["registers"] == want, (k, res[k])
    for k, r in res.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, (k, r)


@pytest.mark.parametrize("density", [0.0, 0.004, 0.3, 1.0])
def test_walk_list_kernel_matches_plain(cuda, density):
    """The live ids (in call order within each block of 1024 rays, the
    blocks in any order), their number, the dead rays' misses and the
    counters (nothing where nothing is listed) as the plain version gives
    them; twice in a row, so the workspace's place and ticket start
    again from 0."""
    R = 300_001
    gen = torch.Generator(device=cuda).manual_seed(11)
    active = torch.rand(R, device=cuda, generator=gen) < density
    ids, t_p, idx_p = trv.walk_list_plain(active)
    n = ids.numel()
    for _ in range(2):
        counts = torch.zeros(2, dtype=torch.int64, device=cuda)
        before = LAUNCHES["bvh_walk_list"]
        lst, n_list, t, idx = trv.walk_list(active, counts)
        assert LAUNCHES["bvh_walk_list"] == before + 1
        assert int(n_list) == n
        got = lst[:n].long()
        assert torch.equal(torch.sort(got).values, ids)
        blk = got // 1024
        new_blk = blk[1:] != blk[:-1]
        assert int(new_blk.sum()) == max(blk.unique().numel() - 1, 0)
        assert bool(((got[1:] > got[:-1]) | new_blk).all())
        dead = ~active
        assert torch.equal(t[dead], t_p[dead])
        assert torch.equal(idx[dead], idx_p[dead])
        assert counts.tolist() == ([n, R] if n else [0, 0])
        assert trv.list_workspace(cuda).tolist() == [0, 0]


def test_walk_list_launches_on_two_streams_are_ordered(cuda):
    """The list launches of a device share its workspace (the places
    taken, the blocks done; traverse.list_workspace), so two launches on
    two streams must not overlap: with the second stream waiting on an
    event of the first, each lists its own live rays and the workspace is
    left zero."""
    R = 200_003
    gen = torch.Generator(device=cuda).manual_seed(13)
    masks = [torch.rand(R, device=cuda, generator=gen) < p
             for p in (0.3, 0.7)]
    trv.walk_list(masks[0])                  # the workspace, made eagerly
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    done = torch.cuda.Event()
    outs = []
    for k, (st, mask) in enumerate(zip(streams, masks)):
        st.wait_stream(torch.cuda.current_stream())
        if k:
            st.wait_event(done)
        with torch.cuda.stream(st):
            outs.append(trv.walk_list(mask))
            if not k:
                done.record(st)
    torch.cuda.synchronize()
    for mask, (lst, n_list, _, _) in zip(masks, outs):
        ids = trv.walk_list_plain(mask)[0]
        assert int(n_list) == ids.numel()
        got = torch.sort(lst[:ids.numel()].long()).values
        assert torch.equal(got, ids)
    assert trv.list_workspace(cuda).tolist() == [0, 0]


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_list_matches_the_launch_over_every_ray(cuda, any_hit):
    """The list launch equals K7 over the whole batch and the plain walk
    to the bit, on masks from none to every ray live, with more live rays
    than the card's resident lanes (a lane then walks several)."""
    data, rng = _random_scene(6, 900, cuda)
    R = 400_003
    o, d = _rays(rng, R, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    t_max = (torch.rand(R, device=cuda, generator=gen) * 30.0
             if any_hit else None)
    walk = "bvh_walk_anyhit" if any_hit else "bvh_walk_closest"
    for density in (0.0, 0.004, 0.3, 1.0):
        active = torch.rand(R, device=cuda, generator=gen) < density
        kw = dict(t_max=t_max, any_hit=any_hit, active=active)
        before = dict(LAUNCHES)
        got = trv.traverse_bvh(data, o, d, listed=True, **kw)
        assert LAUNCHES["bvh_walk_list"] == before["bvh_walk_list"] + 1
        assert LAUNCHES[walk] == before[walk] + 1
        want = trv.traverse_bvh(data, o, d, **kw)
        assert torch.equal(got.idx, want.idx), density
        assert torch.equal(got.t, want.t), density
        if density == 0.3:
            plain = trv.traverse_bvh_plain(data, o, d, **kw)
            assert torch.equal(got.idx, plain.idx)
            assert torch.equal(got.t, plain.t)
            assert bool((got.idx >= 0).any())


def test_bvh_walk_list_in_a_captured_graph_under_an_if_node(cuda):
    """A listed query in an IF node's body: each replay that runs the
    body equals the eager query to the bit and adds its rays to the
    region's counters; a skipped body leaves the buffers and counters
    alone; the tally counts one listed query a replay."""
    graphs.clear()
    data, rng = _random_scene(8, 900, cuda)
    R = 50_000
    o, d = _rays(rng, R, cuda)
    active = torch.rand(R, device=cuda) < 0.3
    gate = torch.ones(1, device=cuda)
    tri = trv.pack_tri_vertices(data).contiguous()
    t_out = torch.zeros(R, device=cuda)
    i_out = torch.zeros(R, dtype=torch.int32, device=cuda)
    held = [o, d, active, gate, t_out, i_out]

    def region():
        pred = (gate > 0).any()

        def body():
            hit = trv.traverse_bvh(data, o, d, active=active, tri_flat=tri,
                                   listed=True)
            t_out.copy_(hit.t)
            i_out.copy_(hit.idx)
        if graphs.capturing(cuda):
            graphs.if_node(pred, body, "the listed query")
        elif bool(pred):                    # the eager warm-up
            body()
        return t_out * 1.0

    want = trv.traverse_bvh(data, o, d, active=active, tri_flat=tri)
    n = int(active.sum())
    for _ in range(3):                      # warm-up, capture, replay
        got = graphs.run("listed", region, cuda, held=held)
    torch.cuda.synchronize()
    assert torch.equal(got, want.t) and torch.equal(i_out, want.idx)
    assert graphs.tallies("listed") == {"walk.list": 1}
    assert graphs.count_bodies() == (1, 0)
    assert trv.listed_rays("listed") == (3 * n, 3 * R)
    gate.zero_()
    t_out.fill_(-1.0)
    got = graphs.run("listed", region, cuda, held=held)
    assert bool((got == -1.0).all()) and graphs.count_bodies() == (0, 1)
    assert trv.listed_rays("listed") == (3 * n, 3 * R)
    gate.fill_(1.0)
    active[: R // 2] = False
    want = trv.traverse_bvh(data, o, d, active=active, tri_flat=tri)
    got = graphs.run("listed", region, cuda, held=held)
    assert torch.equal(got, want.t) and torch.equal(i_out, want.idx)
    assert trv.listed_rays("listed") == (3 * n + int(active.sum()), 4 * R)
    graphs.clear()


def test_rings_bounce_walks_are_listed_graphed_and_eager(cuda):
    """The rings (PHONG mirror tori, 4 segments) at 140 x 100 through
    render_aa: graphed equals eager to the bit; each replay tallies 12
    listed queries (segments 1 to 3, closest and shadow, both passes) and
    counts the rays the plain versions list; office lists none."""
    from myraytracer_tpu_torch.scenes.golden import scene_09_rings

    s = scene_09_rings(scale=0.2)
    data = s.build(device=cuda)
    cfg = tr.TraceConfig(tri_method="auto")
    fn = lambda c: render_aa(data, s.camera, c, budget_frac=0.05)  # noqa: E731
    graphs.clear()
    with graphs.disable_graphs():
        plain = fn(cfg._replace(plain=True))
    want_rays = [trv.listed_rays(e) for e in ("render", "aa_refine")]
    graphs.clear()
    with graphs.disable_graphs():
        eager = fn(cfg)
    assert [trv.listed_rays(e) for e in ("render", "aa_refine")] == want_rays
    assert 0 < want_rays[0][0] < want_rays[0][1]
    graphs.clear()
    before = graphs.TALLIES["walk.list"]
    for _ in range(3):
        got = fn(cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    assert graphs.tallies("render")["walk.list"] == 6
    assert graphs.tallies("aa_refine")["walk.list"] == 6
    assert graphs.TALLIES["walk.list"] - before == 3 * 12
    assert [trv.listed_rays(e) for e in ("render", "aa_refine")] == [
        (3 * a, 3 * b) for a, b in want_rays]
    diff = (eager - plain).abs().amax(dim=-1)
    assert float((diff <= 1e-4).float().mean()) >= 0.995
    o = scene_08_office(tess=3, resolution=(160, 90))
    graphs.clear()
    before = graphs.TALLIES["walk.list"]
    with graphs.disable_graphs():
        render_aa(o.build(device=cuda), o.camera, cfg, budget_frac=0.05)
    assert graphs.TALLIES["walk.list"] == before
    graphs.clear()


# --- K8, the dense analytic tests (csrc/analytic.cu) -----------------------

def _analytic_scene(dev, spheres=(), planes=(), cylinders=()):
    """A scene of spheres (center, radius), planes (center, normal) and
    cylinders (center, axis, radius, height) alone."""
    s = Scene()
    s.add_light((2, 9, 4), (0.8, 0.8, 0.8))
    for c, r in spheres:
        s.add_sphere(c, r, Material())
    for c, n in planes:
        s.add_plane(c, n, Material())
    for c, a, r, h in cylinders:
        s.add_cylinder(c, a, r, h, Material())
    return s.build(device=dev)


def _bits(t):
    return t.view(torch.int32)


def _check_analytic(data, o, d, seed=0):
    """K8's closest hit against the plain version on rays o, d (kind, idx
    and aidx equal, t to the bit), and its any hit against the plain
    occlusion & cast under seeded random distances (INF and inf among
    them) and cast flags, on [R, 3] rays and on the shadow batch's
    [R, 4] rows; each call one launch. Returns the closest hit."""
    before = LAUNCHES["analytic_closest"]
    got = tr._closest_analytic(data, o, d)
    assert LAUNCHES["analytic_closest"] == before + 1
    want = tr._closest_analytic_plain(data, o, d)
    for name, a, b in zip(("kind", "idx", "aidx"), got[:3], want[:3]):
        assert torch.equal(a, b), name
    assert torch.equal(_bits(got[3]), _bits(want[3])), "t"

    g = torch.Generator().manual_seed(seed)
    R = o.shape[0]
    dist = (torch.rand(R, generator=g) * 30).to(o.device)
    u = torch.rand(R, generator=g).to(o.device)
    dist = torch.where(u < 0.15, INF, dist)
    dist = torch.where((u >= 0.15) & (u < 0.2), float("inf"), dist)
    dist = torch.where((u >= 0.2) & (u < 0.3), want[3], dist)  # t < t: no
    cast = (torch.rand(R, generator=g) > 0.25).to(o.device)
    occ_want = tr._analytic_occlusion_plain(data, o, d, dist) & cast
    o4, d4 = (torch.nn.functional.pad(x, (0, 1)) for x in (o, d))
    for name, oo, dd in (("rows of 3", o, d), ("rows of 4", o4, d4)):
        before = LAUNCHES["analytic_anyhit"]
        occ = tr._analytic_occlusion(data, oo, dd, dist, cast)
        assert LAUNCHES["analytic_anyhit"] == before + 1
        assert torch.equal(occ, occ_want), name
    assert bool(occ_want.any()) and not bool(occ_want.all())
    return got


def test_analytic_kernel_matches_plain_on_the_molecule(cuda):
    """o_04's pass-1 camera rays, their mirror bounce, and the light-major
    shadow batch K3 emits for the camera rays' hits."""
    from myraytracer_tpu_torch.scenes.golden import scene_04_molecule

    s = scene_04_molecule()
    data = s.build(device=cuda)
    assert (data.n_spheres, data.n_planes) == (800, 3)
    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(s.camera, cuda)
    kind = _check_analytic(data, o, d)[0]
    assert {shade.KIND_SPHERE, shade.KIND_PLANE} <= set(kind.unique().tolist())
    R = o.shape[0]
    carry = tr.Bounce(o, d, torch.ones(R, device=cuda),
                      torch.zeros((R, 3), device=cuda))
    nxt, rec = tr.segment_step(data, pack, carry)
    assert bool((nxt.weight > 0).any())
    _check_analytic(data, nxt.o, nxt.d, seed=1)

    live = torch.ones(R, dtype=torch.bool, device=cuda)
    kind, pidx, aidx, t = tr.closest_hit(data, pack, o, d, live)
    valid = kind != shade.KIND_MISS
    zero = torch.zeros_like(pidx)
    g = pack.geom
    so, sd, st, sact = cs.shade_pre(
        o, d, t.contiguous(), kind, live.to(torch.int32), zero,
        torch.where(valid, aidx, zero).contiguous(), g.tri_pack, g.ana16,
        g.mat16, data.light_pos, data.texels.shape[0])[4:]
    cast = sact > 0
    before = LAUNCHES["analytic_anyhit"]
    occ = tr._analytic_occlusion(data, so, sd, st, cast, g.ana16)
    assert LAUNCHES["analytic_anyhit"] == before + 1
    want = cast & tr._analytic_occlusion_plain(data, so[:, :3], sd[:, :3], st)
    assert torch.equal(occ, want)
    assert bool(want.any()) and not bool(want[cast].all())
    # shadow_mask takes the same route
    shadow = tr.shadow_mask(data, pack, so, sd, st, sact)
    assert torch.equal(shadow, want.to(torch.int32))


def _random_analytic(rng, S, P, C):
    """Seeded random spheres, planes (a third with normal +y) and
    cylinders (a third with axis +y)."""
    def unit(n):
        v = rng.normal(size=(n, 3))
        v[: n // 3] = [0.0, 1.0, 0.0]
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    sph = [(tuple(c), float(r)) for c, r in zip(
        rng.uniform(-4, 4, (S, 3)), rng.uniform(0.2, 1.5, S))]
    pla = [(tuple(c), tuple(n)) for c, n in zip(rng.uniform(-5, 5, (P, 3)),
                                                unit(P))]
    cyl = [(tuple(c), tuple(a), float(r), float(h)) for c, a, r, h in zip(
        rng.uniform(-4, 4, (C, 3)), unit(C), rng.uniform(0.2, 1.0, C),
        rng.uniform(0.5, 3.0, C))]
    return sph, pla, cyl


def _random_analytic_rays(rng, R, dev):
    """Random rays, a sixteenth along +-y (parallel to the planes with
    normal +y and to the cylinders with axis +y) and a sixteenth along x."""
    o = rng.uniform(-7, 7, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[: R // 16] = [0.0, 1.0, 0.0]
    d[R // 16: R // 8] = [1.0, 0.0, 0.0]
    d[R // 8: R // 4] *= rng.uniform(0.1, 3.0, (R // 8, 1)).astype(np.float32)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def test_analytic_kernel_matches_plain_on_random_rays(cuda):
    """Random rays against a scene of every kind, over more than one row
    chunk of each (K8 stages 512 spheres or planes, 256 cylinders)."""
    rng = np.random.default_rng(11)
    sph, pla, cyl = _random_analytic(rng, 700, 530, 300)
    data = _analytic_scene(cuda, sph, pla, cyl)
    o, d = _random_analytic_rays(rng, 20003, cuda)
    kind = _check_analytic(data, o, d, seed=2)[0]
    assert set(kind.unique().tolist()) == {
        shade.KIND_SPHERE, shade.KIND_PLANE, shade.KIND_CYL}


@pytest.mark.parametrize("case", ["ties", "inside", "parallel",
                                  "planes_only"])
def test_analytic_kernel_hand_cases(cuda, case):
    """Exact ties (two identical spheres: the lower index; a sphere and a
    plane at the same t: the sphere), origins inside spheres (the t1
    root), rays parallel to a plane and to a cylinder's axis, and a scene
    of planes alone."""
    rng = np.random.default_rng(13)
    o, d = _random_analytic_rays(rng, 4000, cuda)
    if case == "ties":
        data = _analytic_scene(
            cuda, [((0, 0, 0), 1.0), ((0, 0, 0), 1.0), ((3, 0, 0), 1.0)],
            [((0, 1, 0), (0, 1, 0))])
        # straight down onto the spheres' tops, which touch the plane: t = 4
        o[:64] = torch.tensor([0.0, 5.0, 0.0], device=cuda)
        o[64:128] = torch.tensor([3.0, 5.0, 0.0], device=cuda)
        d[:128] = torch.tensor([0.0, -1.0, 0.0], device=cuda)
        kind, idx, _, t = _check_analytic(data, o, d, seed=3)
        assert bool((kind[:128] == shade.KIND_SPHERE).all())
        assert bool((idx[:64] == 0).all()) and bool((idx[64:128] == 2).all())
        assert bool((t[:128] == 4.0).all())
    elif case == "inside":
        sph, _, _ = _random_analytic(rng, 40, 0, 0)
        data = _analytic_scene(cuda, sph, [((0, -6, 0), (0, 1, 0))])
        c = data.sphere_center[torch.arange(4000, device=cuda) % 40]
        o = (c + (torch.rand((4000, 3), device=cuda) - 0.5) * 0.2)
        kind, idx, _, _ = _check_analytic(data, o.contiguous(), d, seed=4)
        assert float((kind == shade.KIND_SPHERE).float().mean()) > 0.9
    elif case == "parallel":
        data = _analytic_scene(
            cuda, [((0, 3, 0), 0.5)], [((0, -1, 0), (0, 1, 0)),
                                       ((0, 0, -6), (0, 0, 1))],
            [((0, 0, 0), (0, 1, 0), 1.0, 2.0), ((3, 0, 0), (1, 0, 0), 0.5,
                                                 1.0)])
        # along y through the first cylinder (its axis), along x in the
        # plane y = -1's direction, along x through the second's axis
        o[:200, 0] = torch.rand(200, device=cuda) * 1.6 - 0.8
        o[200:400, 1] = torch.rand(200, device=cuda) * 4 - 2
        d[:200] = torch.tensor([0.0, 1.0, 0.0], device=cuda)
        d[200:400] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
        _check_analytic(data, o, d, seed=5)
    else:
        _, pla, _ = _random_analytic(rng, 0, 7, 0)
        data = _analytic_scene(cuda, planes=pla)
        kind = _check_analytic(data, o, d, seed=6)[0]
        assert set(kind.unique().tolist()) == {shade.KIND_MISS,
                                               shade.KIND_PLANE}


def test_analytic_kernel_replays_in_a_graph(cuda):
    """Both modes captured in one CUDA graph and replayed on new rays give
    what they give eagerly."""
    rng = np.random.default_rng(17)
    data = _analytic_scene(cuda, *_random_analytic(rng, 90, 4, 9))
    o, d = _random_analytic_rays(rng, 3000, cuda)
    dist = torch.rand(3000, device=cuda) * 20
    cast = torch.rand(3000, device=cuda) > 0.3
    ana16 = shade.pack_ana16(data)
    run = lambda: (*tr._closest_analytic(data, o, d, ana16),  # noqa: E731
                   tr._analytic_occlusion(data, o, d, dist, cast, ana16))
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    o2, d2 = _random_analytic_rays(rng, 3000, cuda)
    o.copy_(o2)
    d.copy_(d2)
    graph.replay()
    torch.cuda.synchronize()
    want = run()
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def test_analytic_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(19)
    data = _analytic_scene(cuda, *_random_analytic(rng, 5, 2, 1))
    o, d = _random_analytic_rays(rng, 256, cuda)
    ana16 = shade.pack_ana16(data)
    counts = (5, 2, 1)
    dist = torch.ones(256, device=cuda)
    with pytest.raises(ValueError, match="ana16"):
        ca.closest_analytic(o, d, ana16[:7].contiguous(), counts)
    with pytest.raises(ValueError, match="ana16"):
        ca.closest_analytic(o, d, ana16[:, :8].contiguous(), counts)
    with pytest.raises(ValueError, match="o "):
        ca.closest_analytic(o[:, :2].contiguous(), d[:, :2].contiguous(),
                            ana16, counts)
    with pytest.raises(ValueError, match="cast"):
        ca.analytic_anyhit(o, d, dist, dist, ana16, counts)
    with pytest.raises(ValueError, match="dist"):
        ca.analytic_anyhit(o, d, dist[:100], None, ana16, counts)


# --- CUDA graphs (ops/graphs.py): graphed entry points against eager ------

def _graph_office(dev, w=256, h=160):
    s = scene_08_office(tess=4, resolution=(w, h))
    return s.build(device=dev), s.camera


def _three_calls(fn):
    """Warm-up, capture, replay: the third call's result, its launches and
    the graph calls it made."""
    fn()
    fn()
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    before = dict(graphs.COUNTS)
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in LAUNCHES.items() if v},
            {k: graphs.COUNTS[k] - before[k] for k in before})


def _eager(fn):
    with graphs.disable_graphs():
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        out = fn()
        torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


@pytest.mark.parametrize("method", ["cluster", "auto"])
@pytest.mark.parametrize("entry", ["render", "render_aa", "loss_grad", "fit"])
def test_graphed_entry_points_equal_eager(cuda, method, entry):
    """The third call replays a captured graph, launches what the eager
    call launches and agrees with it: images bit-equal, the loss within
    rtol 1e-6 and gradients within 5e-4 x max|eager| (K6 sums with
    atomics in a run-dependent order), fit losses within rtol 1e-5."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    graphs.clear()
    data, cam = _graph_office(cuda)
    cfg = tr.TraceConfig(tri_method=method)
    tgt = 0.9 * render(data, cam, cfg) + 0.02
    if entry == "fit":
        xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

        def fit():
            inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                                  optimizer=adam(0.02), camera=cam, cfg=cfg)
            return [inv.fit_pixels(xs, ys, tgt.reshape(-1, 3),
                                   steps=1).losses[0] for _ in range(4)]

        want, _ = _eager(fit)
        got = fit()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert graphs.captured() >= 1
        return
    fn = {"render": lambda: render(data, cam, cfg),
          "render_aa": lambda: render_aa(data, cam, cfg, budget_frac=0.05),
          "loss_grad": lambda: render_loss_grad_image(data, cam, tgt, cfg)
          }[entry]
    want, l_eager = _eager(fn)
    nodes = graphs.COUNTS["if_nodes"]
    got, l_graph, moved = _three_calls(fn)
    assert moved["replays"] >= 1 and moved["captures"] == 0
    assert moved["warm_ups"] == 0
    assert l_graph == l_eager
    assert graphs.COUNTS["if_nodes"] == nodes       # one segment: no branch
    if entry == "loss_grad":
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        for k in want[1]:
            _close_scaled(got[1][k], want[1][k], k, rel=5e-4)
    else:
        assert torch.equal(got, want)


def test_graph_launches_are_counted_per_replay(cuda):
    graphs.clear()
    data, cam = _graph_office(cuda)
    _, l_eager = _eager(lambda: render(data, cam))
    render(data, cam)
    render(data, cam)
    torch.cuda.synchronize()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for _ in range(3):
        render(data, cam)
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        k: 3 * v for k, v in l_eager.items()}


def test_graphs_follow_camera_and_in_place_parameters(cuda):
    import dataclasses

    graphs.clear()
    data, cam = _graph_office(cuda)
    for _ in range(3):
        render(data, cam)
    moved = dataclasses.replace(cam, eye=cam.eye + 0.2,
                                fovy=cam.fovy - 5.0)
    before = graphs.COUNTS["captures"]
    got = render(data, moved)
    assert graphs.COUNTS["captures"] == before       # the same graph
    want, _ = _eager(lambda: render(data, moved))
    assert torch.equal(got, want) and not torch.equal(got, render(data, cam))
    data.mat_diffuse.mul_(0.5)
    got = render(data, cam)
    want, _ = _eager(lambda: render(data, cam))
    assert torch.equal(got, want)


def test_graphed_frames_do_not_alias(cuda):
    graphs.clear()
    data, cam = _graph_office(cuda)
    frames = [render(data, cam) for _ in range(4)]
    keep = frames[2].clone()
    assert len({f.data_ptr() for f in frames}) == 4
    frames[3].zero_()
    render(data, cam)
    assert torch.equal(frames[2], keep)


def test_capture_of_a_host_read_raises(cuda):
    """No eager retry: the capture raises, naming the entry point and the
    line that read the host, and so does the next call."""
    graphs.clear()
    x = torch.arange(6.0, device=cuda)

    def bad():
        return x * float(x.sum())

    graphs.run("bad", bad, cuda, held=[x])          # the eager warm-up
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError,
                           match=r"capture of bad failed at .*in bad"):
            graphs.run("bad", bad, cuda, held=[x])
    assert graphs.captured() == 0


def test_uncapturable_optimizer_raises_at_capture(cuda):
    from myraytracer_tpu_torch.inverse import InverseRenderer

    graphs.clear()
    data, cam = _graph_office(cuda, 64, 64)
    inv = InverseRenderer(data, ("mat_diffuse",),
                          optimizer=lambda p: torch.optim.Adam(p, lr=0.01),
                          camera=cam)
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))
    tgt = torch.zeros((xs.numel(), 3), device=cuda)
    inv.fit_pixels(xs, ys, tgt, steps=2)            # two eager warm-ups
    with pytest.raises(graphs.GraphCaptureError, match="disable_graphs"):
        inv.fit_pixels(xs, ys, tgt, steps=1)
    with graphs.disable_graphs():
        assert np.isfinite(inv.fit_pixels(xs, ys, tgt, steps=1).losses).all()


# --- conditional segments: CUDA-graph IF nodes (ops/graphs.if_node) -------

def _dead_scene(dev, w=128, h=96):
    """A convex mirror mesh sphere before the background, max_depth 3:
    every ray is dead after segment 1, so segments 2 and 3 are dead
    (tests/test_torch_graphs.py's dead_scene)."""
    from myraytracer_tpu_torch.scenes.shapes import uv_sphere

    s = Scene()
    s.set_camera(eye=(0, 0.5, 4), center=(0, 0, 0), up=(0, 1, 0), fovy=40,
                 width=w, height=h)
    s.add_light((3, 3, 3), (0.9, 0.85, 0.8))
    s.ambience = (0.1, 0.1, 0.12)
    s.background = (0.05, 0.1, 0.2)
    s.max_depth = 3
    v, f = uv_sphere(1.0, 8, 12)
    s.add_mesh(TriangleMesh(v, f, material=Material(
        ambient=(0.1, 0.1, 0.1), diffuse=(0.5, 0.3, 0.2),
        specular=(0.4, 0.4, 0.4), shininess=20, mirror=0.6), draw_mode=FLAT))
    return s.build(device=dev), s.camera


def _captured_launches():
    """Every launch the captured graphs hold: outside IF nodes and in
    every body."""
    from collections import Counter

    total = Counter()
    for entry in graphs._CACHE.values():
        for g in (entry.forward, entry.backward):
            if g is not None:
                total.update(g.launches)
                for body in g.bodies:
                    total.update(body.launches)
    return dict(total)


@pytest.mark.parametrize("method", ["cluster", "auto"])
@pytest.mark.parametrize("entry", ["render", "render_aa", "loss_grad"])
def test_graphed_dead_segments_skip_and_equal_eager(cuda, method, entry):
    """On the dead scene the capture holds IF nodes; a replay skips the
    dead segments' bodies, so the launches that ran (count_bodies) are
    fewer than those captured, which equal the eager call's (a select
    runs every segment); images bit-equal, the loss within rtol 1e-6,
    gradients within 5e-4 x max|eager|."""
    graphs.clear()
    data, cam = _dead_scene(cuda)
    cfg = tr.TraceConfig(tri_method=method)
    tgt = 0.9 * render(data, cam, cfg) + 0.02
    fn = {"render": lambda: render(data, cam, cfg),
          "render_aa": lambda: render_aa(data, cam, cfg, budget_frac=0.05),
          "loss_grad": lambda: render_loss_grad_image(data, cam, tgt, cfg)
          }[entry]
    want, l_eager = _eager(fn)
    graphs.clear()
    nodes = graphs.COUNTS["if_nodes"]
    fn()
    fn()
    assert graphs.COUNTS["if_nodes"] >= nodes + 2
    assert _captured_launches() == l_eager
    graphs.count_bodies()
    got, l_replay, moved = _three_calls(fn)
    ran, skipped = graphs.count_bodies()
    executed = {k: v for k, v in LAUNCHES.items() if v}
    assert moved["replays"] >= 1 and moved["captures"] == 0
    assert ran >= 1 and skipped >= 2
    assert all(executed.get(k, 0) <= n for k, n in l_eager.items())
    assert sum(executed.values()) < sum(l_eager.values())
    assert sum(l_replay.values()) < sum(executed.values())
    if entry == "loss_grad":
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        for k in want[1]:
            _close_scaled(got[1][k], want[1][k], k, rel=5e-4)
    else:
        assert torch.equal(got, want)


#: the IF nodes of one dead-scene training or fit step: segments 1 to 3
#: of trace_topology, of trace_shade's forward and of its backward
SHADE_SITES = ([f"segment {s} of trace_topology" for s in (1, 2, 3)]
               + [f"segment {s} of trace_shade" for s in (1, 2, 3)]
               + [f"segment {s} of trace_shade (backward)" for s in (3, 2, 1)])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("entry", ["loss_grad", "fit"])
def test_graphed_trace_shade_skips_dead_segments(cuda, fused, entry):
    """The training step and the fit step on the dead scene, through the
    fused K5/K6 segment and the autograd replay: the capture holds nine IF
    nodes (SHADE_SITES); a replay runs segment 1's three bodies and skips
    the six of segments 2 and 3, trace_shade's forward and backward
    among them; graphed equals eager (the loss within rtol 1e-6 and
    gradients within 5e-4 x max|eager|; fit losses within rtol 1e-5)."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    graphs.clear()
    data, cam = _dead_scene(cuda)
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    assert (cfg.replay_route(data) != "autograd") == fused
    tgt = 0.9 * render(data, cam, cfg) + 0.02
    nodes = graphs.COUNTS["if_nodes"]
    if entry == "loss_grad":
        fn = lambda: render_loss_grad_image(data, cam, tgt, cfg)  # noqa: E731
        want, _ = _eager(fn)
        got, _, moved = _three_calls(fn)
        assert moved["replays"] == 1 and moved["captures"] == 0
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        for k in want[1]:
            assert bool(torch.isfinite(got[1][k]).all()), k
            _close_scaled(got[1][k], want[1][k], k, rel=5e-4)
    else:
        xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

        def fit():
            inv = InverseRenderer(data, ("mat_diffuse", "mat_mirror",
                                         "light_color"),
                                  optimizer=adam(0.02), camera=cam, cfg=cfg)
            return [inv.fit_pixels(xs, ys, tgt.reshape(-1, 3),
                                   steps=1).losses[0] for _ in range(4)]

        want, _ = _eager(fit)
        got = fit()                     # warm-ups, a capture, a replay
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert graphs.COUNTS["if_nodes"] - nodes == len(SHADE_SITES)
    sites = graphs.body_sites()
    assert sites == [(site, " 1 " in site) for site in SHADE_SITES]
    assert graphs.count_bodies() == (3, 6)


def test_if_node_skips_and_runs_by_the_condition(cuda):
    """One region, one IF node: a replay runs the body where the
    condition holds and leaves its buffer alone where it does not; the
    body's allocations come from the graph's pool."""
    graphs.clear()
    w = torch.ones(1000, device=cuda)
    out = torch.zeros(1000, device=cuda)

    def region():
        pred = (w > 0).any()

        def body():
            tmp = torch.zeros((1000, 3), device=cuda)
            tmp[:, 1] = 2.0
            v, _ = torch.sort(w * 3.0 + tmp.sum(1))
            out.copy_(torch.cumsum(v, 0))
        if graphs.capturing(cuda):
            graphs.if_node(pred, body, "the test's body")
        elif bool(pred):                    # the eager warm-up
            body()
        return out * 1.0

    for _ in range(3):
        graphs.run("cond", region, cuda, held=[w, out])
    want = torch.cumsum(torch.full((1000,), 5.0, device=cuda), 0)
    got = graphs.run("cond", region, cuda, held=[w, out])
    assert torch.equal(got, want) and graphs.count_bodies() == (1, 0)
    w.zero_()
    out.fill_(-1.0)
    got = graphs.run("cond", region, cuda, held=[w, out])
    assert (got == -1.0).all() and graphs.count_bodies() == (0, 1)
    w.fill_(1.0)
    assert torch.equal(graphs.run("cond", region, cuda, held=[w, out]), want)


# --- tracing: host spans, device phase marks, graph nodes (utils/profiling) --

def _profiled(fn):
    """(host span names, device phases of the marks in order, device
    event names) of ``fn()`` and a synchronise under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from myraytracer_tpu_torch.utils.profiling import phase_of

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    host = [e.name for e in events if e.device_type != cuda_type]
    dev = sorted((e for e in events if e.device_type == cuda_type
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    return (host, [phase_of(e.name) for e in dev if phase_of(e.name)],
            [e.name for e in dev])


def test_mark_library_holds_every_phase(cuda):
    from myraytracer_tpu_torch.kernels import library
    from myraytracer_tpu_torch.utils import profiling

    assert library().mrt_mark_phases() == len(profiling.PHASES)
    before = dict(LAUNCHES)
    _, phases, _ = _profiled(lambda: [profiling.mark(p, cuda)
                                      for p in profiling.PHASES])
    assert phases == list(profiling.PHASES)
    assert dict(LAUNCHES) == before


def test_graphed_render_aa_spans_marks_and_nodes(cuda):
    """A replayed render_aa shows the key, stage, launch and clone spans
    of both graphs, no span's device copy among the device's operations,
    each phase's mark once where expected, and the graphs' node counts,
    positive and the same at every replay."""
    graphs.clear()
    data, cam = _graph_office(cuda)
    cfg = tr.TraceConfig(tri_method="auto")

    def frame():
        return render_aa(data, cam, cfg, budget_frac=0.05)

    frame()
    frame()
    nodes = {e: graphs.nodes(e) for e in ("render", "aa_refine")}
    host, phases, dev = _profiled(frame)
    # segment 0's triangle queries mark ``tri``, a later segment's
    # ``tri.bounce`` (office has one segment)
    seg = (["segment", "tri", "shade", "tri", "shade"]
           + ["segment", "tri.bounce", "shade", "tri.bounce", "shade"]
           * (data.n_segments - 1))
    assert phases == (["rays"] + seg + ["end", "aa.select"] + seg
                      + ["aa.apply", "end"])
    for entry in ("render", "aa_refine"):
        for what in ("key", "stage", "launch", "clone"):
            assert host.count(f"mrt.graphs.{what} {entry}") >= 1, (what,
                                                                    entry)
        assert host.count(f"mrt.graphs.launch {entry}") == 1
        assert f"mrt.graphs.capture {entry}" not in host
    assert {"mrt.render_aa", "mrt.render", "mrt.aa_refine"} <= set(host)
    assert not [n for n in dev if n.startswith("mrt.")]
    assert all(v > len(seg) for v in nodes.values()), nodes
    frame()
    assert {e: graphs.nodes(e) for e in nodes} == nodes


@pytest.mark.parametrize("entry", ["render", "fit"])
def test_skipped_bodies_leave_no_segment_marks(cuda, entry):
    """On the dead scene (segments 2 and 3 dead), a replay marks the
    segments whose IF-node bodies ran, and the graph's node count holds
    every body."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    graphs.clear()
    data, cam = _dead_scene(cuda)
    if entry == "render":
        fn = lambda: render(data, cam)              # noqa: E731
    else:
        xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))
        tgt = torch.full((xs.numel(), 3), 0.3, device=cuda)
        inv = InverseRenderer(data, ("mat_diffuse",), optimizer=adam(0.02),
                              camera=cam)
        fn = lambda: inv.fit_pixels(xs, ys, tgt, steps=1)  # noqa: E731
    for _ in range(3):
        fn()
    with graphs.disable_graphs():
        _, eager, _ = _profiled(fn)
    replays = graphs.COUNTS["replays"]
    _, replay, dev = _profiled(fn)
    assert graphs.COUNTS["replays"] == replays + 1
    assert data.n_segments == 4
    # eagerly every segment runs; a replay runs segments 0 and 1 of each
    # trace (render: one trace; fit: its topology and its shading replay)
    traces = 1 if entry == "render" else 2
    assert eager.count("segment") == 4 * traces
    assert replay.count("segment") == 2 * traces, (replay, len(dev))
    # the triangle queries (closest and shadow) of the one traversing
    # trace: segment 0's marked ``tri``, the later ones' ``tri.bounce``
    assert eager.count("tri") == replay.count("tri") == 2
    assert eager.count("tri.bounce") == 2 * 3
    assert replay.count("tri.bounce") == 2, replay
    label = "render" if entry == "render" else "fit_step"
    g = next(e.forward for e in graphs._CACHE.values()
             if e.forward is not None and e.name == label)
    assert g.bodies and all(b.nodes > 0 for b in g.bodies)
    assert graphs.nodes(label) == g.nodes + sum(b.nodes for b in g.bodies)


# --- the sharded entry points over NCCL at world size 1 (parallel/) ---------

@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL ray mesh in this process; the graphs that hold its
    communicator are dropped before the group is destroyed."""
    import torch.distributed as dist

    from myraytracer_tpu_torch.parallel.mesh import make_mesh

    graphs.clear()
    mesh = make_mesh(1, "cuda")
    assert dist.get_backend(mesh.get_group()) == "nccl"
    yield mesh
    graphs.clear()
    dist.destroy_process_group()


def _step_params_close(got, want, grads, n_total, lr, rel=5e-4):
    """The SGD step's parameters within lr / n_total x rel x max|g| plus
    one ulp: the gradient bar carried through p - lr g / n_total."""
    from myraytracer_tpu_torch.parallel.shard_render import split_params

    a_p, b_p = split_params(got), split_params(want)
    for k, b in b_p.items():
        if b.numel():
            bar = lr / n_total * rel * max(float(grads[k].abs().max()), 1e-30)
            ulp = (torch.nextafter(b, torch.full_like(b, np.inf)) - b).abs()
            excess = float(((a_p[k] - b).abs() - ulp).clamp(min=0).max())
            assert excess <= bar, (k, excess, bar)


@pytest.mark.parametrize("entry", ["render", "render_aa", "step", "fit"])
def test_sharded_graphed_equals_eager_over_nccl(nccl_mesh, entry):
    """World size 1 over NCCL: from the third call each sharded entry
    point replays a captured graph, launches what its eager call launches
    and agrees with it (images bit-equal, and equal to the single
    device's; the step's loss within rtol 1e-6 and its parameters within
    the gradient bar 5e-4 x max|g| carried through the update; the fit's
    losses within rtol 1e-5, its third step a capture)."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.parallel import dryrun
    from myraytracer_tpu_torch.parallel import shard_render as sr

    mesh = nccl_mesh
    dev = torch.device("cuda", 0)
    data, cam = _graph_office(dev)
    tgt = 0.9 * render(data, cam) + 0.02
    if entry == "fit":
        xs, ys = (g.reshape(-1) for g in cam.pixel_grid(dev))

        def fit():
            inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                                  optimizer=adam(0.02), camera=cam,
                                  mesh=mesh)
            return [inv.fit_pixels(xs, ys, tgt.reshape(-1, 3),
                                   steps=1).losses[0] for _ in range(4)]

        want, _ = _eager(fit)
        before = dict(graphs.COUNTS)
        got = fit()
        moved = {k: graphs.COUNTS[k] - before[k] for k in before}
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert (moved["warm_ups"], moved["captures"], moved["replays"]) == (
            2, 1, 2)
        return
    batch = dryrun.step_batch(cam, tgt, mesh)
    step = sr.make_train_step(mesh, lr=0.5)
    fn = {"render": lambda: sr.render_sharded(data, cam, mesh),
          "render_aa": lambda: sr.render_aa_sharded(data, cam, mesh,
                                                    budget_frac=0.05),
          "step": lambda: step(data, *batch)}[entry]
    want, l_eager = _eager(fn)
    got, l_graph, moved = _three_calls(fn)
    assert moved["replays"] >= 1 and moved["captures"] == 0
    assert moved["warm_ups"] == 0 and l_graph == l_eager
    if entry == "step":
        with graphs.disable_graphs():
            _, grads, n_total = sr.loss_grad_sharded(data, *batch, mesh)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
        _step_params_close(got[0], want[0], grads, float(n_total), 0.5)
        return
    assert torch.equal(got, want)
    single = (render(data, cam) if entry == "render"
              else render_aa(data, cam, budget_frac=0.05))
    assert torch.equal(got, single)


def test_collective_inside_an_if_node_fails_the_capture(nccl_mesh):
    """The one all-reduce refuses to be recorded in an IF node's body (a
    rank that skipped the body would hang the others): the capture
    raises, naming the body."""
    from myraytracer_tpu_torch.parallel.mesh import all_reduce

    dev = torch.device("cuda", 0)
    t = torch.ones(8, device=dev)

    def region():
        out = t * 2.0
        if graphs.capturing(dev):
            graphs.if_node((out > 0).any(), lambda: all_reduce(out, nccl_mesh),
                           "a body with a collective")
        return out

    group = nccl_mesh.get_group()
    graphs.run("guarded", region, dev, held=[t], group=group)
    with pytest.raises(graphs.GraphCaptureError,
                       match="a collective inside an IF node's body"):
        graphs.run("guarded", region, dev, held=[t], group=group)


def _segment_counts(entry: str, n: int) -> tuple:
    return ([tr.live_rays(entry, s) for s in range(n)],
            tr.segments_run(entry), tr.rays_run(entry))


def test_segment_counters_graphed_and_eager_equal_plain(cuda, monkeypatch):
    """K3's segment counters on o_03's pass 1 (21 segments, rays alive to
    the last): the kernels run eagerly and three graphed calls (the
    warm-up, the capture's replay, a replay) count what the plain versions
    count, call for call; the counters add no graph node."""
    from myraytracer_tpu_torch.scenes.golden import scene_03_mirror

    s = scene_03_mirror(scale=0.5)
    data = s.build(device=cuda)
    cfg = tr.TraceConfig(tri_method="auto")
    S = data.n_segments
    assert S == 21
    graphs.clear()
    with graphs.disable_graphs():
        render(data, s.camera, cfg._replace(plain=True))
    want = _segment_counts("render", S)
    graphs.clear()
    with graphs.disable_graphs():
        render(data, s.camera, cfg)
    assert _segment_counts("render", S) == want
    graphs.clear()
    for _ in range(3):
        render(data, s.camera, cfg)
    live, ran, rays = _segment_counts("render", S)
    assert live == [3 * n for n in want[0]]
    assert (ran, rays) == (3 * want[1], 3 * want[2])
    assert want[1] == S and 0 < want[0][-1] < want[0][0]
    assert graphs.nodes("render") > 0
    nodes = graphs.nodes("render")
    graphs.clear()
    pre = cs.shade_pre
    monkeypatch.setattr(cs, "shade_pre",
                        lambda *a, counts=None, cond=None: pre(*a))
    for _ in range(2):
        render(data, s.camera, cfg)
    assert graphs.nodes("render") == nodes
    graphs.clear()


# --- K10/K11: the fused shade segment on sphere and plane hits -------------

def _ana_segment_inputs(dev, name, s=0, seed=0):
    """(plain arguments, counts, seeded output cotangents) of segment s of
    o_04 at 200x200 (the molecule's 800 atoms) or of a random
    sphere-and-plane scene, with the recorded topology."""
    from myraytracer_tpu_torch.scenes.golden import scene_04_molecule

    if name == "o04":
        sc = scene_04_molecule(scale=0.4)
    else:
        rng = np.random.default_rng(seed)
        sc = Scene()
        sc.set_camera(eye=(0, 1.0, 6.0), center=(0, 0, 0), up=(0, 1, 0),
                      fovy=50, width=160, height=96)
        for _ in range(3):
            sc.add_light(tuple(rng.uniform(-4, 4, 3) + (0, 4, 2)),
                         tuple(rng.uniform(0.2, 0.9, 3)))
        sc.max_depth = 2
        for i in range(300):
            sc.add_sphere(tuple(rng.uniform(-3, 3, 3) * (1, 0.5, 1)),
                          float(rng.uniform(0.05, 0.3)), Material(
                              diffuse=tuple(rng.uniform(0.1, 0.9, 3)),
                              specular=(0.4,) * 3,
                              shininess=float(rng.uniform(2, 60)),
                              mirror=float(rng.choice([0.0, 0.4]))))
        sc.add_plane((0, -1.5, 0), (0, 1, 0), Material(mirror=0.3))
    data = sc.build(device=dev)
    o, d = primary_rays_blocked(sc.camera, dev)
    with graphs.disable_graphs():
        topo = tr.trace_topology(data, o, d)
    geom = shade.pack_shade_geom(data)
    R = o.shape[0]
    counts = (data.n_spheres, data.n_planes)
    carry = (o, d, torch.ones(R, device=dev))
    for k in range(s + 1):
        args = (*carry, geom.ana16, geom.mat16, *(
            getattr(topo, f)[k].contiguous()
            for f in ("kind", "idx", "hit", "miss", "shadow")),
            data.light_pos, data.light_color, data.ambience, data.background)
        carry = sga.segment_ana_plain(*args, counts)[1:]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cots = [torch.randn(sh, generator=gen, device=dev)
            for sh in ((R, 3), (R, 3), (R, 3), (R,))]
    return args, counts, cots


#: K11's outputs and the bar of each against the plain version
ANA_BWD = dict(o=3e-5, d=3e-5, w=3e-5, ana16=5e-4, mat16=5e-4,
               light_pos=3e-5, light_color=3e-5, ambience=3e-5,
               background=3e-5)


@pytest.mark.parametrize("name,s", [("o04", 0), ("o04", 1), ("random", 0),
                                    ("random", 1)])
def test_ana_segment_kernels_match_plain(cuda, name, s):
    """K10 and K11 against their plain versions (each launched once), and
    K11 with only some cotangents asked for: those equal to the bit to a
    full run's, None for the rest."""
    args, counts, cots = _ana_segment_inputs(cuda, name, s, seed=3 + s)
    before = dict(LAUNCHES)
    fwd = sga.segment_ana_fwd(*args, counts)
    assert LAUNCHES["seg_ana_fwd"] == before["seg_ana_fwd"] + 1
    for nm, a, b in zip(("add", "o2", "d2", "w2"), fwd,
                        sga.segment_ana_plain(*args, counts)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=nm)
    bwd = sga.segment_ana_bwd(*args, counts, *cots)
    assert LAUNCHES["seg_ana_bwd"] == before["seg_ana_bwd"] + 1
    want = sga.segment_ana_bwd_plain(*args, counts, *cots)
    for (nm, rel), a, b in zip(ANA_BWD.items(), bwd, want):
        _close_scaled(a, b, nm, rel)
    assert bwd[4][:, :sga.MAT_COLS].abs().max() > 0
    for need in ((False, False, True, False, True, True, True, True, True),
                 (True, True, False, True, False, False, False, False,
                  False)):
        part = sga.segment_ana_bwd(*args, counts, *cots, need=need)
        for a, b, n in zip(part, bwd, need):
            assert (a is None) if not n else torch.equal(a, b)
    # cotangents left out are zero
    none = sga.segment_ana_bwd(*args, counts, None, None, None, None)
    assert all(not g.any() for g in none)


def test_ana_segment_bwd_runs_equal_to_the_bit(cuda):
    """K11 sums every table and environment cotangent in a fixed order:
    five runs on the same inputs give the same bits."""
    args, counts, cots = _ana_segment_inputs(cuda, "o04", 0, seed=7)
    first = sga.segment_ana_bwd(*args, counts, *cots)
    for _ in range(4):
        again = sga.segment_ana_bwd(*args, counts, *cots)
        for nm, a, b in zip(sga.BWD_OUTPUTS, again, first):
            assert torch.equal(a, b), nm


def test_ana_segment_function_on_cuda(cuda):
    """ShadeSegmentAna launches K10 and K11 and gives the plain versions'
    gradients (ANA_BWD's bars)."""
    args, counts, cots = _ana_segment_inputs(cuda, "random", 1, seed=5)
    pos = (0, 1, 2, 3, 4, 10, 11, 12, 13)
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) if i in pos else a
                  for i, a in enumerate(args)]
        out = sga.ShadeSegmentAna.apply(*leaves, counts, plain)
        loss = sum((x * c).sum() for x, c in zip(out, cots))
        grads.append(torch.autograd.grad(loss, [leaves[i] for i in pos]))
    for (nm, rel), a, b in zip(ANA_BWD.items(), *grads):
        _close_scaled(a, b, nm, rel)


@pytest.mark.parametrize("entry", ["loss_grad", "fit"])
def test_ana_segment_graphed_under_if_nodes_equals_eager(cuda, entry):
    """o_04 (three segments, the third dead) through the K10/K11 route,
    graphed: the capture holds its IF nodes (the topology's, the replay's
    forward and backward, for segments 1 and 2), a replay skips segment
    2's three bodies and launches K10 and K11 twice (segments 0 and 1) and
    K5/K6 never, and the loss and gradients (fit: the losses and the
    fitted leaves) equal the eager run's to the bit."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.scenes.golden import scene_04_molecule

    graphs.clear()
    sc = scene_04_molecule(scale=0.3)
    data, cam = sc.build(device=cuda), sc.camera
    cfg = tr.TraceConfig()
    assert cfg.replay_route(data) == "fused_ana" and data.n_segments == 3
    tgt = 0.9 * render(data, cam, cfg) + 0.02
    nodes = graphs.COUNTS["if_nodes"]
    if entry == "loss_grad":
        def fn():
            return render_loss_grad_image(data, cam, tgt, cfg)
    else:
        xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

        def fn():
            inv = InverseRenderer(data, ("mat_diffuse", "light_color",
                                         "sphere_center"),
                                  optimizer=adam(0.02), camera=cam, cfg=cfg)
            losses = [inv.fit_pixels(xs, ys, tgt.reshape(-1, 3),
                                     steps=1).losses[0] for _ in range(4)]
            return losses, {k: v.detach().clone()
                            for k, v in inv.params.items()}
    want, l_eager = _eager(fn)
    if entry == "loss_grad":
        fn()                            # the warm-up
        fn()                            # the capture and its replay
        torch.cuda.synchronize()
        graphs.count_bodies()
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        before = dict(graphs.COUNTS)
        got = fn()
    else:
        got = fn()                      # warm-ups, a capture, a replay
        before = None
    ran, skipped = graphs.count_bodies()
    assert graphs.COUNTS["if_nodes"] - nodes == 6
    assert (ran, skipped) == (3, 3)
    if entry == "loss_grad":
        launched = {k: v for k, v in LAUNCHES.items() if v}
        assert graphs.COUNTS["replays"] - before["replays"] == 1
        assert launched["seg_ana_fwd"] == 2 and launched["seg_ana_bwd"] == 2
        assert "seg_fwd" not in launched and "seg_bwd" not in launched
        assert l_eager["seg_ana_fwd"] == 3 and l_eager["seg_ana_bwd"] == 3
        assert torch.equal(got[0], want[0])
    else:
        assert got[0] == want[0]
        # the fit step's graph counts its three segments by route
        assert graphs.tallies("fit_step") == {"replay.fused_ana": 3}
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


def test_ana_segment_wrappers_reject_bad_inputs(cuda):
    args, counts, cots = _ana_segment_inputs(cuda, "o04", 0, seed=9)
    bad = list(args)
    bad[5] = args[5].long()
    with pytest.raises(ValueError, match="kind"):
        sga.segment_ana_fwd(*bad, counts)
    bad = list(args)
    bad[9] = args[9].float()
    with pytest.raises(ValueError, match="shadow"):
        sga.segment_ana_bwd(*bad, counts, *cots)
    bad = list(args)
    bad[4] = args[4][:, :12].contiguous()
    with pytest.raises(ValueError, match="mat16"):
        sga.segment_ana_fwd(*bad, counts)
    with pytest.raises(ValueError, match="g_w2"):
        sga.segment_ana_bwd(*args, counts, *cots[:3], cots[3].cpu())
    with pytest.raises(ValueError, match="rows"):
        sga.segment_ana_fwd(*args, (counts[0] + 1, counts[1]))


# --- K12: the pack's material row sum (ops/row_sum.py) ---------------------

def _rowsum_inputs(dev, case, seed):
    """(g [T, 16], a column slice of a seeded [T, 48] cotangent as K6
    leaves it; ids [T] i32; M): office's triangles and materials, or a
    ragged batch with an empty material, or one row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if case == "office":
        data = scene_08_office(tess=10, resolution=(64, 36)).build(device=dev)
        ids, M = data.tri_mat, data.mat_diffuse.shape[0]
    else:
        T, M = {"ragged": (3001, 5), "one": (1, 1)}[case]
        ids = torch.randint(0, M, (T,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[ids == 3] = 4
    g = torch.randn((ids.shape[0], 48), generator=gen, device=dev)[:, 32:]
    return g, ids, M


@pytest.mark.parametrize("case", ["office", "ragged", "one"])
def test_pack_rowsum_kernel_equals_plain_to_the_bit(cuda, case):
    """K12 equals its plain version to the bit (run on the card and on
    the CPU), twice, and lies within float rounding of index_add_."""
    g, ids, M = _rowsum_inputs(cuda, case, seed=23)
    before = LAUNCHES["pack_rowsum"]
    got = rs.row_sum(g, ids, M)
    torch.cuda.synchronize()
    assert LAUNCHES["pack_rowsum"] == before + 1
    assert torch.equal(got, rs.row_sum_plain(g, ids, M))
    assert torch.equal(got.cpu(), rs.row_sum_plain(g.cpu(), ids.cpu(), M))
    assert torch.equal(rs.row_sum(g, ids, M), got)
    assert torch.equal(rs.row_sum(g.contiguous(), ids, M), got)
    want = torch.zeros((M, 16), device=cuda).index_add_(0, ids.long(), g)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    if case == "ragged":
        assert not bool(got[3].any())


def test_pack_rowsum_kernel_replays_in_a_graph(cuda):
    """K12 captured in a CUDA graph gives the eager call's bits, replay
    after replay."""
    g, ids, M = _rowsum_inputs(cuda, "office", seed=29)
    want = rs.row_sum(g, ids, M)
    out = torch.empty_like(want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(rs.row_sum(g, ids, M))
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_graphed_office_fit_step_takes_the_row_sum(cuda):
    """The office fit step (mat_diffuse and light_color, K5/K6) replayed
    from its graph takes K12 once a step (tally ``pack.rowsum``, the
    launch) and PyTorch's gather backward never; its losses equal the
    eager run's within rtol 1e-5 and its leaves within 5e-4 x max|eager|
    (K6 sums its cotangents with atomics in a run-dependent order)."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    graphs.clear()
    data, cam = _graph_office(cuda)
    cfg = tr.TraceConfig()
    tgt = 0.9 * render(data, cam, cfg) + 0.02
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

    def fn():
        inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                              optimizer=adam(0.02), camera=cam, cfg=cfg)
        losses = [inv.fit_pixels(xs, ys, tgt.reshape(-1, 3),
                                 steps=1).losses[0] for _ in range(4)]
        return losses, {k: v.detach().clone() for k, v in inv.params.items()}

    want, l_eager = _eager(fn)
    assert l_eager["pack_rowsum"] == 4 and l_eager["seg_bwd"] == 4
    got = fn()                          # warm-ups, a capture, a replay
    assert graphs.tallies("fit_step") == {"replay.fused_tri": 1,
                                          "pack.rowsum": 1}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("rowsum_part_kernel" in n for n in names)
    assert not any("indexing_backward" in n for n in names)
    for run in (got, again):
        np.testing.assert_allclose(run[0], want[0], rtol=1e-5)
        for k in want[1]:
            _close_scaled(run[1][k], want[1][k], k, rel=5e-4)


# --- the autograd replay on a mixed scene (o_07) ---------------------------

def test_graphed_toon_fit_step_equals_eager(cuda):
    """o_07 at a quarter of its size (150 x 75: 19,680 PHONG triangles over a
    mirror plane, two lights) through ``fit_pixels`` on the autograd
    route (``fused_shade_grad=False``; the ``toon-600x300.fit`` cell's
    settings otherwise): four steps of one
    renderer (a warm-up, a capture and its replay, two replays) against
    four under ``disable_graphs()``. The capture holds the 9 IF nodes of
    segments 1 to 3 (the topology's, the replay's forward and backward);
    a replay runs segment 1's three bodies (the floor's reflections) and
    skips the six of segments 2 and 3 (the heads are no mirrors); the
    graph counts 4 autograd segments and the topology's 6 listed bounce
    walks a step, and its backward runs the row gathers'
    ``indexing_backward_kernel``. The losses, each step's
    gradient (as Adam's ``exp_avg`` holds it) and the fitted leaves equal
    the eager run's to the bit: the gathers' backward sums in a fixed
    order, and both runs launch the same kernels."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.scenes.golden import scene_07_toon_faces

    graphs.clear()
    sc = scene_07_toon_faces(scale=0.25)
    data, cam = sc.build(device=cuda), sc.camera
    cfg = tr.TraceConfig(tri_method="auto", texture_filter="bilinear",
                         fused_shade_grad=False)
    assert cfg.replay_route(data) == "autograd"
    assert data.n_tris == 19680 and data.n_lights == 2
    assert data.n_segments == 4
    tgt = (0.9 * render(data, cam, cfg) + 0.02).reshape(-1, 3)
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

    def fn():
        inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                              optimizer=adam(0.05), camera=cam, cfg=cfg)
        losses, moments = [], []
        for _ in range(4):
            losses += inv.fit_pixels(xs, ys, tgt, steps=1).losses
            moments.append({k: inv.optimizer.state[p]["exp_avg"].clone()
                            for k, p in inv.params.items()})
        return losses, moments, {k: v.detach().clone()
                                 for k, v in inv.params.items()}

    want, _ = _eager(fn)
    nodes = graphs.COUNTS["if_nodes"]
    got = fn()                          # a warm-up, a capture, replays
    assert graphs.COUNTS["if_nodes"] - nodes == 9
    assert graphs.count_bodies() == (3, 6)
    assert graphs.tallies("fit_step") == {"replay.autograd": 4,
                                          "walk.list": 6}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    assert any("indexing_backward" in e.name for e in prof.events())
    assert got[0] == want[0], (got[0], want[0])
    for s, (a, b) in enumerate(zip(got[1], want[1])):
        for k in b:
            assert torch.equal(a[k], b[k]), (s, k, float(
                (a[k] - b[k]).abs().max()), float(b[k].abs().max()))
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k


# --- K5/K6 beside K10/K11 on a mixed scene (o_07, "fused_mixed") ----------

def _toon(dev):
    """o_07 at a quarter of its size (150 x 75) and its camera."""
    from myraytracer_tpu_torch.scenes.golden import scene_07_toon_faces

    sc = scene_07_toon_faces(scale=0.25)
    return sc.build(device=dev), sc.camera


#: the mixed segment's differentiable inputs, and the bar of each
#: gradient against the plain version's (K6's and K11's)
MIXED_BWD = dict(o=3e-5, d=3e-5, weight=3e-5, tri_pack=5e-4, ana16=5e-4,
                 mat16=5e-4, light_pos=3e-5, light_color=3e-5,
                 ambience=3e-5, background=3e-5)


@pytest.mark.parametrize("s", [0, 1])
def test_mixed_segment_kernels_match_plain_on_toon(cuda, s):
    """Segment s of the ``"fused_mixed"`` route on o_07 at 150 x 75 (K5/K6
    on the heads' hits, K10/K11 on the mirror plane's and on the misses),
    with the recorded topology: one launch of each kernel each way, the
    outputs within RTOL/ATOL of the plain versions', and every input's
    gradient under seeded cotangents within MIXED_BWD's bars."""
    import dataclasses

    data, cam = _toon(cuda)
    assert tr.TraceConfig().replay_route(data) == "fused_mixed"
    o, d = primary_rays_blocked(cam, cuda)
    R = o.shape[0]
    with graphs.disable_graphs():
        topo = tr.trace_topology(data, o, d)
    geom = tr._mixed_geom(data, shade.pack_shade_geom(data), tr.TraceConfig())
    recs = [tuple(getattr(topo, f)[k] for f in ("kind", "idx", "hit", "miss",
                                                 "shadow")) for k in range(2)]
    carry = tr.Bounce(o, d, torch.ones(R, device=cuda), torch.zeros_like(o))
    for k in range(s):
        carry = tr._fused_mixed_segment(data, geom, carry, recs[k],
                                        tr.TraceConfig(plain=True))
    # segment 0 hits the heads and the plane; segment 1, the plane's
    # reflections, hits the heads and misses
    hit_kinds = set(recs[s][0][recs[s][2]].unique().tolist())
    assert hit_kinds == ({shade.KIND_TRI} if s else {shade.KIND_TRI,
                                                     shade.KIND_PLANE})
    assert bool(recs[s][3].any())
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13 + s)
    cots = [torch.randn(x.shape, generator=gen, device=cuda) for x in carry]
    outs, grads = [], []
    for plain in (False, True):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in (
            *zip(("o", "d", "weight"), carry[:3]),
            *((r, getattr(geom, r)) for r in ("tri_pack", "ana16", "mat16")),
            *((f, getattr(data, f)) for f in ("light_pos", "light_color",
                                              "ambience", "background")))}
        scene = dataclasses.replace(data, **{f: leaves[f] for f in (
            "light_pos", "light_color", "ambience", "background")})
        g = geom._replace(**{r: leaves[r] for r in ("tri_pack", "ana16",
                                                    "mat16")})
        before = dict(LAUNCHES)
        out = tr._fused_mixed_segment(
            scene, g, tr.Bounce(leaves["o"], leaves["d"], leaves["weight"],
                                carry.color), recs[s],
            tr.TraceConfig(plain=plain))
        got = torch.autograd.grad(sum((y * c).sum() for y, c in zip(
            out, cots)), list(leaves.values()))
        torch.cuda.synchronize()
        moved = {k: LAUNCHES[k] - before[k] for k in (
            "seg_fwd", "seg_bwd", "seg_ana_fwd", "seg_ana_bwd")}
        assert moved == dict.fromkeys(moved, 0 if plain else 1), moved
        outs.append([y.detach() for y in out])
        grads.append(dict(zip(leaves, got)))
    for name, a, b in zip(tr.Bounce._fields, *outs):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
    for name, rel in MIXED_BWD.items():
        _close_scaled(grads[0][name], grads[1][name], name, rel)
    # the heads' material cotangent lies in tri_pack's columns 32:48 (K6),
    # the plane's, which segment 0 alone hits, in mat16 (K11)
    assert float(grads[1]["tri_pack"][:, 32:].abs().max()) > 0
    assert (float(grads[1]["mat16"].abs().max()) > 0) == (s == 0)


def test_graphed_toon_fit_step_on_the_mixed_route(cuda):
    """o_07 at 150 x 75 through ``fit_pixels`` on the ``"fused_mixed"``
    route, as the ``toon-600x300.fit`` cell runs it: four steps of one
    renderer (a warm-up, a capture and its replay, two replays) against
    four under ``disable_graphs()``. The capture holds the 9 IF nodes of
    segments 1 to 3 and a replay runs segment 1's three bodies and skips
    the six of segments 2 and 3, as on the autograd route; the graph
    counts 4 segments in each fused route's tally, one K12 gather and the
    topology's 6 listed walks a step, and launches no
    ``indexing_backward_kernel``. The losses within rtol 1e-5, each
    step's gradient (as Adam's ``exp_avg`` holds it) and the fitted
    leaves within 5e-4 x max|eager| (K6 sums its cotangents with float
    atomics in a run-dependent order)."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    graphs.clear()
    data, cam = _toon(cuda)
    cfg = tr.TraceConfig(tri_method="auto", texture_filter="bilinear")
    assert cfg.replay_route(data) == "fused_mixed"
    tgt = (0.9 * render(data, cam, cfg) + 0.02).reshape(-1, 3)
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid(cuda))

    def fn():
        inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                              optimizer=adam(0.05), camera=cam, cfg=cfg)
        losses, moments = [], []
        for _ in range(4):
            losses += inv.fit_pixels(xs, ys, tgt, steps=1).losses
            moments.append({k: inv.optimizer.state[p]["exp_avg"].clone()
                            for k, p in inv.params.items()})
        return losses, moments, {k: v.detach().clone()
                                 for k, v in inv.params.items()}

    want, l_eager = _eager(fn)
    assert all(l_eager[k] == 16 for k in ("seg_fwd", "seg_bwd",
                                          "seg_ana_fwd", "seg_ana_bwd"))
    nodes = graphs.COUNTS["if_nodes"]
    got = fn()                          # a warm-up, a capture, replays
    assert graphs.COUNTS["if_nodes"] - nodes == 9
    assert graphs.count_bodies() == (3, 6)
    assert graphs.tallies("fit_step") == {
        "replay.fused_tri": 4, "replay.fused_ana": 4, "pack.rowsum": 1,
        "walk.list": 6}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("rowsum_part_kernel" in n for n in names)
    assert not any("indexing_backward" in n for n in names)
    for run in (got, again):
        np.testing.assert_allclose(run[0], want[0], rtol=1e-5)
        for a, b in zip(run[1], want[1]):
            for k in b:
                _close_scaled(a[k], b[k], k, rel=5e-4)
        for k in want[2]:
            _close_scaled(run[2][k], want[2][k], k, rel=5e-4)
