"""The port's cluster scan (K2 phase-1, K1, K1') vs the reference.

The reference runs its Pallas kernels in interpret mode on the CPU, the
port runs the kernels' plain PyTorch versions (the wrappers take them
for CPU tensors). Both get the identical packed scene
(``scenedata_from_arrays``) and identical rays made with NumPy.

Tolerances: the reference itself accepts >= 99.5% id agreement between
two forms of the same solve (tests/test_pallas_cluster.py), because fp
ties can flip; the port is held to the same bar, with t within rtol
5e-5 where the ids agree.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import intersect as risx
from myraytracer_tpu.ops import pallas_cluster as rpc

from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops.intersect import INF, ray_aabb
from myraytracer_tpu_torch.ops.render import primary_rays_blocked
from myraytracer_tpu_torch.scenes import kinds

from test_bvh import _scene_with_tris, random_tris
from test_torch_scene import office, to_port

SUB = cc.SUB

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _rays(rng, R, spread=15.0):
    o = rng.uniform(-spread, spread, size=(R, 3)).astype(np.float32)
    tgt = rng.uniform(-6, 6, size=(R, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _random_case(seed, n_tris, n_rays, spread=8.0):
    rng = np.random.default_rng(seed)
    ref = _scene_with_tris(random_tris(n_tris, rng, spread=spread))
    o, d = _rays(rng, n_rays)
    return ref, o, d


def _office_case():
    ref = office("ref").build()
    o, d = primary_rays_blocked(office("port").camera, "cpu")
    return ref, o.numpy(), d.numpy()


def _cases():
    return {"random": lambda: _random_case(41, 600, 700),
            "office": _office_case}


def _ref_xla_phase1(ref, o, d, t0, act):
    """The reference's phase-1 as it runs on the CPU (the XLA branch of
    intersect_clusters_pallas, pallas_cluster.py:642-659) -> key [S, K]."""
    R = o.shape[0]
    S = -(-R // SUB)
    pad = S * SUB - R
    o_s = jnp.asarray(np.pad(o, ((0, pad), (0, 0)))).reshape(S, SUB, 3)
    iv = np.pad(1.0 / d, ((0, pad), (0, 0)), constant_values=1.0)
    iv_s = jnp.asarray(iv).reshape(S, SUB, 3)
    t0p = jnp.asarray(np.pad(t0, (0, pad))).reshape(S, SUB, 1)
    actp = jnp.asarray(np.pad(act, (0, pad))).reshape(S, SUB, 1)
    box_hit, tmin_k = risx.ray_aabb(o_s[:, :, None, :], iv_s[:, :, None, :],
                                    ref.cl_bbmin[None, None],
                                    ref.cl_bbmax[None, None])
    ray_touch = box_hit & (actp > 0) & (tmin_k <= t0p)
    lb = jnp.min(jnp.where(ray_touch, jnp.maximum(tmin_k, 0.0), risx.INF),
                 axis=1)
    return np.asarray(jnp.where(jnp.any(ray_touch, axis=1), lb, risx.INF))


@pytest.mark.parametrize("case", ["random", "office"])
def test_phase1_exact_plain_matches_reference(case):
    ref, o, d = _cases()[case]()
    port = to_port(ref)
    rng = np.random.default_rng(7)
    R = o.shape[0]
    t0 = np.where(rng.uniform(size=R) < 0.3, rng.uniform(1, 20, R),
                  INF).astype(np.float32)
    act = (rng.uniform(size=R) > 0.1).astype(np.int32)
    want = _ref_xla_phase1(ref, o, d, t0, act)
    o4, d4, t0p, actp = cc.pad_rays(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(t0),
                                    torch.from_numpy(act) > 0)
    got = cc.phase1_exact(o4, d4, t0p, actp, cc.cluster_boxes(port)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got < INF, want < INF)
    fin = want < INF
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def _phase1_work_case(case):
    """(scene, o4, d4, t0, act) for the phase-1 work counts."""
    if case == "office":
        ref, o, d = _office_case()
        port = to_port(ref)
        o4, d4, t0, act = cc.pad_rays(torch.from_numpy(o), torch.from_numpy(d))
        return port, o4, d4, t0, act
    port = to_port(_scene_with_tris(kinds.cluster_edge_tris()))
    o, d, t_max, active = _edge_rays(port, case)
    return port, *cc.pad_rays(
        torch.from_numpy(o), torch.from_numpy(d),
        None if t_max is None else torch.from_numpy(t_max),
        None if active is None else torch.from_numpy(active))


@pytest.mark.parametrize("case", ["office", "axis", "inactive"])
def test_phase1_stats_count_the_work_the_cull_leaves(case):
    """K2's plain version counts the work of the kernel's warps: each warp
    keeps at least the boxes its active rays touch (the cull is exact), a
    camera batch is culled everywhere, warps that straddle an axis too,
    and rays with zero direction components are never culled."""
    port, o4, d4, t0, act = _phase1_work_case(case)
    bb = cc.cluster_boxes(port)
    K = bb.shape[0]
    work = {}
    key = cc.phase1_exact_plain(o4, d4, t0, act, bb, stats=work)
    torch.testing.assert_close(key, cc.phase1_exact_plain(o4, d4, t0, act, bb),
                               rtol=0, atol=0)
    a = act.reshape(-1, 32) > 0
    n_act = a.sum(1)
    hit, tmin = ray_aabb(o4[:, None, :3], 1.0 / d4[:, None, :3],
                         bb[None, :, :3], bb[None, :, 3:])   # [R, K]
    touch = hit & (act[:, None] > 0) & (tmin <= t0[:, None])
    touched = touch.reshape(-1, 32, K).any(1).sum(1)        # boxes a warp needs
    assert work["warps"] == int(a.any(1).sum())
    assert work["bundle_tests"] == work["cull_warps"] * K
    assert int((n_act * touched).sum()) <= work["slabs"] <= int(n_act.sum()) * K
    if case == "office":
        # every warp culls, those on the centre column too
        assert work["cull_warps"] == work["warps"]
        assert 0 < work["mixed_warps"] < work["warps"]
        assert work["slabs"] < 0.5 * int(n_act.sum()) * K
    if case == "axis":
        assert work["cull_warps"] == 0
        assert work["slabs"] == int(n_act.sum()) * K
    if case == "inactive":
        assert work["warps"] < o4.shape[0] // 32


def _hits_agree(got, want):
    gi, wi = got.idx.numpy(), np.asarray(want.idx)
    assert (gi == wi).mean() >= 0.995, (gi == wi).mean()
    both = (wi >= 0) & (gi == wi)
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both],
                               rtol=5e-5)
    np.testing.assert_array_equal(got.t.numpy()[gi < 0], np.float32(INF))


@pytest.mark.parametrize("case", ["random", "office"])
def test_closest_hit_matches_reference(case):
    ref, o, d = _cases()[case]()
    port = to_port(ref)
    want = rpc.intersect_clusters_pallas(ref, jnp.asarray(o), jnp.asarray(d),
                                         interpret=True)
    got = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d))
    assert (got.idx.numpy() >= 0).mean() > 0.2
    _hits_agree(got, want)


def test_closest_hit_active_mask_and_t_max():
    ref, o, d = _random_case(43, 300, 520)
    port = to_port(ref)
    rng = np.random.default_rng(1)
    active = rng.uniform(size=520) > 0.3
    t_max = rng.uniform(2, 25, 520).astype(np.float32)
    want = rpc.intersect_clusters_pallas(
        ref, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max),
        active=jnp.asarray(active), interpret=True)
    got = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                t_max=torch.from_numpy(t_max),
                                active=torch.from_numpy(active))
    _hits_agree(got, want)
    assert (got.idx.numpy()[~active] == -1).all()


def test_any_hit_matches_reference():
    ref, o, d = _random_case(42, 200, 300, spread=6.0)
    port = to_port(ref)
    closest = cc.intersect_clusters(port, torch.from_numpy(o),
                                    torch.from_numpy(d))
    hit = closest.idx.numpy() >= 0
    t_ref = closest.t.numpy()
    for scale, occluded in ((0.999, False), (1.001, True)):
        t_max = np.where(hit, t_ref * scale, 1e30).astype(np.float32)
        want = rpc.intersect_clusters_pallas(
            ref, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max),
            any_hit=True, interpret=True)
        got = cc.intersect_clusters(port, torch.from_numpy(o),
                                    torch.from_numpy(d),
                                    t_max=torch.from_numpy(t_max),
                                    any_hit=True)
        g, w = got.idx.numpy() >= 0, np.asarray(want.idx) >= 0
        assert (g == w).mean() >= 0.995
        assert (g[hit] == occluded).all()
        # any-hit reports the first triangle of the occluding cluster
        assert np.isin(got.idx.numpy()[g], port.cl_first.numpy()).all()


def test_any_hit_shadow_bundles_match_reference():
    """Shadow-like bundles: origins clustered per subgroup, one light per
    subgroup, t_max at the light (the hull phase-1 path)."""
    ref, _, _ = _random_case(3, 400, 1, spread=9.0)
    port = to_port(ref)
    rng = np.random.default_rng(3)
    R = 4 * SUB
    o = np.zeros((R, 3), np.float32)
    d = np.zeros((R, 3), np.float32)
    t0 = np.zeros((R,), np.float32)
    act = rng.uniform(0, 1, R) > 0.2
    for s in range(R // SUB):
        orig = rng.uniform(-6, 6, 3) + rng.normal(0, 0.8, (SUB, 3))
        vec = rng.uniform(-8, 8, 3) - orig
        dist = np.linalg.norm(vec, axis=1)
        sl = slice(s * SUB, (s + 1) * SUB)
        d[sl] = (vec / dist[:, None]).astype(np.float32)
        o[sl] = orig.astype(np.float32)
        t0[sl] = dist.astype(np.float32)

    want_key = rpc._phase1_anyhit_hull(
        jnp.asarray(o).reshape(4, SUB, 3), jnp.asarray(d).reshape(4, SUB, 3),
        jnp.asarray(t0).reshape(4, SUB), jnp.asarray(act).reshape(4, SUB),
        ref.cl_bbmin, ref.cl_bbmax)
    got_key = cc.phase1_anyhit_hull(
        torch.from_numpy(o).reshape(4, SUB, 3),
        torch.from_numpy(d).reshape(4, SUB, 3),
        torch.from_numpy(t0).reshape(4, SUB),
        torch.from_numpy(act).reshape(4, SUB), port.cl_bbmin, port.cl_bbmax)
    want_key = np.asarray(want_key)
    np.testing.assert_array_equal(got_key.numpy() < INF, want_key < INF)
    fin = want_key < INF
    np.testing.assert_allclose(got_key.numpy()[fin], want_key[fin], rtol=1e-6)

    want = rpc.intersect_clusters_pallas(
        ref, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t0),
        any_hit=True, active=jnp.asarray(act), interpret=True)
    got = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                t_max=torch.from_numpy(t0), any_hit=True,
                                active=torch.from_numpy(act))
    g, w = got.idx.numpy() >= 0, np.asarray(want.idx) >= 0
    assert g.any()
    assert (g == w).mean() >= 0.995


def test_scan_without_early_exit_agrees():
    """The exit rule is exact: a scan of every touched cluster (lists cut
    nowhere) gives the same hits as the scan with the exit."""
    ref, o, d = _random_case(44, 500, 1024)
    port = to_port(ref)
    o4, d4, t0, act = cc.pad_rays(torch.from_numpy(o), torch.from_numpy(d))
    bb = cc.cluster_boxes(port)
    const = cc.pack_cluster_rows(port)
    order, lb, n = cc.visit_lists(cc.phase1_exact(o4, d4, t0, act, bb))
    args = (o4, d4, t0, act, bb, const, order)
    rest = (n, port.cl_first, port.cl_count, False)
    t1, i1 = cc.cluster_scan(*args, lb, *rest)
    # keys of -1 never prove an exit: every touched cluster is visited
    t2, i2 = cc.cluster_scan(*args, torch.full_like(lb, -1.0), *rest)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())


def test_cluster_rows_round_trip_to_constants(edge):
    """The scan's triangle-major table is the reference layout
    (pack_cluster_constants) transposed; a cluster's real triangles are
    the first count rows of its block, and the next slot holds the next
    cluster's first triangle (the padding the scan never reads)."""
    _, port = edge
    rows = cc.pack_cluster_rows(port)
    K, M = port.cl_first.shape[0], port.cl_M
    assert rows.shape == (K, M, 16) and rows.is_contiguous()
    assert torch.equal(rows.transpose(1, 2), cc.pack_cluster_constants(port))
    count = port.cl_count.numpy()
    for k in np.flatnonzero(count < M)[:-1]:
        assert torch.equal(rows[k, count[k]], rows[k + 1, 0])


@pytest.mark.parametrize("any_hit", [False, True])
def test_scan_stats_count_the_work(edge, any_hit):
    """The plain scan's measurement hook: real triangles only (not the M
    padded slots), and warp slot steps that cover every lane's need."""
    _, port = edge
    o, d, _, _ = _edge_rays(port, "counts")
    t_max = _edge_t_max("counts", None) if any_hit else None
    o4, d4, t0, act = cc.pad_rays(
        torch.from_numpy(o), torch.from_numpy(d),
        None if t_max is None else torch.from_numpy(t_max))
    key = cc.phase1_keys(port, o4, d4, t0, act, any_hit, any_hit)
    stats = {}
    cc.cluster_scan_plain(o4, d4, t0, act, cc.cluster_boxes(port),
                          cc.pack_cluster_rows(port), *cc.visit_lists(key),
                          port.cl_first, port.cl_count, any_hit, stats=stats)
    count = port.cl_count.numpy()
    assert 0 < stats["visits"] <= (o4.shape[0] // SUB) * count.shape[0]
    assert 0 < stats["slabs"] <= stats["visits"] * SUB
    assert set(stats["clusters"]) <= set(range(count.shape[0]))
    assert 0 < stats["tris"] <= 32 * stats["warp_slots"]
    assert stats["warp_slots"] <= stats["visits"] * (SUB // 32) * count.max()


def test_empty_scene_and_inactive_rays():
    ref, o, d = _random_case(45, 100, 64)
    port = to_port(ref)
    none = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                 active=torch.zeros(64, dtype=torch.bool))
    assert (none.idx.numpy() == -1).all()
    assert (none.t.numpy() == np.float32(INF)).all()


# --- edge cases of the kernels' fast paths ---------------------------------
#
# The batches of scenes/kinds.cluster_edge_rays against the triangles of
# kinds.cluster_edge_tris: axis-parallel rays with zero (and -0.0)
# direction components, origins on box face planes (0 * inf = NaN in the
# slab test), origins inside boxes, finite t0 that cuts boxes, wholly and
# partly inactive subgroups, and clusters of count 1 and count M, in a cut
# whose K is not a multiple of 32. Phase-1 is held against the
# reference's Pallas kernel (_phase1_exact_pallas) in interpret mode,
# which the JAX package's own wrapper only runs on a TPU.

@pytest.fixture(scope="module")
def edge():
    """(reference scene, port scene) of kinds.cluster_edge_tris."""
    ref = _scene_with_tris(kinds.cluster_edge_tris())
    return ref, to_port(ref)


def _edge_rays(port, case):
    return kinds.cluster_edge_rays(case, port.cl_bbmin.numpy(),
                                   port.cl_bbmax.numpy(),
                                   port.cl_count.numpy())


def test_edge_scene_has_the_edge_clusters(edge):
    _, port = edge
    count = port.cl_count.numpy()
    K = count.shape[0]
    assert K > 32 and K % 32 != 0, K
    assert (count == 1).any() and (count == port.cl_M).any()
    assert 1 < np.median(count[count > 1]) < port.cl_M
    for case in kinds.EDGE_CASES:
        o, d, t_max, active = _edge_rays(port, case)
        assert o.shape == d.shape == (kinds.EDGE_RAYS, 3)
        assert np.isfinite(o).all() and np.isfinite(d).all()
    o, d, _, _ = _edge_rays(port, "axis")
    assert ((d == 0).sum(axis=1) == 2).all() and np.signbit(d[d == 0]).any()
    _, d, _, _ = _edge_rays(port, "face")
    assert ((d == 0).sum(axis=1) >= 1).all()


def _ref_phase1_kernel(monkeypatch, ref, o4, d4, t0, act):
    """The reference's fused phase-1 kernel in interpret mode -> [S, K]."""
    monkeypatch.setattr(rpc.pl, "pallas_call",
                        functools.partial(rpc.pl.pallas_call, interpret=True))
    n_tiles = o4.shape[0] // rpc.RAY_TILE
    key = rpc._phase1_exact_pallas(
        *(jnp.asarray(x.numpy()) for x in (o4, d4, t0, act)),
        ref.cl_bbmin, ref.cl_bbmax, n_tiles, rpc.RAY_TILE // SUB)
    return np.asarray(key)


@pytest.mark.parametrize("case", kinds.EDGE_CASES)
def test_edge_phase1_matches_reference_kernel(monkeypatch, edge, case):
    ref, port = edge
    o, d, t_max, active = _edge_rays(port, case)
    o4, d4, t0, act = cc.pad_rays(
        torch.from_numpy(o), torch.from_numpy(d),
        None if t_max is None else torch.from_numpy(t_max),
        None if active is None else torch.from_numpy(active))
    got = cc.phase1_exact(o4, d4, t0, act, cc.cluster_boxes(port)).numpy()
    want = _ref_phase1_kernel(monkeypatch, ref, o4, d4, t0, act)
    assert got.shape == want.shape
    touched = want < INF
    assert touched.any()
    np.testing.assert_array_equal(got < INF, touched)
    np.testing.assert_array_equal(got, want)
    if case == "inactive":
        assert not touched[0].any()


def _edge_hits_agree(port, o, d, got, want):
    """_hits_agree's bars, with t held to the edge batches' bar
    (kinds.edge_t_misses): rtol 5e-5 plus 2^-22 of the solve's rounding
    scale, where XLA's fused evaluation of t = (o.N - N.p2) / s and the
    port's op-by-op one differ by a few ulps of the larger term, and at
    least 99% of the hits within rtol 5e-5 alone."""
    gi, wi = got.idx.numpy(), np.asarray(want.idx)
    assert (gi == wi).mean() >= 0.995, (gi == wi).mean()
    both = (wi >= 0) & (gi == wi)
    np.testing.assert_array_equal(got.t.numpy()[gi < 0], np.float32(INF))
    n_bad, frac = kinds.edge_t_misses(
        cc.pack_cluster_rows(port), port.cl_first, torch.from_numpy(o[both]),
        torch.from_numpy(d[both]), torch.from_numpy(wi[both]),
        got.t[torch.from_numpy(both)], torch.from_numpy(np.asarray(want.t)[both]))
    assert n_bad == 0 and frac >= 0.99, (n_bad, frac)


def _edge_t_max(case, t_max):
    """A finite bound for the any-hit queries of every batch."""
    if t_max is not None:
        return t_max
    rng = np.random.default_rng(kinds.EDGE_CASES.index(case))
    return rng.uniform(0.5, 40.0, kinds.EDGE_RAYS).astype(np.float32)


@pytest.mark.parametrize("case", kinds.EDGE_CASES)
def test_edge_closest_hit_matches_reference(edge, case):
    ref, port = edge
    o, d, t_max, active = _edge_rays(port, case)
    jx = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    tx = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    want = rpc.intersect_clusters_pallas(ref, jnp.asarray(o), jnp.asarray(d),
                                         t_max=jx(t_max), active=jx(active),
                                         interpret=True)
    got = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                t_max=tx(t_max), active=tx(active))
    assert (got.idx.numpy() >= 0).mean() > 0.05
    _edge_hits_agree(port, o, d, got, want)
    if active is not None:
        assert (got.idx.numpy()[~active] == -1).all()


@pytest.mark.parametrize("case", kinds.EDGE_CASES)
def test_edge_any_hit_matches_reference(edge, case):
    ref, port = edge
    o, d, t_max, active = _edge_rays(port, case)
    t_max = _edge_t_max(case, t_max)
    act = np.ones(o.shape[0], bool) if active is None else active
    want = rpc.intersect_clusters_pallas(
        ref, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max),
        any_hit=True, active=jnp.asarray(act), interpret=True)
    got = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                t_max=torch.from_numpy(t_max), any_hit=True,
                                active=torch.from_numpy(act))
    g, w = got.idx.numpy() >= 0, np.asarray(want.idx) >= 0
    assert g.any()
    assert (g == w).mean() >= 0.995
    assert np.isin(got.idx.numpy()[g], port.cl_first.numpy()).all()
    assert not g[~act].any()
