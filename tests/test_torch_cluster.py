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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import intersect as risx
from myraytracer_tpu.ops import pallas_cluster as rpc

from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.ops.render import primary_rays_blocked

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
    const = cc.pack_cluster_constants(port)
    order, lb, n = cc.visit_lists(cc.phase1_exact(o4, d4, t0, act, bb))
    args = (o4, d4, t0, act, bb, const, order)
    rest = (n, port.cl_first, port.cl_count, False)
    t1, i1 = cc.cluster_scan(*args, lb, *rest)
    # keys of -1 never prove an exit: every touched cluster is visited
    t2, i2 = cc.cluster_scan(*args, torch.full_like(lb, -1.0), *rest)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())


def test_empty_scene_and_inactive_rays():
    ref, o, d = _random_case(45, 100, 64)
    port = to_port(ref)
    none = cc.intersect_clusters(port, torch.from_numpy(o), torch.from_numpy(d),
                                 active=torch.zeros(64, dtype=torch.bool))
    assert (none.idx.numpy() == -1).all()
    assert (none.t.numpy() == np.float32(INF)).all()
