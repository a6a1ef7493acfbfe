"""The port's triangle methods "bvh" and "brute" vs the reference's.

The walk (``traverse_bvh_plain``, the plain version of K7) against the
reference's lockstep XLA walk and against K7 itself, the Pallas design
study ``tools/studies/pallas_traverse.py``, run in interpret mode as
tests/test_pallas.py runs it; the brute-force oracle against the
reference's; then ``render``, ``render_aa`` and the training step with
``tri_method="bvh"`` and ``"brute"`` end to end.

Both packages get the identical packed scene (the reference's NumPy BVH
build, MRT_NO_NATIVE=1, carried across). Tolerances:
  * the walk vs the reference's walk: ids equal, t within rtol 1e-5.
    Not to the bit: XLA's CPU compiler fuses the jitted walk's Cramer
    solve and contracts its products into FMAs (up to 1e-5 relative on
    grazing hits). The same solve run eagerly by the reference equals
    the port's t to the bit, which the test checks on the hit rows;
  * the walk vs K7 in interpret mode: hit masks equal, t within rtol
    1e-5 (the reference's own bar between the two);
  * brute vs the reference's brute: ids equal; the walk vs brute: hit
    masks equal, t within rtol 1e-5, ids equal on >= 99% of hits (they
    may differ on exact ties of t only);
  * images: >= 99.5% of pixels within 1e-4 (a flipped fp tie changes a
    pixel's hit, not the image); the training step: loss within rtol
    1e-5, every gradient within 5e-4 * max|a|. For the reference side of
    an image or a training step the cheapest of its triangle methods on
    the CPU, "brute", is used: its three methods agree to 1e-5.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import intersect as risx
from myraytracer_tpu.ops import traverse as rtrv
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render as r_render, render_aa as r_render_aa,
    render_loss_grad_image as r_loss_grad_image)
from myraytracer_tpu.parallel.shard_render import (
    split_params as r_split_params)
from myraytracer_tpu.scenes import golden as rgolden

from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.scenes import golden

from test_bvh import _scene_with_tris, random_tris
from test_torch_scene import mesh_scene, office, to_port

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tools", "studies"))
from pallas_traverse import traverse_bvh_pallas  # noqa: E402

REF_BRUTE = rtr.TraceConfig(tri_method="brute")
GRAD_REL = 5e-4

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _numpy_bvh(monkeypatch):
    # the port carries the reference's NumPy BVH builder
    monkeypatch.setenv("MRT_NO_NATIVE", "1")


def _walk_case(seed, n_tris=300, R=700):
    """A random-triangle scene in both packages and R random rays (R is
    not a multiple of 32)."""
    rng = np.random.default_rng(seed)
    ref = _scene_with_tris(random_tris(n_tris, rng))
    o = rng.uniform(-20, 20, size=(R, 3)).astype(np.float32)
    target = rng.uniform(-10, 10, size=(R, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:5, 1] = -0.0            # -0 components: 1/d = -inf, octant bit 0
    d[5:10, 0] = 0.0
    active = rng.uniform(size=R) > 0.2
    return ref, to_port(ref), o, d, active, rng


def _queries(closest, active):
    """(name, kwargs) of the three walk queries: closest; any-hit with
    t_max just below each ray's closest t (``closest``, a TriHit); closest
    with an active mask."""
    t_c = np.asarray(closest.t)
    t_max = np.where(t_c < 1e30, t_c * np.float32(0.999),
                     np.float32(1e30)).astype(np.float32)
    t_max[::3] = np.float32(1e30)          # and some unbounded ones
    return [("closest", {}),
            ("anyhit", dict(t_max=t_max, any_hit=True)),
            ("active", dict(active=active))]


def _ref_kwargs(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _port_kwargs(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def test_walk_matches_reference_walk():
    ref, port, o, d, active, _ = _walk_case(21)
    closest = rtrv.traverse_bvh(ref, jnp.asarray(o), jnp.asarray(d))
    for name, kw in _queries(closest, active):
        want = closest if name == "closest" else rtrv.traverse_bvh(
            ref, jnp.asarray(o), jnp.asarray(d), **_ref_kwargs(kw))
        got = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d),
                               **_port_kwargs(kw))
        assert got.idx.dtype == torch.int32 and got.t.dtype == torch.float32
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx),
                                      err_msg=name)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-5, err_msg=name)
        # the reference's solve, run eagerly on the hit rows: bit-equal
        hit = got.idx.numpy() >= 0
        if not name.startswith("anyhit"):
            tri = np.asarray(rtrv.pack_tri_vertices(ref))[got.idx.numpy()[hit]]
            t_eager, _, _ = risx.ray_triangle(
                jnp.asarray(o[hit]), jnp.asarray(d[hit]),
                *(jnp.asarray(tri[:, i:i + 3]) for i in (0, 3, 6)))
            np.testing.assert_array_equal(
                got.t.numpy()[hit].view(np.int32),
                np.asarray(t_eager).view(np.int32), err_msg=name)
        hits = (got.idx >= 0).float().mean()
        assert 0.05 < hits < 0.95 or name.startswith("anyhit"), (name, hits)
    # the any-hit bound just below the closest t hides every closest hit
    closest = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d))
    below = _queries(closest, active)[1][1]["t_max"]
    occl = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d),
                            t_max=torch.from_numpy(below), any_hit=True)
    hit = closest.idx.numpy() >= 0
    assert (occl.idx.numpy()[hit & (below < 1e30)] == -1).all()


def test_walk_matches_k7_interpret():
    ref, port, o, d, active, _ = _walk_case(22, n_tris=200, R=600)
    closest = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d))
    for name, kw in _queries(closest, active):
        want = traverse_bvh_pallas(ref, jnp.asarray(o), jnp.asarray(d),
                                   interpret=True, **_ref_kwargs(kw))
        got = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d),
                               **_port_kwargs(kw))
        w_hit = np.asarray(want.idx) >= 0
        np.testing.assert_array_equal(got.idx.numpy() >= 0, w_hit,
                                      err_msg=name)
        np.testing.assert_allclose(got.t.numpy()[w_hit],
                                   np.asarray(want.t)[w_hit], rtol=1e-5,
                                   err_msg=name)


def test_brute_matches_reference_and_the_walk():
    ref, port, o, d, _, _ = _walk_case(23, n_tris=257, R=400)
    t_max = np.full(o.shape[0], 1e30, np.float32)
    t_max[::2] = 12.0
    for kw in ({}, dict(t_max=t_max)):
        want = rtrv.intersect_tris_brute(ref, jnp.asarray(o), jnp.asarray(d),
                                         chunk=64, **_ref_kwargs(kw))
        got = trv.intersect_tris_brute(port, torch.from_numpy(o),
                                       torch.from_numpy(d), chunk=64,
                                       **_port_kwargs(kw))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-6)
    # the port's walk against the port's oracle
    brute = trv.intersect_tris_brute(port, torch.from_numpy(o),
                                     torch.from_numpy(d))
    walk = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d))
    hit = walk.idx.numpy() >= 0
    np.testing.assert_array_equal(hit, brute.idx.numpy() >= 0)
    np.testing.assert_allclose(walk.t.numpy()[hit], brute.t.numpy()[hit],
                               rtol=1e-5)
    assert (walk.idx.numpy()[hit] == brute.idx.numpy()[hit]).mean() >= 0.99
    assert hit.mean() > 0.1


def test_walk_stats_count_the_work():
    _, port, o, d, _, _ = _walk_case(24, n_tris=100, R=128)
    stats = {}
    got = trv.traverse_bvh_plain(port, torch.from_numpy(o),
                                 torch.from_numpy(d), stats=stats)
    want = trv.traverse_bvh(port, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(got.idx, want.idx)
    N = port.bvh_nodes_packed.shape[0]
    assert 128 <= stats["visits"] <= 128 * N
    assert 0 < stats["nodes"] <= N and 0 < stats["links"] <= 8 * N
    assert 0 < stats["tris"] <= port.n_tris <= stats["slots"]


def test_trace_config_rejects_unknown_methods():
    data = mesh_scene("port").build(device="cpu")
    for cfg in (tr.TraceConfig(tri_method="bvh2"),
                tr.TraceConfig(tri_method="AUTO"),
                tr.TraceConfig(texture_filter="trilinear")):
        with pytest.raises(ValueError):
            tr.pack_trace(data, cfg)
    assert tr.TraceConfig().tri_method == "cluster"
    for method in ("bvh", "auto"):
        bvh = tr.pack_trace(data, tr.TraceConfig(tri_method=method))
        assert bvh.cl_rows is None and bvh.tri_flat.shape == (data.n_tris, 16)
    assert tr.pack_trace(data).tri_flat is None


@pytest.mark.parametrize("entry", ["render", "render_aa"])
def test_auto_is_the_walk(entry):
    """"auto" resolves to "bvh", the reference's rule off the TPU: the
    same images, bit for bit."""
    s = mesh_scene("port")
    s.meshes[1].material.mirror = 0.5
    data = s.build(device="cpu")
    fn = getattr(prender, entry)
    assert tr.TraceConfig(tri_method="auto").resolved_method() == "bvh"
    auto = fn(data, s.camera, cfg=tr.TraceConfig(tri_method="auto"))
    bvh = fn(data, s.camera, cfg=tr.TraceConfig(tri_method="bvh"))
    assert torch.equal(auto, bvh) and float(auto.mean()) > 0.02


# --- render and render_aa ---------------------------------------------------

def _agree(got, want, frac=0.995):
    diff = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    assert (diff <= 1e-4).mean() >= frac, (diff <= 1e-4).mean()


@pytest.mark.parametrize("name", ["office", "mirror"])
def test_render_bvh_and_brute_match_reference(name):
    if name == "office":
        s, cam = office("ref", tess=2, w=64, h=48), office("port", tess=2,
                                                           w=64, h=48).camera
    else:
        s, cam = mesh_scene("ref"), mesh_scene("port").camera
        s.meshes[1].material.mirror = 0.5
    ref = s.build()
    port = to_port(ref)
    want = np.asarray(r_render(ref, s.camera, cfg=REF_BRUTE))
    images = {m: prender.render(port, cam, cfg=tr.TraceConfig(tri_method=m))
              for m in ("bvh", "brute", "cluster")}
    for m in ("bvh", "brute"):
        got = images[m].numpy()
        assert np.isfinite(got).all() and 0.02 < got.mean() < 0.95
        _agree(got, want)
        _agree(got, images["cluster"].numpy())


@pytest.mark.parametrize("name", ["o_09_rings", "o_10_pokemon"])
def test_render_aa_bvh_matches_reference(name):
    """A golden with triangles and mirror rings, and the textured one, at
    a tenth of the size, with a covering AA budget (as in
    tests/test_torch_golden.py)."""
    rs = rgolden.GOLDEN_SCENES[name][0](scale=0.1)
    ref = rs.build()
    port = to_port(ref)
    cam = golden.GOLDEN_SCENES[name][0](scale=0.1).camera
    cfg = tr.TraceConfig(tri_method="bvh")
    img1 = prender.render(port, cam, cfg=cfg)
    n_px = cam.width * cam.height
    above = int((prender._deviation(img1) > prender.AA_THRESHOLD).sum())
    budget = min(1.0, max(golden.GOLDEN_SCENES[name][1],
                          (above + max(4, 0.03 * above) + 1) / n_px))
    assert prender.aa_budget_covered(img1, budget)
    want = np.asarray(r_render_aa(ref, rs.camera, cfg=REF_BRUTE,
                                  budget_frac=budget))
    got = prender._aa_refine(port, cam, img1, cfg=cfg,
                             budget_frac=budget).numpy()
    assert np.isfinite(got).all()
    _agree(got, want)


# --- the training step -----------------------------------------------------

def _scaled_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    tol = rel * max(float(np.abs(want).max()) if want.size else 0.0, 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_loss_grad_bvh_matches_reference():
    s = office("ref", tess=2, w=64, h=48)
    ref = s.build()
    port = to_port(ref)
    cam = office("port", tess=2, w=64, h=48).camera
    cfg = tr.TraceConfig(tri_method="bvh")
    rng = np.random.default_rng(4)
    target = rng.uniform(0.0, 1.0, (cam.height, cam.width, 3)).astype(
        np.float32)
    r_loss, r_grads = r_loss_grad_image(ref, s.camera, jnp.asarray(target),
                                        cfg=REF_BRUTE)
    loss, grads = prender.render_loss_grad_image(
        port, cam, torch.from_numpy(target), cfg=cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert list(grads) == list(r_split_params(ref)) and len(grads) == 23
    for k, want in r_grads.items():
        _scaled_close(grads[k].numpy(), np.asarray(want), GRAD_REL, k)
    assert np.abs(np.asarray(r_grads["vertex_pos"])).max() > 0


def test_walk_stats_count_lanes_busy():
    """Hand-counted lanes busy: two triangles far apart under a root box
    (leaf size 1: a root and two leaves). A ray inside the root's box
    takes three steps (root, both leaves), a ray outside it one. Rays
    0-15 run inside, 16-39 outside; with rays 16-31 inactive, the call
    order's two warps hold 16 x 3 + 8 x 1 = 56 steps under warp maxima
    3 + 1, and the 24 active rays packed into one warp 56 under 3, by the
    block's packing and by the list of the active rays alike."""
    from myraytracer_tpu_torch.models.material import Material
    from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
    from myraytracer_tpu_torch.models.scene import Scene

    tri = np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                      [[10, 0, 0], [11, 0, 0], [10, 1, 0]]])
    s = Scene()
    s.add_mesh(TriangleMesh(tri.reshape(-1, 3), np.arange(6).reshape(2, 3),
                            material=Material(), draw_mode=FLAT))
    port = s.build(device="cpu", leaf_size=1)
    assert port.bvh_nodes_packed.shape[0] == 3
    R = 40
    o = np.tile(np.float32([[50.0, 0.25, 5.0]]), (R, 1))
    o[:16, 0] = 0.25
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (R, 1))
    stats = {}
    hit = trv.traverse_bvh_plain(port, torch.from_numpy(o),
                                 torch.from_numpy(d), stats=stats)
    assert (hit.idx[:16] == 0).all() and (hit.idx[16:] == -1).all()
    assert stats["visits"] == 16 * 3 + 24
    assert stats["warp_steps"] == 3 + 1
    assert stats["lanes_busy"] == (16 * 3 + 24) / (32 * 4)
    active = torch.ones(R, dtype=torch.bool)
    active[16:32] = False
    stats = {}
    trv.traverse_bvh_plain(port, torch.from_numpy(o), torch.from_numpy(d),
                           active=active, stats=stats)
    assert stats["visits"] == 56
    assert (stats["warp_steps"], stats["lanes_busy"]) == (4, 56 / (32 * 4))
    assert stats["warp_steps_compact"] == 3
    assert stats["lanes_busy_compact"] == 56 / (32 * 3)
    # the list of the active rays (rays 0-15, 32-39) fills one warp too
    assert stats["warp_steps_list"] == 3
    assert stats["lanes_busy_list"] == 56 / (32 * 3)


def test_compacted_any_hit_walk_equals_the_walk():
    """K7's any-hit launch walks each block's active rays packed into the
    block's first threads, in call order, and writes each result back to
    its ray (ops/traverse.compact_active is the order): the plain walk
    over the rays in that order, scattered back, equals the plain walk
    with the mask."""
    _, port, o, d, active, rng = _walk_case(25)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    act = torch.from_numpy(active)
    R, B = o.shape[0], trv.WALK_BLOCK
    t_max = torch.from_numpy(rng.uniform(0.5, 30.0, R).astype(np.float32))
    want = trv.traverse_bvh_plain(port, o, d, t_max=t_max, any_hit=True,
                                  active=act)
    order = trv.compact_active(act)
    assert torch.equal(torch.sort(order).values, torch.arange(R))
    for b in range(0, R, B):
        blk = order[b:b + B]
        n = int(act[b:b + B].sum())
        assert bool((blk // B == b // B).all())
        assert torch.equal(blk[:n], b + torch.nonzero(act[b:b + B])[:, 0])
    ids = order[act[order]]
    part = trv.traverse_bvh_plain(port, o[ids], d[ids], t_max=t_max[ids],
                                  any_hit=True)
    idx = torch.full_like(want.idx, -1)
    t = torch.full_like(want.t, INF)
    idx[ids], t[ids] = part.idx, part.t
    assert torch.equal(idx, want.idx) and torch.equal(t, want.t)
    assert bool((want.idx >= 0).any()) and bool((want.idx[~act] == -1).all())
