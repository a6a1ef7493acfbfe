"""The port's training step vs the reference's, piece by piece and whole.

The reference runs its fused path (cluster scan and fused shading in
Pallas interpret mode on the CPU); the port runs the plain PyTorch
versions of its kernels (CPU tensors). Both get the identical packed
scene, and inputs made from NumPy seeds.

Tolerances:
  * refit boxes: bit for bit (min/max are exact);
  * shade segment forward: atol 1e-5 (the reference's own bar between
    its Pallas and plain-JAX executors);
  * shade segment cotangents: 3e-5 * max|a| per cotangent, against the
    reference's hand-derived VJP and against torch.autograd of the
    port's forward (the reference's bar for its VJP);
  * the training step: loss within rtol 1e-5, every gradient within
    5e-4 * max|a| (the reference's bar after the pack backward, where
    scatter-adds sum in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import refit as rrefit
from myraytracer_tpu.ops import shade_grad as rsg
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render_loss_grad_image as r_loss_grad_image,
    restore_mirror_chain as r_restore_mirror_chain)
from myraytracer_tpu.parallel.shard_render import (
    split_params as r_split_params)

from myraytracer_tpu_torch.ops import intersect as isx
from myraytracer_tpu_torch.ops import refit
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops.shade import EPS_OFFSET
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

from test_torch_scene import mesh_scene, office, to_port

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)
GRAD_REL = 5e-4
COT_REL = 3e-5

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _scaled_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    tol = rel * max(float(np.abs(want).max()) if want.size else 0.0, 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def _scene_pair(name):
    """(reference SceneData, port SceneData, port camera) of a test scene.

    "mirror": the two-light mesh scene, built mirror-free (live_depth 1)
    and then given mat_mirror > 0, so the training step must restore the
    full three-segment chain before its topology pass.
    """
    if name == "office":
        ref = office("ref", tess=2, w=64, h=48).build()
        return ref, to_port(ref), office("port", tess=2, w=64, h=48).camera
    ref = mesh_scene("ref").build()
    assert ref.n_segments == 1 and ref.n_lights == 2
    mm = np.zeros(ref.mat_mirror.shape, np.float32)
    mm[-1] = 0.5
    port = dataclasses.replace(to_port(ref), mat_mirror=torch.from_numpy(mm))
    ref = dataclasses.replace(ref, mat_mirror=jnp.asarray(mm))
    return ref, port, mesh_scene("port").camera


@pytest.fixture(scope="module", params=["office", "mirror"])
def case(request):
    ref, port, cam = _scene_pair(request.param)
    o, d = prender.primary_rays_blocked(cam, "cpu")
    img = prender.render(prender.restore_mirror_chain(port), cam)
    target = (0.9 * img + 0.02).numpy()
    return dict(name=request.param, ref=ref, port=port, cam=cam, o=o, d=d,
                target=target)


# --- refit and parameters -------------------------------------------------

def test_refit_matches_reference_bit_for_bit():
    ref = office("ref", tess=2, w=64, h=48).build()
    rng = np.random.default_rng(11)
    vp = np.asarray(ref.vertex_pos)
    vp = (vp + rng.uniform(-1e-3, 1e-3, vp.shape)).astype(np.float32)
    want = rrefit.refit_accel(dataclasses.replace(ref,
                                                  vertex_pos=jnp.asarray(vp)))
    got = refit.refit_accel(dataclasses.replace(
        to_port(ref), vertex_pos=torch.from_numpy(vp)))
    for f in ("bvh_bbmin", "bvh_bbmax", "bvh_nodes_packed", "cl_bbmin",
              "cl_bbmax"):
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f)
    # the jitter moved the boxes: this is a refit, not a copy
    assert not np.array_equal(got.cl_bbmin.numpy(), np.asarray(ref.cl_bbmin))


@pytest.mark.parametrize("name", ["office", "mirror"])
def test_split_params_matches_reference(name):
    ref, port, _ = _scene_pair(name)
    want = r_split_params(ref)
    got = split_params(port)
    assert list(got) == list(want) and len(got) == 23
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
    merged = merge_params(port, {"light_color": got["light_color"] * 2})
    assert torch.equal(merged.light_color, port.light_color * 2)
    assert merged.tri_vidx is port.tri_vidx


# --- the shade segment (K5 / K6 plain versions) ---------------------------

def _segment_case(name, n_lights, seed=3):
    """Inputs of one shade segment: the first segment's recorded topology
    plus seeded weights, dead rays, lit masks and cotangents."""
    ref, port, cam = _scene_pair(name)
    o, d = prender.primary_rays_blocked(cam, "cpu")
    topo = tr.trace_topology(port, o, d)
    geom = shade.pack_shade_geom(port)
    tri_pack = geom.tri_pack.clone()
    tri_pack[:, 42] = torch.maximum(tri_pack[:, 42], torch.tensor(0.2))
    R = o.shape[0]
    rng = np.random.default_rng(seed)
    alive = torch.from_numpy(rng.uniform(size=R) > 0.1)
    is_t = (topo.kind[0] == shade.KIND_TRI) & alive
    h, miss = topo.hit[0] & alive, topo.miss[0] & alive
    extra = np.float32([[-2.0, 3.0, 2.0], [0.3, 0.25, 0.1]])
    lp = np.concatenate([port.light_pos.numpy(), extra[:1]])[:n_lights]
    lc = np.concatenate([port.light_color.numpy(), extra[1:]])[:n_lights]
    lit = (rng.uniform(size=(n_lights, R)) > 0.3).astype(np.float32)
    args = (o, d, torch.from_numpy(rng.uniform(0.2, 1.0, R).astype(np.float32)),
            tri_pack, torch.clamp(topo.idx[0], 0, port.n_tris - 1),
            torch.from_numpy(lp), torch.from_numpy(lc), port.ambience,
            port.background, is_t, h, miss, torch.from_numpy(lit))
    cots = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((R, 3), (R, 3), (R, 3), (R,)))
    assert int(is_t.sum()) > 50 and miss.any()
    return args, cots


def _ref_args(args):
    """The reference's argument list: rows gathered, JAX arrays."""
    (o, d, w, tri_pack, ti, lp, lc, amb, bg, is_t, h, miss, lit) = args
    rows = tri_pack[ti.long()]
    return tuple(jnp.asarray(x.numpy()) for x in
                 (o, d, w, rows, lp, lc, amb, bg, is_t, h, miss, lit))


SEGMENT_CASES = [("office", 1), ("office", 2), ("mirror", 1), ("mirror", 2)]


@pytest.mark.parametrize("name,n_lights", SEGMENT_CASES)
def test_segment_plain_matches_reference(name, n_lights):
    args, _ = _segment_case(name, n_lights)
    want = rsg.segment_ref(*_ref_args(args))
    got = sg.segment_plain(*args)
    for nm, a, b in zip(("add", "o2", "d2", "w2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=nm)
    assert (got[3] > 0).any()                       # some rays bounce on


@pytest.mark.parametrize("name,n_lights", SEGMENT_CASES)
def test_segment_bwd_plain_matches_reference_and_autograd(name, n_lights):
    """The per-ray reverse (rows in _GRAD_COLS order) against the
    reference's segment_bwd_ref, and the whole of K6's plain version
    (rows summed into the tri_pack cotangent) against autograd."""
    args, cots = _segment_case(name, n_lights, seed=4)
    got = sg.segment_bwd_rows_plain(*args, *cots)
    want = rsg.segment_bwd_ref(*_ref_args(args),
                               *(jnp.asarray(c.numpy()) for c in cots))
    names = ("o", "d", "w", "rows", "light_pos", "light_color", "ambience",
             "background")
    for nm, a, b in zip(names, got, want):
        b = np.asarray(b)
        if nm == "rows":
            b = b[:, list(sg._GRAD_COLS)]
        _scaled_close(a.numpy(), b, COT_REL, f"{nm} vs the reference")

    # the port's own check: torch.autograd of the forward, through
    # ShadeSegment (hand VJP with the row sum into tri_pack) and without it
    diff_at = (0, 1, 2, 3, 5, 6, 7, 8)
    grads = []
    for hand in (True, False):
        leaves = [a.clone().requires_grad_(True) if i in diff_at else a
                  for i, a in enumerate(args)]
        out = (sg.ShadeSegment.apply(*leaves, True) if hand
               else sg.segment_plain(*leaves))
        loss = sum((x * c).sum() for x, c in zip(out, cots))
        grads.append(torch.autograd.grad(loss, [leaves[i] for i in diff_at]))
    for nm, a, b in zip(("o", "d", "w", "tri_pack") + names[4:], *grads):
        _scaled_close(a.numpy(), b.numpy(), COT_REL, f"{nm} vs autograd")


@pytest.mark.parametrize("name,n_lights", SEGMENT_CASES)
def test_segment_bwd_plain_g_pack_matches_reference_scatter(name, n_lights):
    """K6's plain version returns the tri_pack cotangent itself: the
    reference's jnp.zeros_like(tri_pack).at[ti].add(rows) within
    5e-4 * max|a| (the bar of the summed gradients), zero off the
    _GRAD_COLS columns, and torch.autograd of segment_plain with respect
    to tri_pack; its other outputs equal the per-ray version's."""
    args, cots = _segment_case(name, n_lights, seed=5)
    got = sg.segment_bwd_plain(*args, *cots)
    rows = sg.segment_bwd_rows_plain(*args, *cots)
    want_rows = rsg.segment_bwd_ref(*_ref_args(args),
                                    *(jnp.asarray(c.numpy()) for c in cots))[3]
    tri_pack, ti = args[3], args[4]
    want = jnp.zeros_like(jnp.asarray(tri_pack.numpy())).at[
        jnp.asarray(ti.numpy())].add(want_rows)
    g_pack = got[3]
    assert g_pack.shape == tri_pack.shape
    _scaled_close(g_pack.numpy(), np.asarray(want), GRAD_REL,
                  "g_pack vs the reference's scatter")
    off = [c for c in range(tri_pack.shape[1]) if c not in sg._GRAD_COLS]
    assert not g_pack[:, off].any()
    assert int((g_pack.abs().sum(1) > 0).sum()) > 10
    for i in (0, 1, 2, 4, 5, 6, 7):
        assert torch.equal(got[i], rows[i])
    leaves = [a.clone().requires_grad_(True) if i == 3 else a
              for i, a in enumerate(args)]
    loss = sum((x * c).sum() for x, c in zip(sg.segment_plain(*leaves), cots))
    ad, = torch.autograd.grad(loss, [leaves[3]])
    _scaled_close(g_pack.numpy(), ad.numpy(), GRAD_REL, "g_pack vs autograd")


def test_segment_bwd_stays_finite_when_the_resolve_fails():
    """A recorded triangle hit whose det3 re-solve falls outside the
    triangle (a grazing edge where the scan's solve form says inside, or
    a replayed ray whose last bits differ from the traced one's) keeps
    the hit: t from the solve of the triangle's plane. The reference
    puts the point at t = INF there; its hand VJP forms 2 * lv, which
    overflows, and inf * 0 turns the light-position cotangent into NaN
    (one such ray in office 480x270 made vertex_pos and light_pos grads
    NaN; one in the o_09 rings' fit at 700x500 sent a reflected ray to
    INF and made the loss NaN). The port's forward is finite, the point
    on the triangle's plane, and its backward equals autograd of it."""
    tri = np.zeros((1, 48), np.float32)
    tri[0, 0:9] = [0, 0, 0, 1, 0, 0, 0, 1, 0]           # z = 0 plane
    tri[0, 16:25] = [0, 0, 1] * 3
    tri[0, 32:43] = [0.5, 0.4, 0.3, 0.1, 0.1, 0.1, 0.3, 0.3, 0.3, 20, 0]
    o = np.float32([[2.0, 2.0, 1.0]])                   # misses the triangle
    d = np.float32([[0.8, 0.0, -0.6]])
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.ones(1),
            torch.from_numpy(tri), torch.zeros(1, dtype=torch.int32),
            torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[0.8, 0.8, 0.8]]),
            torch.tensor([0.2, 0.2, 0.2]), torch.tensor([0.0, 0.1, 0.2]),
            torch.tensor([True]), torch.tensor([True]), torch.tensor([False]),
            torch.ones((1, 1)))
    cots = (torch.tensor([[1.0, -0.5, 0.25]]), torch.zeros(1, 3),
            torch.tensor([[0.3, 0.1, -0.2]]), torch.tensor([0.7]))
    add, o2, d2, w2 = sg.segment_plain(*args)
    assert all(bool(torch.isfinite(x).all()) for x in (add, o2, d2, w2))
    # the plane z = 0 at t = 1 / 0.6, the bounce off its normal
    refl = torch.tensor([[0.8, 0.0, 0.6]])
    torch.testing.assert_close(d2, refl)
    torch.testing.assert_close(
        o2, torch.tensor([[2.0 + 0.8 / 0.6, 2.0, 0.0]]) + EPS_OFFSET * refl)
    ref_g = rsg.segment_bwd_ref(*_ref_args(args),
                                *(jnp.asarray(c.numpy()) for c in cots))
    assert not np.isfinite(np.asarray(ref_g[4])).all()  # the reference's NaN
    got = sg.segment_bwd_plain(*args, *cots)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    leaves = [a.clone().requires_grad_(True) if i in (0, 1, 5) else a
              for i, a in enumerate(args)]
    loss = sum((x * c).sum() for x, c in zip(sg.segment_plain(*leaves), cots))
    ad = torch.autograd.grad(loss, [leaves[0], leaves[1], leaves[5]])
    for nm, a, b in zip(("o", "d", "light_pos"), (got[0], got[1], got[4]),
                        ad):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=nm)


#: a point just across each edge of the triangle (0,0,0), (1,0,0), (0,1,0)
#: of the z = 0 plane, at (beta, gamma): outside, then inside
_EDGE = 2.0 ** -20
EDGE_POINTS = {"alpha": ((0.3, 0.7 + _EDGE), (0.3, 0.7 - _EDGE)),
               "beta": ((-_EDGE, 0.4), (_EDGE, 0.4)),
               "gamma": ((0.4, -_EDGE), (0.4, _EDGE))}


def _edge_args(point):
    """One PHONG mirror triangle and a ray that meets its plane at
    ``point`` (x, y) after t = 1.25."""
    tri = np.zeros((1, 48), np.float32)
    tri[0, 0:9] = [0, 0, 0, 1, 0, 0, 0, 1, 0]
    tri[0, 16:25] = [0, 0, 1, 0.2, 0, 1, 0, 0.3, 1]     # corner normals
    tri[0, 25] = 1.0                                    # PHONG
    tri[0, 32:43] = [0.5, 0.4, 0.3, 0.1, 0.1, 0.1, 0.3, 0.3, 0.3, 20, 0.4]
    d = np.float32([[0.6, 0.0, -0.8]])
    o = np.float32([[point[0], point[1], 0.0]]) - np.float32(1.25) * d
    return (torch.from_numpy(o), torch.from_numpy(d), torch.ones(1),
            torch.from_numpy(tri), torch.zeros(1, dtype=torch.int32),
            torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[0.8, 0.8, 0.8]]),
            torch.tensor([0.2, 0.2, 0.2]), torch.tensor([0.0, 0.1, 0.2]),
            torch.tensor([True]), torch.tensor([True]), torch.tensor([False]),
            torch.ones((1, 1)))


@pytest.mark.parametrize("edge", sorted(EDGE_POINTS))
def test_recorded_hit_just_outside_an_edge_matches_the_reference_inside(edge):
    """A replayed ray that falls 2**-20 outside an edge of its recorded
    triangle (intersect.keeps_recorded_hit) shades as the reference
    shades the ray 2**-20 inside it, where the reference's solve is
    valid: forward within 1e-5 and backward within COT_REL * max|a|.
    Inside, the port equals the reference as everywhere else."""
    out_pt, in_pt = EDGE_POINTS[edge]
    outside, inside = _edge_args(out_pt), _edge_args(in_pt)
    ref_in = rsg.segment_ref(*_ref_args(inside))
    miss_o2 = np.asarray(rsg.segment_ref(*_ref_args(outside))[1])
    assert np.abs(miss_o2).max() > 1e37                 # the reference's miss
    cots = (torch.tensor([[1.0, -0.5, 0.25]]), torch.tensor([[0.2, 0, 0.1]]),
            torch.tensor([[0.3, 0.1, -0.2]]), torch.tensor([0.7]))
    ref_g = rsg.segment_bwd_ref(*_ref_args(inside),
                                *(jnp.asarray(c.numpy()) for c in cots))
    names = ("o", "d", "w", "rows", "light_pos", "light_color", "ambience",
             "background")
    for args in (outside, inside):
        got = sg.segment_plain(*args)
        for nm, a, b in zip(("add", "o2", "d2", "w2"), got, ref_in):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5, err_msg=nm)
        got_g = sg.segment_bwd_rows_plain(*args, *cots)
        for nm, a, b in zip(names, got_g, ref_g):
            b = np.asarray(b)
            if nm == "rows":
                b = b[:, list(sg._GRAD_COLS)]
            _scaled_close(a.numpy(), b, COT_REL, f"{edge} {nm}")


def test_recorded_hit_behind_the_ray_stays_a_miss():
    """keeps_recorded_hit drops the inside test alone: a recorded
    triangle behind the ray (t <= EPS_HIT) or parallel to it is a miss,
    as in the reference."""
    p0, p1, p2 = (torch.tensor([[0.0, 0, 0]]), torch.tensor([[1.0, 0, 0]]),
                  torch.tensor([[0.0, 1, 0]]))
    o = torch.tensor([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0], [0.2, 0.2, 1.0],
                      [2.0, 2.0, 1.0]])
    d = torch.tensor([[0.0, 0, 1], [1.0, 0, 0], [0.0, 0, -1], [0.8, 0, -0.6]])
    t, _, _ = isx.ray_triangle(o, d, p0, p1, p2, recorded=True)
    t_scan, _, _ = isx.ray_triangle(o, d, p0, p1, p2)
    assert torch.equal(t[:2], torch.full((2,), isx.INF))
    assert t[2] == pytest.approx(1.0)
    assert torch.equal(t_scan[:3], t[:3])
    assert t[3] == pytest.approx(1 / 0.6) and t_scan[3] == t[0]


# --- topology, replay and the training step -------------------------------

def test_trace_topology_matches_reference(case):
    ref = r_restore_mirror_chain(case["ref"])
    port = prender.restore_mirror_chain(case["port"])
    assert port.n_segments == (3 if case["name"] == "mirror" else 1)
    o, d = case["o"], case["d"]
    want = rtr.trace_topology(ref, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()),
                              REF_CFG._replace(fused_shade=True))
    got = tr.trace_topology(port, o, d)
    for f in ("kind", "idx", "hit", "miss", "shadow"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        agree = (a == b).mean()
        assert agree >= 0.995, (f, agree)
    assert got.hit[0].any() and got.shadow.any()


@pytest.mark.parametrize("fused", [True, False])
def test_trace_shade_of_topology_equals_trace(case, fused):
    """trace_shade(trace_topology(...)) == trace(...): K5 re-solves in the
    det3 form and K3 in the N.w form, so grazing rays may differ a little;
    the bar is the render bar (>= 99.5% of rays within 1e-4)."""
    port = prender.restore_mirror_chain(case["port"])
    o, d = case["o"], case["d"]
    want = tr.trace(port, o, d).numpy()
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    got = tr.trace_shade(port, o, d, tr.trace_topology(port, o, d), cfg)
    diff = np.abs(got.detach().numpy() - want).max(axis=1)
    assert (diff <= 1e-4).mean() >= 0.995, (diff <= 1e-4).mean()
    assert (diff <= 1e-5).mean() >= 0.99


@pytest.fixture(scope="module")
def loss_grads(case):
    """The training step of the reference and of both port branches."""
    tgt = case["target"]
    r_loss, r_grads = r_loss_grad_image(case["ref"], _ref_camera(case),
                                        jnp.asarray(tgt), cfg=REF_CFG)
    port = {fused: prender.render_loss_grad_image(
        case["port"], case["cam"], torch.from_numpy(tgt),
        cfg=tr.TraceConfig(fused_shade_grad=fused))
        for fused in (True, False)}
    return (float(r_loss), {k: np.asarray(v) for k, v in r_grads.items()},
            port)


def _ref_camera(case):
    w, h = case["cam"].width, case["cam"].height
    if case["name"] == "office":
        return office("ref", tess=2, w=w, h=h).camera
    return mesh_scene("ref").camera


@pytest.mark.parametrize("fused", [True, False])
def test_loss_grad_matches_reference(case, loss_grads, fused):
    r_loss, r_grads, port = loss_grads
    loss, grads = port[fused]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), r_loss, rtol=1e-5)
    assert sorted(grads) == sorted(r_grads) and len(grads) == 23
    for k, want in r_grads.items():
        _scaled_close(grads[k].numpy(), want, GRAD_REL, k)
    # the step reaches geometry, materials, lights and the environment
    for k in ("vertex_pos", "mat_diffuse", "light_pos", "light_color",
              "ambience"):
        assert np.abs(r_grads[k]).max() > 0, k
    if case["name"] == "mirror":
        assert np.abs(r_grads["mat_mirror"]).max() > 0


def test_loss_grad_branches_agree(case, loss_grads):
    _, _, port = loss_grads
    (la, ga), (lb, gb) = port[True], port[False]
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    for k in ga:
        _scaled_close(ga[k].numpy(), gb[k].numpy(), GRAD_REL, k)


def test_tiled_loss_grad_equals_one_batch():
    """Replay tiles share one pack: the sum over tiles equals one batch."""
    port = office("port", tess=2, w=64, h=32).build(device="cpu")
    cam = office("port", tess=2, w=64, h=32).camera
    tgt = torch.full((cam.height, cam.width, 3), 0.3)
    l1, g1 = prender.render_loss_grad_image(port, cam, tgt)
    l2, g2 = prender.render_loss_grad_image(port, cam, tgt, tile=1024)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for k in g1:
        _scaled_close(g2[k].numpy(), g1[k].numpy(), GRAD_REL, k)


def test_restore_mirror_chain():
    _, port, _ = _scene_pair("mirror")
    assert port.live_depth == 1
    assert prender.restore_mirror_chain(port).n_segments == port.max_depth + 1
    flat = dataclasses.replace(port, mat_mirror=torch.zeros_like(
        port.mat_mirror))
    assert prender.restore_mirror_chain(flat) is flat


def test_render_loss_grad_flat_batch_matches_image():
    """render_loss_grad over the block-ordered rays of a whole image (no
    padding: 32x32) equals render_loss_grad_image."""
    port = office("port", tess=2, w=32, h=32).build(device="cpu")
    cam = office("port", tess=2, w=32, h=32).camera
    rng = np.random.default_rng(5)
    tgt = torch.from_numpy(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    li, gi = prender.render_loss_grad_image(port, cam, tgt)
    o, d = prender.primary_rays_blocked(cam, "cpu")
    lf, gf = prender.render_loss_grad(port, o, d,
                                      prender._to_blocks(tgt, prender.BLOCK))
    np.testing.assert_allclose(float(lf), float(li), rtol=1e-6)
    for k in gi:
        _scaled_close(gf[k].numpy(), gi[k].numpy(), 1e-6, k)
