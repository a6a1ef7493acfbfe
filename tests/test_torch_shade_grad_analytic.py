"""The fused shade segment on sphere and plane hits (K10/K11,
ops/shade_grad_ana.py) against the autograd replay and the reference.

The plain versions (CPU tensors) are held against ``tracer._replay_segment``
(``shade.resolve_hit`` + ``lighting_from_mask``, the replay of
``TraceConfig(fused_shade_grad=False)``) on the same segment, and the
training replay that takes them against the reference's
``value_and_grad``. Cases: o_04 at low resolution (2 lights, max_depth 2)
in its first two segments, the tri-less mixed scene (a mirror sphere and
plane), seeded random sphere-and-plane scenes, and hand-made rays for
each edge of the re-solve.

Tolerances:
  * forward against _replay_segment: rtol 1e-5, atol 1e-5 (test_torch_grad's
    bar for a segment's forward): the same expressions, but the replay's
    dot products are ``torch.sum`` over a last axis of 3, whose order of
    addition may differ from ``(x + y) + z``;
  * every cotangent against torch.autograd through _replay_segment:
    3e-5 * max|a| (COT_REL, test_torch_grad's bar for a segment's
    cotangents); the table cotangents are sums over the rays in another
    order;
  * a fit step's gradients against the reference's value_and_grad:
    5e-4 * max|a| and the loss within rtol 1e-5 (GRAD_REL, test_torch_grad's
    bars for the training step).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render_loss_grad_image as r_loss_grad_image)
from myraytracer_tpu.scenes import golden as rgolden

from myraytracer_tpu_torch.inverse import InverseRenderer, adam
from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad_ana as sga
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.shard_render import split_params
from myraytracer_tpu_torch.scenes import golden, kinds

from test_torch_cond import live_scene
from test_torch_render import REF_API
from test_torch_scene import mesh_scene, to_port

COT_REL = 3e-5
GRAD_REL = 5e-4
REF_CFG = rtr.TraceConfig(tri_method="brute")

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

#: the inputs of _replay_segment's leaves and of the plain versions, in
#: the order of sga.BWD_OUTPUTS
LEAVES = sga.BWD_OUTPUTS


def _scaled_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    tol = rel * max(float(np.abs(want).max()) if want.size else 0.0, 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


# --- cases: (scene, carry, record) of one segment -------------------------

def _segment_of(data, cam, s, seed):
    """Segment s of the scene's primary rays: the carry that the replay
    of segments 0..s-1 leaves (weights and cotangents seeded), and the
    record of the topology."""
    o, d = prender.primary_rays_blocked(cam, "cpu")
    topo = tr.trace_topology(data, o, d)
    geom = shade.pack_shade_geom(data)
    carry = tr.Bounce(o, d, torch.ones(o.shape[0]), torch.zeros_like(o))
    for k in range(s):
        rec = tuple(getattr(topo, f)[k] for f in TOPO_FIELDS)
        carry = tr._replay_segment(data, geom, carry, rec, tr.TraceConfig())
    rec = tuple(getattr(topo, f)[s] for f in TOPO_FIELDS)
    g = torch.Generator().manual_seed(seed)
    w = carry.weight * (0.5 + torch.rand(o.shape[0], generator=g))
    return data, (carry.o.contiguous(), carry.d.contiguous(), w), rec


TOPO_FIELDS = ("kind", "idx", "hit", "miss", "shadow")


def _o04(s):
    sc = golden.scene_04_molecule(scale=0.05, n_atoms=24)
    return _segment_of(sc.build(device="cpu"), sc.camera, s, 10 + s)


def _mixed(s):
    sc = kinds.mixed_scene(mirror=0.35, cyl=False, tris=False, w=24, h=20)
    return _segment_of(sc.build(device="cpu"), sc.camera, s, 20 + s)


def random_scene(seed: int, w: int = 24, h: int = 20) -> Scene:
    """A seeded scene of spheres and planes only: 3 to 8 spheres, 1 or 2
    planes, 1 to 3 lights, mirrors, max_depth 2."""
    rng = np.random.default_rng(seed)
    s = Scene()
    s.set_camera(eye=(0, 1.0, 6.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=w, height=h)
    for _ in range(rng.integers(1, 4)):
        s.add_light(tuple(rng.uniform(-4, 4, 3) + (0, 4, 2)),
                    tuple(rng.uniform(0.2, 0.9, 3)))
    s.ambience = tuple(rng.uniform(0.05, 0.2, 3))
    s.background = tuple(rng.uniform(0.0, 0.2, 3))
    s.max_depth = 2

    def mat():
        return Material(diffuse=tuple(rng.uniform(0.1, 0.9, 3)),
                        specular=tuple(rng.uniform(0.0, 0.6, 3)),
                        shininess=float(rng.uniform(2, 60)),
                        mirror=float(rng.choice([0.0, 0.0, 0.3, 0.6])))
    for _ in range(rng.integers(3, 9)):
        s.add_sphere(tuple(rng.uniform(-2, 2, 3) * (1, 0.5, 1)),
                     float(rng.uniform(0.2, 0.7)), mat())
    s.add_plane((0, -1, 0), (0, 1, 0), mat())
    if rng.integers(0, 2):
        n = rng.normal(size=3) + (0, 0, 3)
        s.add_plane((0, 0, -3), tuple(n / np.linalg.norm(n)), mat())
    return s


def _random(seed):
    sc = random_scene(seed)
    return _segment_of(sc.build(device="cpu"), sc.camera, seed % 2, seed)


def _edge_scene():
    """One sphere (centre 0, radius 1), the floor y = -1, two lights."""
    s = Scene()
    s.set_camera(eye=(0, 0, 6.0), center=(0, 0, 0), up=(0, 1, 0), fovy=40,
                 width=8, height=8)
    s.add_light((3, 4, 5), (0.8, 0.7, 0.6))
    s.add_light((-4, 2, 3), (0.3, 0.3, 0.4))
    s.ambience = (0.1, 0.1, 0.12)
    s.background = (0.05, 0.1, 0.2)
    s.max_depth = 2
    s.add_sphere((0, 0, 0), 1.0, Material(
        diffuse=(0.6, 0.3, 0.2), specular=(0.5,) * 3, shininess=30,
        mirror=0.25))
    s.add_plane((0, -1, 0), (0, 1, 0), Material(
        diffuse=(0.4, 0.4, 0.4), specular=(0.2,) * 3, shininess=8,
        mirror=0.5))
    return s.build(device="cpu")


#: hand-made rays (origin, direction, kind) of each edge of the re-solve;
#: every ray is a recorded live hit of its kind
EDGES = {
    # |disc| near 0 on both sides of the 1e-12 guard and just above it
    "grazing": [((-5, 1 - 1e-4, 0), (1, 0, 0), 1),
                ((-5, 1 - 3e-7, 0.0), (1, 0, 0), 1),
                ((-5, 0.9999, 0.01), (1, 0, 0), 1)],
    # t0 < 0 < t1: the far root
    "inside": [((0, 0, 0.2), (0.3, 0.1, 1), 1),
               ((0.1, -0.2, 0), (-1, 0.4, 0.2), 1)],
    # an origin on the surface: t0 = 0 <= EPS_HIT, t1 the far side
    "t0_small": [((0, 0, 1), (0, 0, -1), 1),
                 ((0, 1 + 1e-7, 0), (0.1, -1, 0), 1)],
    # d . n = 0 (and within EPS_PARALLEL) for a recorded plane hit
    "parallel": [((0, 0, 5), (1, 0, 0), 2),
                 ((0, 2, 5), (1, 1e-11, 0), 2)],
    # recorded as hits, but the re-solve misses: disc < 0, a plane behind
    "failed": [((-5, 3, 0), (1, 0, 0), 1),
               ((0, 2, 5), (0, 1, 0), 2)],
}


def _edge(name):
    data = _edge_scene()
    rays = EDGES[name]
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    kind = torch.tensor([r[2] for r in rays], dtype=torch.int32)
    R = o.shape[0]
    live = torch.ones(R, dtype=torch.bool)
    shadow = torch.arange(R) % 2 == 1
    rec = (kind, torch.zeros(R, dtype=torch.int32), live,
           torch.zeros(R, dtype=torch.bool),
           torch.stack([shadow, ~shadow]))
    return data, (o, d, torch.full((R,), 0.8)), rec


def _dead():
    """A segment in which no ray is alive: the reference's dead record."""
    data, carry, rec = _o04(1)
    R = carry[0].shape[0]
    dead = tr._dead(R, data.n_lights, "cpu")
    return data, (carry[0], carry[1], torch.zeros(R)), dead


CASES = {"o04_seg0": lambda: _o04(0), "o04_seg1": lambda: _o04(1),
         "mixed_seg0": lambda: _mixed(0), "mixed_seg1": lambda: _mixed(1),
         "random_0": lambda: _random(0), "random_1": lambda: _random(1),
         "random_2": lambda: _random(2), "dead": _dead,
         **{f"edge_{k}": (lambda k=k: _edge(k)) for k in EDGES}}


def _inputs(name):
    """(plain arguments, counts, output cotangents) of the case."""
    data, (o, d, w), rec = CASES[name]()
    geom = shade.pack_shade_geom(data)
    kind, idx, h, miss, shadow = rec
    args = (o, d, w, geom.ana16.detach(), geom.mat16.detach(),
            kind.contiguous(), idx.contiguous(), h, miss, shadow,
            data.light_pos, data.light_color, data.ambience, data.background)
    g = torch.Generator().manual_seed(len(name))
    R = o.shape[0]
    cots = (torch.randn(R, 3, generator=g), torch.randn(R, 3, generator=g),
            torch.randn(R, 3, generator=g), torch.randn(R, generator=g))
    return data, args, (data.n_spheres, data.n_planes), cots


def _replay(data, args, leaves=()):
    """tracer._replay_segment on the plain versions' arguments -> (add,
    o2, d2, w2), with the scene's analytic tensors read from ``ana16``
    (so that its gradient is ana16's) and the lights from ``args``."""
    (o, d, w, ana16, mat16, kind, idx, h, miss, shadow, lp, lc, amb,
     bg) = args
    S, P = data.n_spheres, data.n_planes
    sc = dataclasses.replace(
        data, sphere_center=ana16[:S, 0:3], sphere_radius=ana16[:S, 6],
        plane_center=ana16[S:S + P, 0:3], plane_normal=ana16[S:S + P, 3:6],
        light_pos=lp, light_color=lc, ambience=amb, background=bg)
    geom = shade.ShadeGeom(mat16.new_zeros((1, 32)), mat16, ana16)
    out = tr._replay_segment(sc, geom, tr.Bounce(o, d, w, torch.zeros_like(o)),
                             (kind, idx, h, miss, shadow), tr.TraceConfig())
    return out.color, out.o, out.d, out.weight


def _diff_args(args):
    """args with the differentiable ones (LEAVES) as fresh leaves."""
    pos = (0, 1, 2, 3, 4, 10, 11, 12, 13)
    out = list(args)
    for i in pos:
        out[i] = args[i].detach().clone().requires_grad_(True)
    return out, [out[i] for i in pos]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_matches_replay_segment(name):
    data, args, counts, _ = _inputs(name)
    got = sga.segment_ana_plain(*args, counts)
    with torch.no_grad():
        want = _replay(data, args)
    for nm, a, b in zip(("add", "o2", "d2", "w2"), got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), nm
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=nm)
    if name == "dead":
        assert not got[0].any() and not got[3].any()
        assert torch.equal(got[1], args[0]) and torch.equal(got[2], args[1])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_reverse_matches_autograd(name):
    """K11's plain version against torch.autograd through the autograd
    replay, for every cotangent, and through ShadeSegmentAna."""
    data, args, counts, cots = _inputs(name)
    got = sga.segment_ana_bwd_plain(*args, counts, *cots)
    dargs, leaves = _diff_args(args)
    out = _replay(data, dargs)
    loss = sum((x * c).sum() for x, c in zip(out, cots))
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    dargs2, leaves2 = _diff_args(args)
    out2 = sga.ShadeSegmentAna.apply(*dargs2, counts, True)
    loss2 = sum((x * c).sum() for x, c in zip(out2, cots))
    via_fn = torch.autograd.grad(loss2, leaves2)
    for nm, a, b, c in zip(LEAVES, got, want, via_fn):
        b = torch.zeros_like(a) if b is None else b
        _scaled_close(a.numpy(), b.numpy(), COT_REL, f"{nm} vs autograd")
        assert torch.equal(a, c), f"{nm}: ShadeSegmentAna's backward"
    if name == "dead":
        assert torch.equal(got[0], cots[1]) and torch.equal(got[1], cots[2])
        for g in got[2:]:
            assert not g.any()
    else:
        # the cotangents reach the tables
        assert got[3][:, :sga.ANA_COLS].abs().max() > 0
        assert got[4][:, :sga.MAT_COLS].abs().max() > 0


@pytest.mark.parametrize("name", ["o04_seg0", "random_1", "edge_grazing"])
def test_plain_rows_sum_into_the_tables(name):
    """The per-ray rows (segment_ana_bwd_rows_plain) summed into each
    hit's ana16 and mat16 rows give K11's plain tables: zero off the
    differentiable columns and on a miss, and None where ``need`` says."""
    data, args, counts, cots = _inputs(name)
    rows = sga.segment_ana_bwd_rows_plain(*args, counts, *cots)
    full = sga.segment_ana_bwd_plain(*args, counts, *cots)
    arow, mid = sga._rows(args[3], args[5], args[6], counts)
    valid = args[5] != shade.KIND_MISS
    assert not rows[3][~valid].any() and not rows[4][~valid].any()
    for g, r, i, n in ((full[3], rows[3], arow, sga.ANA_COLS),
                       (full[4], rows[4], mid, sga.MAT_COLS)):
        want = torch.zeros_like(g)
        want[:, :n].index_add_(0, i, r)
        assert torch.equal(g, want) and not g[:, n:].any()
    need = (False, True, True, False, True, False, True, False, False)
    part = sga.segment_ana_bwd(*args, counts, *cots, need=need)
    for a, b, n in zip(part, full, need):
        assert (a is None) if not n else torch.equal(a, b)
    none = sga.segment_ana_bwd_plain(*args, counts, None, None, None, None)
    assert all(not g.any() for g in none)


def test_wrapper_checks_its_inputs():
    """The wrappers' checks (run for CUDA tensors before a launch): a
    wrong dtype, shape or table width, or a scene without a light."""
    _, args, counts, cots = _inputs("o04_seg0")
    assert sga._check("t", args, cots)[1:] == (args[0].shape[0], 2)
    bad = {5: args[5].long(), 3: args[3][:, :8].contiguous(),
           9: args[9][:1].contiguous(), 0: args[0].double()}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            sga._check("t", args[:i] + (t,) + args[i + 1:], cots)
    with pytest.raises(ValueError):
        sga._check("t", args, (cots[0][:3],) + cots[1:])
    nolight = args[:9] + (args[9][:0], args[10][:0], args[11][:0]) + args[12:]
    with pytest.raises(ValueError, match="light"):
        sga._check("t", nolight)
    with pytest.raises(ValueError, match="rows"):
        sga._counts((counts[0] + 5, counts[1]), args[3], "t")


# --- routing --------------------------------------------------------------

def _route_scene(what):
    if what == "spheres_planes":
        return golden.scene_04_molecule(scale=0.05, n_atoms=24).build(
            device="cpu")
    if what == "planes":
        sc = random_scene(3)
        data = sc.build(device="cpu")
        return dataclasses.replace(
            data, sphere_center=data.sphere_center[:0],
            sphere_radius=data.sphere_radius[:0],
            sphere_mat=data.sphere_mat[:0])
    if what == "triangles":
        return mesh_scene("port").build(device="cpu")
    if what == "triangles_and_analytic":
        return kinds.mixed_scene(cyl=False, w=16, h=16).build(device="cpu")
    if what.startswith(("triangles_", "textured_")):
        # the mesh (or the textured quads) beside one analytic primitive
        sc = (kinds.textured_scene(w=16, h=16) if what.startswith("textured")
              else mesh_scene("port"))
        mat = Material(diffuse=(0.3, 0.5, 0.6))
        if what.endswith("plane"):
            sc.add_plane((0, -1, 0), (0, 1, 0), mat)
        elif what.endswith("sphere"):
            sc.add_sphere((-1.3, 0.4, 0.6), 0.45, mat)
        else:
            sc.add_cylinder((-1.3, -0.1, 0.5), (0.1, 1, 0), 0.3, 1.2, mat)
        return sc.build(device="cpu")
    if what == "cylinder":
        return kinds.mixed_scene(tris=False, w=16, h=16).build(device="cpu")
    data = _route_scene("spheres_planes")
    if what == "texture":
        return dataclasses.replace(data, has_textures=True)
    assert what == "no_light"
    return dataclasses.replace(data, light_pos=data.light_pos[:0],
                               light_color=data.light_color[:0])


#: scene -> the route with fused_shade_grad set
ROUTE_CASES = {"spheres_planes": "fused_ana", "planes": "fused_ana",
               "triangles": "fused_tri",
               "triangles_and_analytic": "fused_mixed",
               "triangles_plane": "fused_mixed",
               "triangles_sphere": "fused_mixed",
               "triangles_cylinder": "autograd",
               "textured_triangles_plane": "autograd",
               "cylinder": "autograd", "texture": "autograd",
               "no_light": "autograd"}


@pytest.mark.parametrize("what", list(ROUTE_CASES))
def test_route_by_primitive_kinds_textures_and_lights(what):
    data = _route_scene(what)
    want = ROUTE_CASES[what]
    assert tr.TraceConfig().replay_route(data) == want
    assert want in tr.ROUTES
    off = tr.TraceConfig(fused_shade_grad=False)
    assert off.replay_route(data) == "autograd"


#: the scenes of the route test: o_04 (spheres and planes, 3 segments),
#: test_torch_cond's triangle-only mirror scene (3 segments) and its
#: mirror sphere, plane and mesh (3 segments), each with its route's
#: tallies
ROUTE_TALLY_SCENES = {
    "molecule": lambda: golden.scene_04_molecule(scale=0.05, n_atoms=24),
    "triangles": lambda: live_scene("fused", "port"),
    "mixed": lambda: live_scene("analytic", "port")}
#: each scene's route with fused_shade_grad, and the tallies it adds to
ROUTE_TALLIES = {"molecule": ("fused_ana", ("fused_ana",)),
                 "triangles": ("fused_tri", ("fused_tri",)),
                 "mixed": ("fused_mixed", ("fused_tri", "fused_ana"))}


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("scene", list(ROUTE_TALLY_SCENES))
def test_trace_shade_takes_the_route_and_tallies_it(monkeypatch, scene,
                                                    fused, checkpoint):
    """trace_shade runs each segment through its route's step (segment 0
    directly, the others as conditional segments): o_04 through K10/K11,
    a triangle-only scene through K5/K6 and a mixed one through both, or
    each through the autograd replay under fused_shade_grad=False; it
    counts each segment in graphs.TALLIES by route (the mixed route in
    both fused routes' tallies), and gives the same colours either
    way."""
    calls = []
    for nm, route in tr.ROUTES.items():
        monkeypatch.setitem(tr.ROUTES, nm, route._replace(
            step=lambda *a, _f=route.step, _n=nm: (calls.append(_n),
                                                   _f(*a))[1]))
    sc = ROUTE_TALLY_SCENES[scene]()
    data = sc.build(device="cpu")
    o, d = prender.primary_rays_blocked(sc.camera, "cpu")
    topo = tr.trace_topology(data, o, d)
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    before = dict(graphs.TALLIES)
    c = tr.trace_shade(data, o, d, topo, cfg, checkpoint=checkpoint)
    route, tallies = (ROUTE_TALLIES[scene] if fused
                      else ("autograd", ("autograd",)))
    moved = {k: v - before.get(k, 0) for k, v in graphs.TALLIES.items()
             if v != before.get(k, 0)}
    assert moved == {f"replay.{t}": data.n_segments for t in tallies}
    assert calls and set(calls) == {route}
    ref = tr.trace(data, o, d)
    np.testing.assert_allclose(c.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# --- against the reference --------------------------------------------------

def _port_camera(rcam) -> Camera:
    return Camera.make(np.array(rcam.eye), np.array(rcam.center),
                       np.array(rcam.up), float(rcam.fovy), rcam.width,
                       rcam.height)


def _graze_free(port, cam):
    """No primary ray grazes the sphere it hits (tests/test_torch_diff_graphs:
    there the two packages' roundings part)."""
    xs, ys = cam.pixel_grid("cpu")
    o, d = cam.primary_rays(xs.reshape(-1), ys.reshape(-1))
    topo = tr.trace_topology(port, o, d)
    i = topo.idx[0].long()
    oc = o - port.sphere_center[i]
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - port.sphere_radius[i] ** 2)
    graze = (topo.kind[0] == shade.KIND_SPHERE) & (disc < 1e-4 * b * b)
    return not bool(graze.any())


#: the reference scene, the leaves fitted, and the entry point
REF_CASES = {
    "molecule_fit_pixels": ("molecule", ("mat_diffuse", "light_color"),
                            "fit"),
    "molecule_fit_pixels_all": ("molecule", None, "fit"),
    "mixed_loss_grad": ("mixed", None, "loss_grad"),
}


@pytest.mark.parametrize("what", list(REF_CASES))
def test_training_replay_matches_reference_value_and_grad(what):
    """InverseRenderer.fit_pixels' first gradient on a small molecule
    (the fit cell's leaves, and every leaf), and render_loss_grad_image
    on the tri-less mixed scene with mirrors, both through K10/K11's
    plain versions, against the reference's value_and_grad."""
    scene, leaves, entry = REF_CASES[what]
    if scene == "molecule":
        # 15x15 with 40 atoms: no ray of any segment grazes a sphere.
        # Grazing rays are ill-conditioned in both packages (as in
        # test_torch_diff_graphs): at 22x22 with 16 atoms one moves a
        # sphere_radius entry by 7.9e-4 x max|g| on the autograd replay
        # and on K10/K11 alike.
        rs = rgolden.scene_04_molecule(scale=0.03, n_atoms=40)
    else:
        rs = kinds.mixed_scene(mirror=0.35, cyl=False, tris=False, w=24,
                               h=20, api=REF_API)
    ref, rcam = rs.build(), rs.camera
    port, cam = to_port(ref), _port_camera(rcam)
    assert tr.TraceConfig().replay_route(port) == "fused_ana"
    assert _graze_free(port, cam)
    tgt = np.random.default_rng(len(what)).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    r_loss, r_grads = r_loss_grad_image(ref, rcam, jnp.asarray(tgt),
                                        cfg=REF_CFG)
    if entry == "fit":
        inv = InverseRenderer(port, param_names=leaves or tuple(
            split_params(port)), optimizer=adam(1e-3), camera=cam)
        xs, ys = cam.pixel_grid("cpu")
        res = inv.fit_pixels(xs.reshape(-1), ys.reshape(-1),
                             torch.from_numpy(tgt.reshape(-1, 3)), steps=1)
        n = 3.0 * cam.width * cam.height
        loss = res.losses[0] * n
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad) * n
                 for k, p in inv.params.items()}
    else:
        loss, grads = prender.render_loss_grad_image(
            port, cam, torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert set(grads) <= set(r_grads)
    for k, got in grads.items():
        want = np.asarray(r_grads[k])
        tol = GRAD_REL * max(float(np.abs(want).max()) if want.size else 0.0,
                             1e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=k)
    assert np.abs(np.asarray(r_grads["mat_diffuse"])).max() > 0


# --- the route tally's reader (rtbench/metrics/replay.fused_share.fit.py) ---

def _fused_share_reader():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "rtbench", "metrics",
        "replay.fused_share.fit.py")
    spec = importlib.util.spec_from_file_location("fused_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: each graph's route tallies -> the share the reader gives (None: none)
SHARE_CASES = {
    "analytic": ({"fit_step": {"replay.fused_ana": 3}}, 100.0),
    "triangles": ({"fit_step": {"replay.fused_tri": 1}}, 100.0),
    "mixed": ({"fit_step": {"replay.fused_ana": 1, "replay.autograd": 3}},
              25.0),
    "no_segment": ({"fit_step": {}}, None),
    "older_program": (None, None),
}


@pytest.mark.parametrize("what", list(SHARE_CASES))
def test_fused_share_reads_the_route_tallies(monkeypatch, what):
    """The reader sums ``graphs.tallies(entry)`` over the stretch's
    ``mrt.graphs.launch <entry>`` spans (two replays here, and one launch
    span outside the window); a program without tallies, or a stretch
    that replays no segment, reads nothing."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from rtbench import trace as rtrace

    held, want = SHARE_CASES[what]
    if held is None:
        monkeypatch.delattr(graphs, "tallies")
    else:
        monkeypatch.setattr(graphs, "tallies",
                            lambda label: dict(held.get(label, {})))
    host = [(rtrace.WINDOW, 0.0, 1000.0),
            ("mrt.fit.step", 0.0, 300.0), ("mrt.fit.step", 400.0, 700.0),
            ("mrt.graphs.launch fit_step", 100.0, 150.0),
            ("mrt.graphs.launch fit_step", 500.0, 530.0),
            ("mrt.graphs.launch fit_step", 1500.0, 1530.0)]
    got = _fused_share_reader().read(None, {}, rtrace.make([], host), {})
    assert got == want
