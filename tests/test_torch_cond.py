"""The captured segment branch (ops/tracer._branch), on the CPU.

Under a graph capture, segments 1.. of ``trace`` and ``trace_topology``
run inside a CUDA-graph IF node on ``(weight > 0).any()`` (the
reference's ``lax.cond``) and write the carry, and the topology's record,
in place. The card makes the node (ops/graphs.if_node). Here a stand-in
for it runs the body only where the condition holds, with
``graphs.capturing`` (``torch.cuda.is_current_stream_capturing`` on a
CUDA device) patched to true, so that:

  (a) the colours of ``trace`` and every field of ``trace_topology``'s
      records equal the select path's bit for bit, and the records equal
      the reference's (``myraytracer_tpu.ops.tracer`` on the CPU) where
      test_torch_graphs compares them, on a scene whose last two segments
      are dead and on a tiled frame in which some tiles die and others
      live (the reference maps ``lax.cond`` over its tiles);
  (b) a body forced to skip leaves the carry as segment 0 left it and
      records exactly the reference's ``dead``;
  (c) the buffers that the bodies write never alias the caller's rays,
      which stay unchanged;
  (d) the branch makes no host read, apart from the stand-in's own read
      of the condition, outside the watched region;
  (e) a capture that cannot make the node raises GraphCaptureError naming
      the segment, and never runs the body unconditionally.
"""

import collections
import contextlib
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import FLAT as RFLAT
from myraytracer_tpu.models.mesh import PHONG as RPHONG
from myraytracer_tpu.models.mesh import TriangleMesh as RMesh
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render_loss_grad_image as r_loss_grad_image)
from myraytracer_tpu.parallel.shard_render import (
    split_params as r_split_params)
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.inverse import InverseRenderer
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops import shade_grad_ana as sga
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.shard_render import split_params
from myraytracer_tpu_torch.scenes import kinds
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

from test_torch_graphs import (GRAD_REL, PLAIN, REF_CFG, NoHostRead,
                               _unwatched)
from test_torch_graphs import regions  # noqa: F401  (a fixture)
from test_torch_graphs import dead_scene
from test_torch_scene import to_port

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

METHODS = ("cluster", "auto")
TOPO_FIELDS = ("kind", "idx", "hit", "miss", "shadow")


@contextlib.contextmanager
def branching(skip: bool = False):
    """Segments 1.. take tracer._branch as under a capture; graphs.if_node
    is a stand-in that runs the body where the condition holds (never,
    with ``skip``). Yields the (site, condition) pairs it saw."""
    seen = []

    def stand_in(pred, body, site):
        with _disable_current_modes():
            took = bool(pred.item())
        seen.append((site, took))
        if took and not skip:
            body()

    with mock.patch.object(graphs, "capturing", lambda device: True), \
            mock.patch.object(graphs, "if_node", stand_in):
        yield seen


def tiles_scene(pkg: str, w: int = 64, h: int = 64, floor: str = "plane"):
    """A mirror floor below the horizon and a mirror mesh sphere on it at
    the left, max_depth 3, 64x64 (four 32x32 screen blocks). Traced in
    tiles of one block: the top right block sees only the sky, so its
    segments 1.. are dead; the other blocks live through segment 1, and
    the bottom left one, where the sphere and the floor reflect each
    other, through segment 3. ``floor="mesh"`` makes the floor a
    two-triangle quad: a triangle-only scene, which trains through the
    fused K5/K6 segment."""
    if pkg == "ref":
        S, Mat, Mesh, flat, sphere = (RScene, RMaterial, RMesh, RFLAT,
                                      r_uv_sphere)
    else:
        S, Mat, Mesh, flat, sphere = (Scene, Material, TriangleMesh, FLAT,
                                      uv_sphere)
    s = S()
    s.set_camera(eye=(0, 0, 5), center=(0, 0, 0), up=(0, 1, 0), fovy=40,
                 width=w, height=h)
    s.add_light((3, 3, 3), (0.9, 0.85, 0.8))
    s.ambience = (0.1, 0.1, 0.12)
    s.background = (0.05, 0.1, 0.2)
    s.max_depth = 3
    floor_mat = Mat(ambient=(0.1, 0.1, 0.1), diffuse=(0.3, 0.4, 0.3),
                    mirror=0.5)
    if floor == "plane":
        s.add_plane((0, -0.4, 0), (0, 1, 0), floor_mat)
    else:
        s.add_mesh(Mesh(np.float32([[-4, -0.4, -4], [4, -0.4, -4],
                                    [4, -0.4, 4], [-4, -0.4, 4]]),
                        np.int32([[0, 2, 1], [0, 3, 2]]), material=floor_mat,
                        draw_mode=flat))
    v, f = sphere(0.4, 8, 12)
    v = np.asarray(v) + np.array([-0.8, 0.0, 0.0])
    s.add_mesh(Mesh(v, f, material=Mat(
        ambient=(0.1, 0.1, 0.1), diffuse=(0.5, 0.3, 0.2),
        specular=(0.4, 0.4, 0.4), shininess=20, mirror=0.6), draw_mode=flat))
    return s


def _scene_case(build):
    ref = build("ref").build()
    port = to_port(ref)
    cam = build("port").camera
    o, d = prender.primary_rays_blocked(cam, "cpu")
    return dict(ref=ref, port=port, cam=cam, o=o, d=d,
                ro=jnp.asarray(o.numpy()), rd=jnp.asarray(d.numpy()))


@pytest.fixture(scope="module")
def dead():
    return _scene_case(dead_scene)


@pytest.fixture(scope="module")
def tiles():
    return _scene_case(tiles_scene)


def _topo_equal(a: tr.TraceTopo, b: tr.TraceTopo) -> None:
    for f in TOPO_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _topo_matches_reference(got: tr.TraceTopo, case, skipped):
    """test_torch_graphs' bar: >= 99.5% of each field equal; the records
    of the skipped segments, (segment, ray slice) pairs, equal to the
    bit."""
    want = rtr.trace_topology(case["ref"], case["ro"], case["rd"],
                              REF_CFG._replace(fused_shade=True))
    for f in TOPO_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        assert (a == b).mean() >= 0.995, f
        for seg, rays in skipped:
            np.testing.assert_array_equal(a[seg][..., rays], b[seg][..., rays],
                                          err_msg=f"{f} segment {seg}")


# --- (a) the branch against the select path and the reference -------------

@pytest.mark.parametrize("method", METHODS)
def test_branch_trace_equals_select_bit_for_bit(dead, method):
    cfg = tr.TraceConfig(tri_method=method)
    want = tr.trace(dead["port"], dead["o"], dead["d"], cfg)
    with branching() as seen:
        got = tr.trace(dead["port"], dead["o"], dead["d"], cfg)
    assert torch.equal(got, want)
    assert seen == [("segment 1 of trace", True),
                    ("segment 2 of trace", False),
                    ("segment 3 of trace", False)]


@pytest.mark.parametrize("method", METHODS)
def test_branch_topology_equals_select_and_reference(dead, method):
    cfg = tr.TraceConfig(tri_method=method)
    want = tr.trace_topology(dead["port"], dead["o"], dead["d"], cfg)
    with branching() as seen:
        got = tr.trace_topology(dead["port"], dead["o"], dead["d"], cfg)
    _topo_equal(got, want)
    assert [took for _, took in seen] == [True, False, False]
    _topo_matches_reference(got, dead, [(2, slice(None)), (3, slice(None))])


def test_tiles_die_apart_and_match_select_and_reference(tiles):
    """Tiles of one screen block: a segment skips in the sky's tile while
    it runs in the others; colours and records equal the select path's
    per tile, and the reference's on the whole frame."""
    port, o, d = tiles["port"], tiles["o"], tiles["d"]
    assert port.n_segments == 4 and o.shape[0] == 4 * 1024
    cfg = tr.TraceConfig()
    want = prender._trace_tiled(port, o, d, cfg, 1024, quantum=1024)
    with branching() as seen:
        got = prender._trace_tiled(port, o, d, cfg, 1024, quantum=1024)
    assert torch.equal(got, want)
    took = {}
    for site, t in seen:
        took.setdefault(site, []).append(t)
    assert took == {"segment 1 of trace": [True, False, True, True],
                    "segment 2 of trace": [False, False, True, False],
                    "segment 3 of trace": [False, False, True, False]}
    ref = np.asarray(rtr.trace(tiles["ref"], tiles["ro"], tiles["rd"],
                               REF_CFG))
    diff = np.abs(got.numpy() - ref).max(axis=1)
    assert (diff <= 1e-4).mean() >= 0.995

    parts, skipped = [], []
    for i in range(4):
        sl = slice(i * 1024, (i + 1) * 1024)
        sel = tr.trace_topology(port, o[sl], d[sl], cfg)
        with branching() as seen:
            br = tr.trace_topology(port, o[sl], d[sl], cfg)
        _topo_equal(br, sel)
        parts.append(br)
        skipped += [(s, sl) for s, (_, t) in enumerate(seen, 1) if not t]
    assert len(skipped) == 7
    whole = tr.TraceTopo(*(torch.cat([getattr(p, f) for p in parts], dim=-1)
                           for f in TOPO_FIELDS))
    _topo_matches_reference(whole, tiles, skipped)


@pytest.mark.parametrize("entry", ["render", "render_aa", "loss_grad"])
def test_entry_points_through_the_branch_equal_select(tiles, entry):
    """The tiled entry points (the AA refine, the training step's
    topology per tile) give the select path's results to the bit."""
    port, cam = tiles["port"], tiles["cam"]
    tgt = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32))
    fn = {"render": lambda: prender.render(port, cam, tile=1024),
          "render_aa": lambda: prender.render_aa(port, cam, tile=1024,
                                                 budget_frac=0.1),
          "loss_grad": lambda: prender.render_loss_grad_image(
              port, cam, tgt, tile=1024)}[entry]
    want = fn()
    with branching() as seen:
        got = fn()
    assert any(t for _, t in seen) and not all(t for _, t in seen)
    if entry == "loss_grad":
        assert torch.equal(got[0], want[0]) and sorted(got[1]) == sorted(
            want[1])
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
    else:
        assert torch.equal(got, want)


# --- (b) a skipped body -----------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_skipped_body_keeps_the_carry_and_records_dead(dead, method):
    port, o, d = dead["port"], dead["o"], dead["d"]
    cfg = tr.TraceConfig(tri_method=method)
    R = o.shape[0]
    first, rec0 = tr.segment_step(
        port, tr.pack_trace(port, cfg),
        tr.Bounce(o, d, torch.ones(R), torch.zeros((R, 3))), cfg)
    with branching(skip=True) as seen:
        color = tr.trace(port, o, d, cfg)
        topo = tr.trace_topology(port, o, d, cfg)
    assert len(seen) == 6
    assert torch.equal(color, first.color)
    for f, want in zip(TOPO_FIELDS, rec0):
        assert torch.equal(getattr(topo, f)[0], want), f
    assert (topo.kind[1:] == shade.KIND_MISS).all()
    assert topo.kind.dtype == torch.int32 and topo.idx.dtype == torch.int32
    assert not topo.idx[1:].any()
    for f in ("hit", "miss", "shadow"):
        assert getattr(topo, f).dtype == torch.bool
        assert not getattr(topo, f)[1:].any(), f


@pytest.mark.parametrize("method", METHODS)
def test_segment_step_without_the_record_gives_the_same_bounce(dead,
                                                               method):
    """trace's segments form no record: segment_step(record=False) gives
    the recording step's Bounce to the bit on each segment of the dead
    scene, returns () for the record, and dispatches exactly the
    record's four ops fewer (its idx ``where``, ``~``, ``&``, ``> 0``)."""
    port, o, d = dead["port"], dead["o"], dead["d"]
    cfg = tr.TraceConfig(tri_method=method)
    pack = tr.pack_trace(port, cfg)
    R = o.shape[0]
    carry = tr.Bounce(o, d, torch.ones(R), torch.zeros((R, 3)))
    for s in range(port.n_segments):
        with OpNames() as full:
            nxt, rec = tr.segment_step(port, pack, carry, cfg, s)
        with OpNames() as bare:
            got, none = tr.segment_step(port, pack, carry, cfg, s,
                                        record=False)
        assert len(rec) == 5 and none == ()
        for a, b in zip(got, nxt):
            assert a.dtype == b.dtype and torch.equal(a, b), s
        assert full.names - bare.names == collections.Counter(
            ["where.self", "bitwise_not.default", "bitwise_and.Tensor",
             "gt.Scalar"])
        assert not bare.names - full.names
        carry = nxt


class OpNames(TorchDispatchMode):
    """Counts the ATen ops dispatched under it, by name."""

    def __enter__(self):
        self.names = collections.Counter()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[func.__name__] += 1
        return func(*args, **(kwargs or {}))


# --- (c) the buffers --------------------------------------------------------

def test_branch_buffers_never_alias_the_rays(dead, monkeypatch):
    port, o, d = dead["port"], dead["o"], dead["d"]
    o0, d0 = o.clone(), d.clone()
    written = []
    branch = tr._branch

    def record(pred, body, bufs, site):
        written.append(tuple(bufs))
        return branch(pred, body, bufs, site)

    monkeypatch.setattr(tr, "_branch", record)
    with branching():
        tr.trace(port, o, d)
        tr.trace_topology(port, o, d)
    assert len(written) == 6
    rays = {o.untyped_storage().data_ptr(), d.untyped_storage().data_ptr()}
    for bufs in written:
        assert len(bufs) in (4, 9)
        for b in bufs:
            assert b.untyped_storage().data_ptr() not in rays
    assert torch.equal(o, o0) and torch.equal(d, d0)


# --- (d) no host read -------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_branch_makes_no_host_read(dead, monkeypatch, method):
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, _unwatched(getattr(mod, name)))
    cfg = tr.TraceConfig(tri_method=method)
    with branching() as seen:
        with NoHostRead():
            color = tr.trace(dead["port"], dead["o"], dead["d"], cfg)
            topo = tr.trace_topology(dead["port"], dead["o"], dead["d"], cfg)
    assert len(seen) == 6
    assert bool(torch.isfinite(color).all()) and topo.kind.shape[0] == 4


# --- (e) no node, no branch -------------------------------------------------

@pytest.mark.parametrize("entry", ["trace", "trace_topology"])
def test_capture_without_an_if_node_raises_naming_the_segment(dead, entry):
    """Capturing (patched) outside graphs.run: no pool to branch in."""
    fn = getattr(tr, entry)
    with mock.patch.object(graphs, "capturing", lambda device: True):
        with pytest.raises(graphs.GraphCaptureError,
                           match=f"segment 1 of {entry}: an IF node"):
            fn(dead["port"], dead["o"], dead["d"])


def test_if_node_refuses_a_condition_off_the_card(monkeypatch):
    ran = []
    monkeypatch.setattr(graphs, "_RECORDING",
                        graphs._Recording(torch.device("cuda", 0)))
    with pytest.raises(graphs.GraphCaptureError,
                       match="segment 2 of trace: an IF node's condition "
                             "is a 0-d bool tensor on the card"):
        graphs.if_node(torch.tensor(True), lambda: ran.append(1),
                       "segment 2 of trace")
    assert not ran and not graphs._RECORDING.bodies


def test_failure_site_keeps_the_segment_of_an_if_node_error():
    """A capture that fails inside an IF node fails again when it ends;
    the capture's error names the segment and the line inside it."""
    def body():
        raise RuntimeError("operation not permitted when stream is capturing")

    try:
        try:
            try:
                body()
            except RuntimeError as e:
                raise graphs.GraphCaptureError(
                    f"segment 3 of trace_topology: {graphs._failure_site(e)}"
                ) from e
        except graphs.GraphCaptureError:
            raise RuntimeError("the capture ended with an error")
    except RuntimeError as e:
        site = graphs._failure_site(e)
    assert "segment 3 of trace_topology" in site
    assert "test_torch_cond.py" in site and "in body" in site


# --- trace_shade's conditional segments (tracer._CondSegment) --------------
#
# Segments 1.. of the differentiable replay run their forward and their
# backward each under an IF node on (hit | miss).any(), "segment s of
# trace_shade" and "segment s of trace_shade (backward)": the
# reference's lax.cond, whose VJP is a cond too.

#: the InverseRenderer leaves of the fit-step cases
FIT_PARAMS = ("mat_diffuse", "mat_mirror", "light_pos", "light_color",
              "vertex_pos", "background")


@pytest.fixture(scope="module")
def tiles_tri():
    return _scene_case(lambda pkg: tiles_scene(pkg, floor="mesh"))


#: (scene fixture, fused_shade_grad) of the branch-against-select cases:
#: the plane of "tiles" sends it through K5/K6 beside K10/K11
#: ("fused_mixed") or the autograd replay
SHADE_CASES = [("dead", True), ("dead", False), ("tiles", True),
               ("tiles", False), ("tiles_tri", True), ("tiles_tri", False)]


def _shade_case(request, name, fused):
    case = request.getfixturevalue(name)
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    assert (cfg.replay_route(case["port"]) != "autograd") == fused
    return case, cfg


def _loss_grad(case, cfg, tile=None):
    cam = case["cam"]
    tgt = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32))
    return prender.render_loss_grad_image(case["port"], cam, tgt, cfg, tile)


def _fit_step(case, cfg, rays=slice(None)):
    """One InverseRenderer step on the frame's ``rays``: (loss, each
    leaf's gradient, each leaf after the Adam step)."""
    o, d = case["o"][rays], case["d"][rays]
    tgt = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, tuple(o.shape)).astype(np.float32))
    inv = InverseRenderer(case["port"], FIT_PARAMS, cfg=cfg)
    loss = inv.fit(o, d, tgt, steps=1).losses[0]
    return loss, {k: p.grad.clone() for k, p in inv.params.items()}, {
        k: p.detach().clone() for k, p in inv.params.items()}


def _shade_sites(seen):
    return [(site, took) for site, took in seen if "trace_shade" in site]


@pytest.mark.parametrize("name,fused", SHADE_CASES)
@pytest.mark.parametrize("entry", ["loss_grad", "fit"])
def test_trace_shade_through_the_branch_equals_select(request, name, fused,
                                                      entry):
    """(a) The training step (in tiles of one screen block on "tiles",
    which die apart) and an InverseRenderer step (on "tiles", the rays of
    the top two blocks: the sky's and one that lives through segment 1)
    give the select path's loss and gradients, and the step's
    parameters, to the bit."""
    case, cfg = _shade_case(request, name, fused)
    tiles = name.startswith("tiles")
    fn = ((lambda: _loss_grad(case, cfg, 1024 if tiles else None))
          if entry == "loss_grad" else
          (lambda: _fit_step(case, cfg, slice(0, 2048 if tiles else None))))
    want = fn()
    with branching() as seen:
        got = fn()
    took = [t for _, t in _shade_sites(seen)]
    assert any(took) and not all(took)
    assert float(got[0]) == float(want[0])
    for g, w in zip(got[1:], want[1:]):
        assert list(g) == list(w)
        for k in w:
            assert torch.isfinite(g[k]).all() and torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("fused", [True, False])
def test_trace_shade_sites_and_conditions(dead, fused):
    """(b) The stand-in sees each segment's forward, then the backwards in
    reverse, with the segment's condition: 1 live, 2 and 3 dead."""
    with branching() as seen:
        _loss_grad(dead, tr.TraceConfig(fused_shade_grad=fused))
    site = "segment {} of trace_shade"
    assert _shade_sites(seen) == (
        [(site.format(s), s == 1) for s in (1, 2, 3)]
        + [(site.format(s) + " (backward)", s == 1) for s in (3, 2, 1)])


def _segment_inputs(case, fused: bool, s: int = 1):
    """A conditional segment of the dead scene's replay, its condition and
    its inputs (leaves that require a gradient): segment s's record, the
    carry segment 0 leaves, the scene tensors the segment reads."""
    port, o, d = case["port"], case["o"], case["d"]
    topo = tr.trace_topology(port, o, d)
    rec = tuple(getattr(topo, f)[s] for f in TOPO_FIELDS)
    geom = shade.pack_shade_geom(port)
    cfg = tr.TraceConfig()
    seg, tensors = tr._cond_segment(
        tr.ROUTES["fused_tri" if fused else "autograd"], port, geom, rec,
        cfg, f"segment {s} of trace_shade", keep=fused)
    first = tr._replay_segment(port, geom, tr.Bounce(
        o, d, torch.ones(o.shape[0]), torch.zeros_like(o)), tuple(
            getattr(topo, f)[0] for f in TOPO_FIELDS), cfg)
    inputs = [t.detach().clone().requires_grad_(True)
              for t in (*first, *tensors)]
    return seg, (rec[2] | rec[3]).any(), inputs


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("keep", [False, True])
def test_skipped_segment_passes_the_dead_cotangents(dead, fused, keep):
    """(c) A body forced to skip: the outputs are the carry and the
    cotangents a dead segment's, the carry's output cotangents unchanged
    and zeros for every scene tensor, to the bit. Run, the same segment
    gives the select path's outputs and cotangents to the bit."""
    seg, pred, inputs = _segment_inputs(dead, fused)
    seg = dataclasses.replace(seg, keep=keep)
    assert bool(pred)
    rng = np.random.default_rng(11)
    want = tr._CondSegment.apply(seg, pred, *inputs)
    cots = [torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(
        np.float32)) for y in want]
    want_g = torch.autograd.grad(want, inputs, cots)
    for skip in (True, False):
        with branching(skip=skip) as seen:
            out = tr._CondSegment.apply(seg, pred, *inputs)
            grads = torch.autograd.grad(out, inputs, cots)
        assert seen == [("segment 1 of trace_shade", True),
                        ("segment 1 of trace_shade (backward)", True)]
        if not skip:
            assert all(torch.equal(a, b) for a, b in zip(out, want))
            assert all(torch.equal(a, b) for a, b in zip(grads, want_g))
            continue
        for y, x in zip(out, inputs[:4]):
            assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        for g, c in zip(grads[:4], cots):
            assert torch.equal(g, c)
        for g, x in zip(grads[4:], inputs[4:]):
            assert g.shape == x.shape and not g.any()


#: a scene of each route's kinds (segment 1 live in each)
ROUTE_SCENES = {
    "fused_tri": lambda: live_scene("fused", "port"),
    "fused_ana": lambda: kinds.mixed_scene(mirror=0.4, cyl=False, tris=False,
                                           w=16, h=12),
    "fused_mixed": lambda: kinds.mixed_scene(mirror=0.4, cyl=False, w=16,
                                             h=12),
    "autograd": lambda: kinds.mixed_scene(mirror=0.4, w=16, h=12)}


@pytest.mark.parametrize("route", list(tr.ROUTES))
def test_segment_inputs_hold_every_tensor_the_replay_reads(route):
    """A tensor a route's step only closed over would lose its gradient:
    with every float scene tensor but the route's fields, and every
    ShadeGeom row but its rows, cut from the graph, the route's step on
    segment 1 of a scene of its kinds (the autograd replay's with every
    kind and textures, bilinear; each on the rows its ``geom`` makes)
    reaches no input, and its conditional segment's tensors are exactly
    its rows and fields."""
    ref = ROUTE_SCENES[route]()
    port = ref.build(device="cpu")
    cfg = tr.TraceConfig(texture_filter="bilinear")
    assert cfg.replay_route(port) == route
    o, d = prender.primary_rays_blocked(ref.camera, "cpu")
    topo = tr.trace_topology(port, o, d)
    rec = tuple(getattr(topo, f)[1] for f in TOPO_FIELDS)
    assert bool((rec[2] | rec[3]).any())
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in split_params(port).items()}
    scene = dataclasses.replace(port, **leaves)
    spec = tr.ROUTES[route]
    geom = spec.geom(scene, shade.pack_shade_geom(scene), cfg)
    cut_geom = geom._replace(**{r: getattr(geom, r).detach()
                                for r in spec.rows})
    cut = dataclasses.replace(scene, **{f: getattr(port, f)
                                        for f in spec.fields})
    carry = tr.Bounce(o, d, torch.ones(o.shape[0]), torch.zeros_like(o))
    out = spec.step(cut, cut_geom, carry, rec, cfg)
    assert not any(y.requires_grad for y in out)
    seg, tensors = tr._cond_segment(spec, scene, geom, rec, cfg, "s", False)
    want = [getattr(geom, r) for r in spec.rows] + [leaves[f]
                                                    for f in spec.fields]
    assert len(tensors) == len(want)
    assert all(t is w for t, w in zip(tensors, want))


@pytest.mark.parametrize("fused", [True, False])
def test_trace_shade_bodies_make_no_host_read(dead, regions, fused):
    """(d) Neither body of any segment reads the host: the training step
    and a fit step, each region that graphs.run would capture under
    NoHostRead (test_torch_graphs' ``regions``), the stand-in's own read
    of the condition apart."""
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    inv = InverseRenderer(dead["port"], FIT_PARAMS, cfg=cfg)
    inv.optimizer.step = _unwatched(inv.optimizer.step)
    o, d = dead["o"], dead["d"]
    with branching() as seen:
        loss, grads = _loss_grad(dead, cfg)
        fit = inv.fit(o, d, torch.zeros_like(o), steps=1)
    assert regions == ["render_loss_grad_image", "fit_step"]
    assert len(_shade_sites(seen)) == 12
    assert bool(torch.isfinite(loss)) and np.isfinite(fit.losses).all()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_failing_if_node_in_the_backward_raises_naming_the_segment(dead):
    """(e) The forward's nodes are made, the backward's first node fails:
    GraphCaptureError names the backward's segment, and no backward body
    ran."""
    ran = []
    if_node = graphs.if_node

    def stand_in(pred, body, site):
        if site.endswith("(backward)"):
            if_node(pred, lambda: ran.append(site), site)
        elif bool(pred.item()):
            body()

    with mock.patch.object(graphs, "capturing", lambda device: True), \
            mock.patch.object(tr.graphs, "if_node", stand_in):
        with pytest.raises(graphs.GraphCaptureError,
                           match=r"segment 3 of trace_shade \(backward\): an "
                                 r"IF node is captured only inside"):
            _loss_grad(dead, tr.TraceConfig())
    assert not ran


def test_backward_off_the_capturing_stream_raises(dead):
    """A forward captured under IF nodes whose backward runs where no
    capture is on (an autograd thread on another stream) raises, naming
    the segment's backward, and runs no body unconditionally."""
    capturing = [True]
    seg, pred, inputs = _segment_inputs(dead, False)
    with branching() as seen, mock.patch.object(
            graphs, "capturing", lambda device: capturing[0]):
        out = tr._CondSegment.apply(seg, pred, *inputs)
        capturing[0] = False
        with pytest.raises(graphs.GraphCaptureError,
                           match=r"segment 1 of trace_shade \(backward\): "
                                 r"the backward runs off the capturing"):
            torch.autograd.grad(out[3].sum(), inputs[3])
    assert seen == [("segment 1 of trace_shade", True)]


# --- a live later segment: parity with the reference and work per step -----

def live_scene(what: str, pkg: str):
    """A small scene whose segment 1 is live: "analytic", mirror sphere,
    plane and mesh reflecting each other; "texture", the textured quads
    over a mirror plane; "fused", a mirror mesh sphere over a mirror
    two-triangle floor (triangle-only: the fused K5/K6 segment)."""
    api = kinds.PORT_API if pkg == "port" else (
        RScene, RMaterial, RMesh, RPHONG, RFLAT, r_uv_sphere)
    if what == "analytic":
        return kinds.mixed_scene(mirror=0.4, cyl=False, w=24, h=20, api=api)
    if what == "texture":
        s = kinds.textured_scene(w=24, h=20, api=api)
        s.add_plane((0, -0.9, 0), (0, 1, 0), api[1](
            diffuse=(0.4, 0.4, 0.4), mirror=0.5))
        s.max_depth = 2
        return s
    s = tiles_scene(pkg, w=24, h=20, floor="mesh")
    s.max_depth = 2
    return s


#: which kinds segment 1 must hit in each live scene
LIVE_KINDS = {"analytic": (shade.KIND_SPHERE, shade.KIND_PLANE,
                           shade.KIND_TRI),
              "texture": (shade.KIND_TRI,), "fused": (shade.KIND_TRI,)}


def _count_calls(monkeypatch, mod, names, counts=None):
    """Count the calls of ``mod``'s functions ``names`` (in ``counts``
    where given)."""
    counts = {} if counts is None else counts
    for name in names:
        counts[name] = 0
        fn = getattr(mod, name)

        def counted(*a, _f=fn, _n=name):
            counts[_n] += 1
            return _f(*a)
        monkeypatch.setattr(mod, name, counted)
    return counts


def _count_step(monkeypatch, route: str):
    """Counts the calls of ``tracer.ROUTES[route]``'s step by its name."""
    spec = tr.ROUTES[route]
    counts = {spec.step.__name__: 0}

    def counted(*a):
        counts[spec.step.__name__] += 1
        return spec.step(*a)
    monkeypatch.setitem(tr.ROUTES, route, spec._replace(step=counted))
    return counts


@pytest.mark.parametrize("what", list(LIVE_KINDS))
def test_live_later_segment_matches_reference_and_its_work(what,
                                                           monkeypatch):
    """Segment 1 live: the training step meets the reference's
    value_and_grad (loss rtol 1e-5, every gradient within 5e-4 x max|a|,
    split_params' keys). Per step, a live segment's autograd replay
    (textures) runs twice in the checkpointed training step (forward,
    and recomputed in its backward) and once in the fit step (its graph
    kept); a fused segment runs K5 once and K6 once, and on the mixed
    kinds K10 once and K11 once besides; a dead segment runs nothing."""
    ref = live_scene(what, "ref").build()
    port = to_port(ref)
    cam = live_scene(what, "port").camera
    route = {"analytic": "fused_mixed", "texture": "autograd",
             "fused": "fused_tri"}[what]
    fused = route != "autograd"
    cfg = tr.TraceConfig(texture_filter="nearest")
    assert cfg.replay_route(port) == route
    assert port.n_segments == 3
    o, d = prender.primary_rays_blocked(cam, "cpu")
    topo = tr.trace_topology(port, o, d)
    live = (topo.hit | topo.miss).any(dim=1).tolist()
    assert live[:2] == [True, True]
    for k in LIVE_KINDS[what]:
        assert bool((topo.kind[1] == k).any()), k
    if what == "texture":
        ti = topo.idx[1][topo.kind[1] == shade.KIND_TRI].long()
        assert bool((port.tri_tex[ti, 0] > 0).any())

    target = np.random.default_rng(len(what)).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    r_loss, r_grads = r_loss_grad_image(
        ref, live_scene(what, "ref").camera, jnp.asarray(target),
        cfg=rtr.TraceConfig(tri_method="brute"))
    loss, grads = prender.render_loss_grad_image(
        port, cam, torch.from_numpy(target), cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert list(grads) == list(r_split_params(ref)) == list(
        split_params(port))
    for k, want in r_grads.items():
        got, want = grads[k].numpy(), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all(), k
        tol = GRAD_REL * max(float(np.abs(want).max()) if want.size else 0.0,
                             1e-3)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)

    n_live = sum(live)
    kernels = {sg: ("segment_fwd", "segment_bwd"),
               sga: ("segment_ana_fwd", "segment_ana_bwd")}
    if route == "fused_tri":
        del kernels[sga]
    counts = {} if fused else _count_step(monkeypatch, "autograd")
    for mod, names in (kernels.items() if fused else ()):
        _count_calls(monkeypatch, mod, names, counts)
    case = dict(port=port, o=o, d=d)
    per_step = {}
    with branching():
        for entry in ("loss_grad", "fit"):
            for k in counts:
                counts[k] = 0
            if entry == "loss_grad":
                prender.render_loss_grad_image(
                    port, cam, torch.from_numpy(target), cfg)
            else:
                _fit_step(case, cfg)
            per_step[entry] = dict(counts)
    if fused:
        want = dict.fromkeys(counts, n_live)
        assert per_step == {"loss_grad": want, "fit": want}
    else:
        assert per_step == {"loss_grad": {"_replay_segment": 2 * n_live},
                            "fit": {"_replay_segment": n_live}}
