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

import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import FLAT as RFLAT
from myraytracer_tpu.models.mesh import TriangleMesh as RMesh
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

from test_torch_graphs import PLAIN, REF_CFG, NoHostRead, _unwatched
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


def tiles_scene(pkg: str, w: int = 64, h: int = 64):
    """A mirror floor below the horizon and a mirror mesh sphere on it at
    the left, max_depth 3, 64x64 (four 32x32 screen blocks). Traced in
    tiles of one block: the top right block sees only the sky, so its
    segments 1.. are dead; the other blocks live through segment 1, and
    the bottom left one, where the sphere and the floor reflect each
    other, through segment 3."""
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
    s.add_plane((0, -0.4, 0), (0, 1, 0), Mat(
        ambient=(0.1, 0.1, 0.1), diffuse=(0.3, 0.4, 0.3), mirror=0.5))
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
