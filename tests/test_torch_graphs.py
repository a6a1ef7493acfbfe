"""The regions the port captures as CUDA graphs (ops/graphs.py), on the CPU.

On the card each entry point is captured once per key and replayed. A
capture cannot hold a read of a device value on the host, so:

  (a) ``render``, ``render_aa``'s two passes, the training step and one
      ``InverseRenderer`` step run here, each region that ``graphs.run``
      would capture, under a dispatch mode that raises on
      ``aten._local_scalar_dense``, ``aten.nonzero`` and
      ``aten.masked_select``. The mode is suspended inside the kernels'
      ``*_plain`` versions (data-dependent by design; the card runs the
      kernels) and inside the CPU optimizer's step (the card's Adam is
      ``capturable``);
  (b) the segment conditions, now a select on the device, hold against
      the reference (``myraytracer_tpu.ops.tracer`` on the CPU) on a
      scene in which every ray dies two segments before the last: the
      dead segments' records equal the reference's ``dead`` records, the
      colours and the training step meet the existing parity bars (>=
      99.5% of pixels within 1e-4; loss rtol 1e-5, gradients within 5e-4
      x max|a|), through the fused K5/K6 segment and the autograd replay;
  (c) the cache key moves with what a jit's key moves with, and stays
      under an in-place update and a new camera of the same size;
  (d) ``disable_graphs()`` nests and restores;
  (e) CPU tensors never fill the cache.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import FLAT as RFLAT
from myraytracer_tpu.models.mesh import TriangleMesh as RMesh
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render_loss_grad_image as r_loss_grad_image)
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.inverse import InverseRenderer
from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.scenes.kinds import mixed_scene
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

from test_torch_scene import office, to_port

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)
GRAD_REL = 5e-4

#: the kernels' plain versions: data-dependent loops, never run on the card
PLAIN = ((cc, "phase1_exact_plain"), (cc, "cluster_scan_plain"),
         (cs, "shade_pre_plain"), (cs, "shade_phong_plain"),
         (sg, "segment_plain"), (sg, "segment_bwd_plain"),
         (trv, "traverse_bvh_plain"))

HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::masked_select")


class NoHostRead(TorchDispatchMode):
    """Raises on every operation that reads a device value on the host:
    HOST_READS, and indexing by a boolean mask (on the card it counts the
    mask's True entries on the host; here it shows as aten.index)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split(".")[0]
        mask = name in ("aten::index", "aten::index_put",
                        "aten::index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1] if i is not None)
        if name in HOST_READS or mask:
            raise AssertionError(f"host read in a captured region: {func}")
        return func(*args, **(kwargs or {}))


def _unwatched(fn):
    def call(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    return call


@pytest.fixture
def regions(monkeypatch):
    """Runs every region that graphs.run receives under NoHostRead and
    returns the names of the regions run."""
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, _unwatched(getattr(mod, name)))
    names = []
    run = graphs.run

    def watched(name, fn, device, static=(), held=(), staged=(), group=None,
                records_grad=False):
        names.append(name)

        def body(*a):
            with NoHostRead():
                return fn(*a)
        return run(name, body, device, static, held, staged, group,
                   records_grad)

    monkeypatch.setattr(graphs, "run", watched)
    return names


def dead_scene(pkg: str, w: int = 32, h: int = 24):
    """A convex mirror mesh sphere before the background, max_depth 3:
    every ray is dead after segment 1 (a miss, or a reflection off the
    convex sphere, which misses), so segments 2 and 3 have no live ray."""
    if pkg == "ref":
        S, Mat, Mesh, flat, sphere = (RScene, RMaterial, RMesh, RFLAT,
                                      r_uv_sphere)
    else:
        S, Mat, Mesh, flat, sphere = (Scene, Material, TriangleMesh, FLAT,
                                      uv_sphere)
    s = S()
    s.set_camera(eye=(0, 0.5, 4), center=(0, 0, 0), up=(0, 1, 0), fovy=40,
                 width=w, height=h)
    s.add_light((3, 3, 3), (0.9, 0.85, 0.8))
    s.ambience = (0.1, 0.1, 0.12)
    s.background = (0.05, 0.1, 0.2)
    s.max_depth = 3
    v, f = sphere(1.0, 8, 12)
    s.add_mesh(Mesh(v, f, material=Mat(
        ambient=(0.1, 0.1, 0.1), diffuse=(0.5, 0.3, 0.2),
        specular=(0.4, 0.4, 0.4), shininess=20, mirror=0.6), draw_mode=flat))
    return s


@pytest.fixture(scope="module")
def dead():
    ref = dead_scene("ref").build()
    port = to_port(ref)
    cam = dead_scene("port").camera
    o, d = prender.primary_rays_blocked(cam, "cpu")
    return dict(ref=ref, port=port, cam=cam, o=o, d=d)


# --- (a) no host read in the regions to be captured -----------------------

def _inverse_step(data, cam, cfg):
    inv = InverseRenderer(data, param_names=("mat_diffuse", "light_color",
                                             "cam_eye"), camera=cam, cfg=cfg)
    inv.optimizer.step = _unwatched(inv.optimizer.step)
    xs, ys = cam.pixel_grid("cpu")
    target = torch.full((xs.numel(), 3), 0.2)
    return inv.fit_pixels(xs.reshape(-1), ys.reshape(-1), target, steps=1)


@pytest.mark.parametrize("scene,method", [("office", "cluster"),
                                          ("office", "auto"),
                                          ("mirror", "cluster"),
                                          ("dead", "auto")])
def test_captured_regions_make_no_host_read(regions, scene, method):
    if scene == "office":
        s = office("port", tess=2, w=48, h=40)
    elif scene == "mirror":
        s = mixed_scene(mirror=0.3, w=40, h=32)
    else:
        s = dead_scene("port")
    data, cam = s.build(device="cpu"), s.camera
    if scene != "office":
        assert data.n_segments > 1
    cfg = tr.TraceConfig(tri_method=method)
    img = prender.render(data, cam, cfg)
    aa = prender.render_aa(data, cam, cfg)
    tgt = torch.full_like(img, 0.3)
    loss, grads = prender.render_loss_grad_image(data, cam, tgt, cfg)
    for fused in (True, False):
        prender.render_loss_grad_image(
            data, cam, tgt, cfg._replace(fused_shade_grad=fused))
    fit = _inverse_step(data, cam, cfg._replace(texture_filter="bilinear"))
    assert regions == ["render", "render", "aa_refine",
                       "render_loss_grad_image", "render_loss_grad_image",
                       "render_loss_grad_image", "fit_step"]
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(aa).all())
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    assert np.isfinite(fit.losses).all()


def test_no_host_read_mode_catches_a_host_read(regions):
    data = office("port", tess=2, w=32, h=32).build(device="cpu")
    cam = office("port", tess=2, w=32, h=32).camera
    with pytest.raises(AssertionError, match="host read"):
        graphs.run("bad", lambda c: float(c.sum()), "cpu",
                   staged=(cam.packed(),))
    with pytest.raises(AssertionError, match="host read"):
        graphs.run("bad", lambda: data.mat_diffuse[data.mat_diffuse > 0.1],
                   "cpu")


# --- (b) the device-side segment conditions against the reference ---------

def test_dead_scene_kills_every_ray_early(dead):
    topo = tr.trace_topology(dead["port"], dead["o"], dead["d"])
    assert topo.kind.shape[0] == 4
    live = topo.hit | topo.miss
    assert bool(live[0].all()) and bool(topo.hit[0].any())
    # segment 1: the reflections leave the convex sphere, all live misses
    assert bool(topo.miss[1].any()) and not bool(topo.hit[1].any())
    assert not bool(live[2:].any())


def test_trace_topology_dead_records_match_reference(dead):
    o, d = dead["o"], dead["d"]
    want = rtr.trace_topology(dead["ref"], jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy()),
                              REF_CFG._replace(fused_shade=True))
    for method in ("cluster", "auto"):
        got = tr.trace_topology(dead["port"], o, d,
                                tr.TraceConfig(tri_method=method))
        for f in ("kind", "idx", "hit", "miss", "shadow"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.shape == b.shape, f
            assert (a == b).mean() >= 0.995, (method, f)
            np.testing.assert_array_equal(a[2:], b[2:], err_msg=f)
        assert (got.kind[2:] == shade.KIND_MISS).all()
        assert not got.idx[2:].any() and not got.shadow[2:].any()


def test_trace_with_dead_segments_matches_reference(dead):
    o, d = dead["o"], dead["d"]
    want = np.asarray(rtr.trace(dead["ref"], jnp.asarray(o.numpy()),
                                jnp.asarray(d.numpy()), REF_CFG))
    for method in ("cluster", "auto"):
        got = tr.trace(dead["port"], o, d,
                       tr.TraceConfig(tri_method=method)).numpy()
        diff = np.abs(got - want).max(axis=1)
        assert (diff <= 1e-4).mean() >= 0.995, (method, (diff <= 1e-4).mean())


@pytest.mark.parametrize("fused", [True, False])
def test_loss_grad_with_dead_segments_matches_reference(dead, fused):
    cam = dead["cam"]
    tgt = np.random.default_rng(3).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    r_loss, r_grads = r_loss_grad_image(dead["ref"], dead_scene("ref").camera,
                                        jnp.asarray(tgt), cfg=REF_CFG)
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    assert (cfg.replay_route(dead["port"]) != "autograd") == fused
    loss, grads = prender.render_loss_grad_image(
        dead["port"], cam, torch.from_numpy(tgt), cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert sorted(grads) == sorted(r_grads)
    for k, want in r_grads.items():
        got, want = grads[k].numpy(), np.asarray(want)
        assert np.isfinite(got).all(), k
        tol = GRAD_REL * max(float(np.abs(want).max()) if want.size else 0.0,
                             1e-3)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)
    assert np.abs(r_grads["mat_mirror"]).max() > 0


# --- (c) the cache key ------------------------------------------------------

@pytest.fixture
def keys(monkeypatch):
    """Records the key of every graphs.run call instead of running it."""
    got = []

    def record(name, fn, device, static=(), held=(), staged=(), group=None,
               records_grad=False):
        got.append(graphs.make_key(name, static, held, staged, group))

    monkeypatch.setattr(graphs, "run", record)
    return got


def _key(keys, call):
    keys.clear()
    call()
    assert len(keys) == 1
    return keys[0]


def test_cache_key_moves_with_shape_config_tile_depth_camera_address(keys):
    s = office("port", tess=2, w=64, h=48)
    data, cam = s.build(device="cpu"), s.camera
    base = _key(keys, lambda: prender.render(data, cam))
    assert _key(keys, lambda: prender.render(data, cam)) == base
    other = {
        "shape": lambda: prender.render(
            office("port", tess=3, w=64, h=48).build(device="cpu"), cam),
        "cfg": lambda: prender.render(data, cam,
                                      tr.TraceConfig(tri_method="bvh")),
        "tile": lambda: prender.render(data, cam, tile=1024),
        "clamp": lambda: prender.render(data, cam, clamp=False),
        "live_depth": lambda: prender.render(
            dataclasses.replace(data, live_depth=4), cam),
        "camera size": lambda: prender.render(
            data, office("port", tess=2, w=64, h=32).camera),
        "address": lambda: prender.render(dataclasses.replace(
            data, mat_diffuse=data.mat_diffuse.clone()), cam),
    }
    seen = {base}
    for what, call in other.items():
        k = _key(keys, call)
        assert k not in seen, what
        seen.add(k)


def test_cache_key_stays_under_in_place_update_and_new_camera(keys):
    s = office("port", tess=2, w=64, h=48)
    data, cam = s.build(device="cpu"), s.camera
    for entry in ("render", "render_loss_grad_image"):
        tgt = torch.zeros(48, 64, 3)

        def call(c):
            if entry == "render":
                return prender.render(data, c)
            return prender.render_loss_grad_image(data, c, tgt)

        base = _key(keys, lambda: call(cam))
        data.mat_diffuse.mul_(0.5)
        data.light_pos.add_(0.1)
        assert _key(keys, lambda: call(cam)) == base, entry
        moved = dataclasses.replace(cam, eye=cam.eye + 0.3,
                                    fovy=cam.fovy + 5.0)
        assert _key(keys, lambda: call(moved)) == base, entry
        assert _key(keys, lambda: call(dataclasses.replace(
            cam, width=32))) != base, entry


def test_cache_key_of_the_training_step_follows_restore_mirror_chain(keys):
    s = mixed_scene(mirror=0.0, w=32, h=32)
    data, cam = s.build(device="cpu"), s.camera
    assert data.n_segments == 1
    tgt = torch.zeros(32, 32, 3)
    flat = _key(keys, lambda: prender.render_loss_grad_image(data, cam, tgt))
    data.mat_mirror[0] = 0.4                 # in place: restores the chain
    deep = _key(keys, lambda: prender.render_loss_grad_image(data, cam, tgt))
    assert flat != deep
    assert ("live_depth", data.max_depth + 1) in deep[1][0]
    assert ("live_depth", 1) in flat[1][0]


def test_cache_key_of_the_refine_and_the_fit_step(keys):
    s = office("port", tess=2, w=64, h=48)
    data, cam = s.build(device="cpu"), s.camera
    img1 = torch.zeros(48, 64, 3)
    base = _key(keys, lambda: prender._aa_refine(data, cam, img1))
    # the pass-1 image is staged: a new image of the same shape keeps it
    assert _key(keys, lambda: prender._aa_refine(
        data, cam, torch.ones(48, 64, 3))) == base
    for kw in ({"subp": 2}, {"threshold": 0.05}, {"budget_frac": 0.2}):
        assert _key(keys, lambda: prender._aa_refine(data, cam, img1,
                                                      **kw)) != base, kw

    inv = InverseRenderer(data, param_names=("mat_diffuse",))
    o, d = prender.primary_rays_blocked(cam, "cpu")
    tgt = torch.zeros_like(o)
    step = _key(keys, lambda: inv._step(o, d, tgt, False))
    with torch.no_grad():
        inv.params["mat_diffuse"].mul_(0.9)
    assert _key(keys, lambda: inv._step(o, d, tgt, False)) == step
    inv.optimizer.param_groups[0]["lr"] = 0.5
    assert _key(keys, lambda: inv._step(o, d, tgt, False)) != step


# --- (d), (e) ----------------------------------------------------------------

def test_disable_graphs_nests_and_restores():
    assert graphs.graphs_enabled()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        with graphs.disable_graphs():
            assert not graphs.graphs_enabled()
        assert not graphs.graphs_enabled()
    assert graphs.graphs_enabled()
    with pytest.raises(KeyError):
        with graphs.disable_graphs():
            raise KeyError("x")
    assert graphs.graphs_enabled()


def test_cpu_entry_points_never_fill_the_cache():
    graphs.clear()
    s = office("port", tess=2, w=32, h=32)
    data, cam = s.build(device="cpu"), s.camera
    tgt = torch.zeros(32, 32, 3)
    o, d = prender.primary_rays_blocked(cam, "cpu")
    inv = InverseRenderer(data, param_names=("mat_diffuse",))
    for _ in range(3):
        prender.render(data, cam)
        prender.render_aa(data, cam)
        prender.render_loss_grad_image(data, cam, tgt)
        prender.render_loss_grad(data, o, d, torch.zeros_like(o))
        inv.fit(o, d, torch.zeros_like(o), steps=1)
    assert graphs.cache_size() == 0 and graphs.captured() == 0


def test_capture_failure_names_the_line_that_failed():
    """A capture that reads the host fails twice: at the read, then when
    the capture ends. The error names the first failure's line, outside
    the torch package."""
    def region():
        x = torch.ones(3)
        return float(x.sum()) + undefined_name  # noqa: F821

    try:
        try:
            region()
        except NameError:
            raise RuntimeError("the capture ended with an error")
    except RuntimeError as e:
        site = graphs._failure_site(e)
    assert "test_torch_graphs.py" in site and "in region" in site
    assert "undefined_name" in site and "NameError" in site


def test_clone_gives_fresh_outputs():
    loss = torch.tensor(1.5)
    out = (loss, {"a": torch.ones(2), "b": None}, [torch.zeros(1)], 3)
    got = graphs._clone(out)
    assert got[0] is not loss and torch.equal(got[0], loss)
    assert got[1]["a"].data_ptr() != out[1]["a"].data_ptr()
    assert got[1]["b"] is None and got[3] == 3
    topo = tr.TraceTopo(*(torch.zeros(2) for _ in range(5)))
    assert isinstance(graphs._clone(topo), tr.TraceTopo)


def test_camera_packs_into_one_tensor():
    cam = office("port", tess=2, w=40, h=24).camera
    vec = cam.packed()
    assert vec.shape == (10,) and vec.dtype == torch.float32
    back = type(cam).from_packed(vec, cam.width, cam.height)
    xs, ys = cam.pixel_grid("cpu")
    for a, b in zip(cam.primary_rays(xs, ys), back.primary_rays(xs, ys)):
        assert torch.equal(a, b)
    moved = cam.to("cpu")
    assert torch.equal(moved.packed(), vec) and moved.width == cam.width
