"""The sharded entry points as CUDA-graph regions (parallel/, ops/graphs.py),
on an in-process one-rank gloo mesh on the CPU.

On the card over NCCL ``render_sharded``, ``render_aa_sharded``'s refine,
``make_train_step``'s step and ``InverseRenderer(mesh=...)``'s step are
captured once per key and replayed, as the single-device entry points
are (tests/test_torch_graphs.py). Here, on the CPU:

  (a) every sharded region goes through ``graphs.run`` under the
      ``regions`` fixture of tests/test_torch_graphs.py (its names in
      order, no host read), on office with "cluster" and "auto" and on
      the scene whose last two segments are dead; at mesh size 1 the
      sharded images equal the single device's bit for bit;
  (b) under the stand-in IF node of tests/test_torch_cond.py, with each
      body marked as one (``graphs.recording_body``), the sharded paths
      run their collectives outside every body and give the select's
      results;
  (c) the key holds the mesh's process group (backend, rank, size and
      the group object) and stays put over chained training steps,
      whose float leaves are staged;
  (d) the backend rule: only NCCL is captured, gloo runs eagerly;
  (e) the one all-reduce raises inside an IF node's body.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from myraytracer_tpu_torch.inverse import InverseRenderer
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel import shard_render as sr
from myraytracer_tpu_torch.parallel.mesh import RAY_AXIS, all_reduce, make_mesh

from test_torch_graphs import regions  # noqa: F401  (a fixture)
from test_torch_graphs import _unwatched, dead_scene, office

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

#: the sharded regions of one render, AA, training step and fit step
SHARDED_REGIONS = ["render_sharded", "render_sharded", "aa_refine_sharded",
                   "train_step_sharded", "fit_step"]


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo ray mesh in this process, destroyed after the
    module (the graphs first, as every caller that destroys a group)."""
    m = make_mesh(1, "cpu")
    yield m
    graphs.clear()
    dist.destroy_process_group()


def _scene(name: str):
    s = office("port", tess=2, w=48, h=40) if name == "office" else (
        dead_scene("port"))
    return s.build(device="cpu"), s.camera


def _step_batch(cam):
    """The training step's batch: every pixel in screen-block order."""
    o, d = prender.primary_rays_blocked(cam, "cpu")
    tgt = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, tuple(o.shape)).astype(np.float32))
    return o, d, tgt, torch.ones(o.shape[0])


def _sharded_calls(data, cam, mesh, cfg):
    """render_sharded, render_aa_sharded, one SGD step and one fit step."""
    img = sr.render_sharded(data, cam, mesh, cfg)
    aa = sr.render_aa_sharded(data, cam, mesh, cfg)
    new, loss = sr.make_train_step(mesh, cfg, lr=0.5)(data,
                                                       *_step_batch(cam))
    inv = InverseRenderer(data, ("mat_diffuse", "light_color", "cam_eye"),
                          cfg=cfg._replace(texture_filter="bilinear"),
                          mesh=mesh, camera=cam)
    inv.optimizer.step = _unwatched(inv.optimizer.step)
    xs, ys = cam.pixel_grid("cpu")
    fit = inv.fit_pixels(xs.reshape(-1), ys.reshape(-1),
                         torch.full((xs.numel(), 3), 0.2), steps=1)
    return img, aa, new, loss, fit


# --- (a) the regions ---------------------------------------------------------

@pytest.mark.parametrize("scene,method", [("office", "cluster"),
                                          ("office", "auto"),
                                          ("dead", "auto")])
def test_sharded_regions_make_no_host_read(regions, mesh, scene, method):
    data, cam = _scene(scene)
    cfg = tr.TraceConfig(tri_method=method)
    img, aa, new, loss, fit = _sharded_calls(data, cam, mesh, cfg)
    assert regions == SHARDED_REGIONS
    assert torch.equal(img, prender.render(data, cam, cfg))
    assert torch.equal(aa, prender.render_aa(data, cam, cfg))
    assert bool(torch.isfinite(loss)) and np.isfinite(fit.losses).all()
    assert all(bool(torch.isfinite(v).all())
               for v in sr.split_params(new).values())


# --- (b) collectives stay outside the IF nodes' bodies ------------------------

@contextlib.contextmanager
def marked_branching():
    """Segments 1.. branch as under a capture; the stand-in IF node runs
    each body whose condition holds, marked as an IF node's body."""
    seen = []

    def stand_in(pred, body, site):
        took = bool(pred.item())
        seen.append((site, took))
        if took:
            with graphs.recording_body(site):
                body()

    with mock.patch.object(graphs, "capturing", lambda device: True), \
            mock.patch.object(graphs, "if_node", stand_in):
        yield seen


def test_sharded_collectives_run_outside_every_body(mesh):
    data, cam = _scene("dead")
    assert data.n_segments == 4
    cfg = tr.TraceConfig()
    step = sr.make_train_step(mesh, cfg, lr=0.5)
    batch = _step_batch(cam)

    def run():
        img = sr.render_sharded(data, cam, mesh, cfg)
        aa = sr.render_aa_sharded(data, cam, mesh, cfg)
        new, loss = step(data, *batch)
        return img, aa, sr.split_params(new), loss

    want = run()
    with marked_branching() as seen:
        got = run()
    sites = {site for site, _ in seen}
    assert any("trace_shade" in s for s in sites), sites
    assert any(took for _, took in seen) and not all(took for _, took in seen)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)
    for k, v in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# --- (c) the key --------------------------------------------------------------

@pytest.fixture
def keys(monkeypatch):
    """Records the key of every graphs.run call, then runs it."""
    got = []
    run = graphs.run

    def record(name, fn, device, static=(), held=(), staged=(), group=None,
               records_grad=False):
        got.append(graphs.make_key(name, static, held, staged, group))
        return run(name, fn, device, static, held, staged, group,
                   records_grad)

    monkeypatch.setattr(graphs, "run", record)
    return got


def test_sharded_key_moves_with_the_group(keys, mesh, monkeypatch):
    data, cam = _scene("office")
    sr.render_sharded(data, cam, mesh)
    base = keys[-1]
    assert base[-1] == ("gloo", 0, 1, mesh.get_group())
    sr.render_sharded(data, cam, mesh)
    assert keys[-1] == base
    # a new group over the same rank: the key holds the object, not a name
    other = DeviceMesh.from_group(dist.new_group([0]), "cpu",
                                  mesh_dim_names=(RAY_AXIS,))
    assert other.get_group() is not mesh.get_group()
    sr.render_sharded(data, cam, other)
    assert keys[-1] != base and keys[-1][:-1] == base[:-1]
    seen = {base, keys[-1]}
    for fn, value in (("get_world_size", 2), ("get_rank", 1)):
        with monkeypatch.context() as m:
            m.setattr(graphs.dist, fn, lambda group=None, v=value: v)
            k = graphs.make_key("render_sharded", base[1], (), (),
                                mesh.get_group())
        assert k[-1] not in {s[-1] for s in seen}, fn
        seen.add(k)
    # the single device's key holds no group
    prender.render(data, cam)
    assert keys[-1][-1] is None


def test_train_step_key_stays_over_chained_steps(keys, mesh):
    data, cam = _scene("office")
    step = sr.make_train_step(mesh, lr=0.5)
    batch = _step_batch(cam)
    scenes, losses = [data], []
    for _ in range(4):
        new, loss = step(scenes[-1], *batch)
        scenes.append(new)
        losses.append(float(loss))
    # the first step moves mat_mirror above 0, which restores the mirror
    # chain (live_depth, in the key) once; then the key stays
    assert ("live_depth", 1) in keys[0][1][0]
    assert ("live_depth", data.max_depth + 1) in keys[1][1][0]
    assert keys[1] == keys[2] == keys[3]
    assert keys[1][0] == "train_step_sharded"
    # the leaves are new tensors each step, and they are staged
    a, b = sr.split_params(scenes[2]), sr.split_params(scenes[3])
    assert all(a[k].data_ptr() != b[k].data_ptr() for k in a if a[k].numel())
    assert [shape for shape, _ in keys[1][3]] == [
        tuple(v.shape) for v in sr.split_params(data).values()]
    assert losses[3] < losses[0]


def test_sharded_fit_step_key_stays_and_holds_the_group(keys, mesh):
    data, cam = _scene("office")
    o, d, tgt, _ = _step_batch(cam)
    inv = InverseRenderer(data, ("mat_diffuse",), mesh=mesh)
    for _ in range(3):
        inv.fit(o, d, tgt, steps=1)
    # step 1 has no optimizer state yet; steps 2 and 3 share one key
    assert keys[0] != keys[1] == keys[2]
    assert keys[2][0] == "fit_step" and keys[2][-1][3] is mesh.get_group()


# --- (d) the backend rule -----------------------------------------------------

def test_only_nccl_groups_are_captured(mesh, monkeypatch):
    group = mesh.get_group()
    assert dist.get_backend(group) == "gloo"
    assert graphs.runs_eagerly("cuda", group)
    assert graphs.runs_eagerly("cpu") and not graphs.runs_eagerly("cuda")
    with graphs.disable_graphs():
        assert graphs.runs_eagerly("cuda")
    before, size = dict(graphs.COUNTS), graphs.cache_size()
    # a CUDA device with a gloo group runs the region as it is, and never
    # reaches the card
    assert graphs.run("gloo region", lambda: 42, "cuda", group=group) == 42
    assert graphs.COUNTS == before and graphs.cache_size() == size
    monkeypatch.setattr(graphs.dist, "get_backend", lambda group=None: "nccl")
    assert not graphs.runs_eagerly("cuda", group)
    assert graphs.runs_eagerly("cpu", group)


# --- (e) the all-reduce guard -------------------------------------------------

def test_all_reduce_raises_inside_an_if_node_body(mesh):
    t = torch.arange(3.0)
    assert graphs.if_body_site() is None
    with graphs.recording_body("segment 1 of trace"):
        with graphs.recording_body("segment 2 of trace"):
            assert graphs.if_body_site() == "segment 2 of trace"
            with pytest.raises(graphs.GraphCaptureError,
                               match="segment 2 of trace: a collective "
                                     "inside an IF node's body"):
                all_reduce(t, mesh)
        assert graphs.if_body_site() == "segment 1 of trace"
    assert graphs.if_body_site() is None
    assert torch.equal(all_reduce(t, mesh), torch.arange(3.0))


def test_sharded_step_raises_when_a_body_holds_its_collective(mesh):
    """A body that reached the all-reduce (here: the whole step recorded
    as one body) fails the capture instead of hanging the other ranks."""
    data, cam = _scene("office")
    step = sr.make_train_step(mesh, lr=0.5)
    with graphs.recording_body("a faked body"):
        with pytest.raises(graphs.GraphCaptureError, match="a faked body"):
            step(data, *_step_batch(cam))
