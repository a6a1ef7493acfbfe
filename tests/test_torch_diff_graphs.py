"""The graphed differentiable render (ops/graphs.py, ops/render.py), on the CPU.

On the card a grad-recording ``render(clamp=False)`` replays two CUDA
graphs, the counterparts of the reference's jitted forward and its
transpose: the forward (topology and shading replay of every tile, the
autograd residuals kept) and the backward (``torch.autograd.grad`` of the
image, given its cotangent, with respect to every scene and camera
tensor that requires grad), joined by one autograd Function. Here the
card's path runs on CPU tensors with the graph machinery stood in for
(the ``split`` fixture): no eager rule for the device, the warm-up a
direct call, each capture a direct call of its region and each replay
another. A replay then recomputes what the graph would replay, so:

  (a) the key moves with the set of scene leaves that require grad,
      with whether the camera does, and with ``clamp``, ``cfg`` and
      ``tile``; it stays under an in-place leaf update and a new camera
      of the same size;
  (b) neither region reads the host (test_torch_graphs' ``NoHostRead``)
      on office, the textured scene with the bilinear fetch and o_04;
  (c) the split path gives the eager route's image, loss and gradients
      to the bit, and meets test_torch_diff_trace's bars against the
      reference's ``jax.value_and_grad`` of ``render(clamp=False)`` (its
      Pallas cluster kernels in interpret mode), the pixels whose primary
      ray grazes a sphere left out of the loss (GRAZE);
  (d) the pending rule: a second forward before the first one's backward
      runs eagerly and the gradients equal the all-eager call's at the
      gradient bar (the two images' parts sum in another grouping); a dropped
      output releases the key; an entry with a pending backward outlives
      MAX_GRAPHS later keys;
  (e) a second backward (``retain_graph=True``) gives the same gradients,
      and ``create_graph=True`` raises;
  (f) a failure of either capture raises GraphCaptureError naming
      ``forward`` or ``backward``.

Tolerances: bit-equality where the same operations run on the same
values (the split path against the eager route); the reference at
test_torch_diff_trace's bars (loss rtol 1e-5, each gradient within 5e-4 x
max|ref|).
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import render as rrender
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.parallel.shard_render import (
    merge_params as r_merge_params, split_params as r_split_params)
from myraytracer_tpu.scenes import golden as rgolden

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

from test_grad import textured_scene
from test_torch_cond import branching
from test_torch_diff_trace import GRAD_REL, _check_grads, _scaled_close
from test_torch_graphs import PLAIN, REF_CFG, NoHostRead, _unwatched
from test_torch_scene import office, to_port

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _port_camera(rcam) -> Camera:
    return Camera.make(np.array(rcam.eye), np.array(rcam.center),
                       np.array(rcam.up), float(rcam.fovy), rcam.width,
                       rcam.height)


def _office():
    s = office("ref", tess=2, w=32, h=32)
    return s.build(), s.camera, tr.TraceConfig(), REF_CFG


def _textured():
    s = textured_scene()
    return (s.build(), s.camera, tr.TraceConfig(texture_filter="bilinear"),
            rtr.TraceConfig(texture_filter="bilinear"))


def _o04():
    s = rgolden.scene_04_molecule(scale=0.05, n_atoms=24)
    return s.build(), s.camera, tr.TraceConfig(), REF_CFG


#: name -> () -> (reference SceneData, reference camera, port cfg,
#: reference cfg)
SCENES = {"office": _office, "textured_bilinear": _textured, "o_04": _o04}


#: a primary ray grazes a sphere where b^2 - c < GRAZE * b^2 (t = -b -
#: sqrt(b^2 - c)): its t and their gradients are ill-conditioned, and the
#: two packages' roundings part there
GRAZE = 1e-4


def _weights(port, cam) -> np.ndarray:
    """[H, W] 1, and 0 at the pixels whose primary ray grazes the sphere
    it hits: the reference comparison leaves those out of the loss (o_04
    at 25x25 has one, whose colour meets the render bar but moves its
    sphere's gradient by 3e-3 x max|g|)."""
    xs, ys = cam.pixel_grid("cpu")
    o, d = cam.primary_rays(xs.reshape(-1), ys.reshape(-1))
    topo = tr.trace_topology(port, o, d)
    w = np.ones(o.shape[0], np.float32)
    if port.n_spheres:
        i = topo.idx[0].long()
        oc = o - port.sphere_center[i]
        b = (oc * d).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - port.sphere_radius[i] ** 2)
        graze = (topo.kind[0] == shade.KIND_SPHERE) & (disc < GRAZE * b * b)
        w[graze.numpy()] = 0.0
    return w.reshape(cam.height, cam.width)


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    ref, rcam, cfg, r_cfg = SCENES[request.param]()
    port, cam = to_port(ref), _port_camera(rcam)
    tgt = np.random.default_rng(11).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    return dict(name=request.param, ref=ref, rcam=rcam, port=port, cam=cam,
                cfg=cfg, r_cfg=r_cfg, tgt=tgt, w=_weights(port, cam))


class Direct:
    """A stand-in CUDA graph: a replay calls its region again, in the grad
    mode of its capture (a replay runs inside the autograd Function,
    where grad mode is off)."""

    def __init__(self, region):
        self.region = region
        self.grad = torch.is_grad_enabled()

    def replay(self):
        with torch.set_grad_enabled(self.grad):
            self.region()

    def pool(self):
        return None

    def reset(self):
        pass


@pytest.fixture
def split(monkeypatch):
    """graphs.run takes the card's path for CPU tensors: the eager rule
    only under disable_graphs(), the warm-up a direct call, each capture
    and replay a direct call of the region. Yields the regions'
    captures, in order."""
    captured = []

    def record(region, pool, mode):
        captured.append(region.__name__)
        region()
        return Direct(region)

    monkeypatch.setattr(graphs, "runs_eagerly",
                        lambda device, group=None: not graphs.graphs_enabled())
    monkeypatch.setattr(graphs, "_warm_up", lambda call, device: call())
    monkeypatch.setattr(graphs, "_record", record)
    graphs.clear()
    yield captured
    graphs.clear()


def _leaves(scene):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in split_params(scene).items()}


def _sse(img, tgt, w=None):
    sq = (img - torch.from_numpy(tgt)) ** 2
    return torch.sum(sq if w is None else torch.from_numpy(w)[..., None] * sq)


def _call(scene, params, cam, tgt, cfg, w=None, **kw):
    """(image, loss, gradients of every leaf) of one render(clamp=False)
    under autograd; the loss weighted by ``w`` [H, W], if given."""
    img = prender.render(merge_params(scene, params), cam, cfg, clamp=False,
                         **kw)
    loss = _sse(img, tgt, w)
    names = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
    return img.detach(), loss.detach(), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, got)}


def _moved(counts: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in counts.items() if v != before[k]}


def _assert_bit_equal(got, want):
    (img, loss, grads), (img_w, loss_w, grads_w) = got, want
    assert torch.equal(img, img_w)
    assert torch.equal(loss, loss_w)
    assert sorted(grads) == sorted(grads_w)
    for k in grads:
        assert torch.equal(grads[k], grads_w[k]), k


# --- (a) the key ------------------------------------------------------------

@pytest.fixture
def keys(monkeypatch):
    """Records the key of every graphs.run call instead of running it."""
    got = []

    def record(name, fn, device, static=(), held=(), staged=(), group=None,
               records_grad=False):
        got.append(graphs.make_key(name, static, held, staged, group,
                                   records_grad))

    monkeypatch.setattr(graphs, "run", record)
    return got


def _key(keys, call):
    keys.clear()
    call()
    assert len(keys) == 1
    return keys[0]


def _office_port():
    s = office("port", tess=2, w=32, h=32)
    return s.build(device="cpu"), s.camera


def _grad_render(data, names, cam, clamp=False, **kw):
    """The scene with ``names`` as leaves that require grad, rendered."""
    params = {k: v.detach().requires_grad_(k in names)
              for k, v in split_params(data).items()}
    return prender.render(merge_params(data, params), cam, clamp=clamp, **kw)


MOVES = {
    "leaf set": lambda d, c: _grad_render(d, ("mat_diffuse", "light_pos"), c),
    "camera requires grad": lambda d, c: _grad_render(
        d, ("mat_diffuse",), dataclasses.replace(
            c, eye=c.eye.clone().requires_grad_(True))),
    "no grad recorded": lambda d, c: _grad_render(d, (), c),
    "clamp": lambda d, c: _grad_render(d, ("mat_diffuse",), c, clamp=True),
    "cfg": lambda d, c: _grad_render(d, ("mat_diffuse",), c,
                                     cfg=tr.TraceConfig(tri_method="bvh")),
    "tile": lambda d, c: _grad_render(d, ("mat_diffuse",), c, tile=1024),
}


@pytest.mark.parametrize("what", list(MOVES))
def test_key_moves_with_grad_set_clamp_cfg_tile(keys, what):
    data, cam = _office_port()
    base = _key(keys, lambda: _grad_render(data, ("mat_diffuse",), cam))
    assert base[-2] is not None                     # the grad set
    assert _key(keys, lambda: _grad_render(data, ("mat_diffuse",),
                                           cam)) == base
    assert _key(keys, lambda: MOVES[what](data, cam)) != base


@pytest.mark.parametrize("what", ["in-place leaf update", "new camera"])
def test_key_stays_under_update_and_new_camera(keys, what):
    data, cam = _office_port()
    params = {k: v.detach().requires_grad_(k == "mat_diffuse")
              for k, v in split_params(data).items()}
    scene = merge_params(data, params)

    def call(c):
        return prender.render(scene, c, clamp=False)

    base = _key(keys, lambda: call(cam))
    if what == "in-place leaf update":
        with torch.no_grad():
            params["mat_diffuse"].mul_(0.5)
        assert _key(keys, lambda: call(cam)) == base
    else:
        moved = dataclasses.replace(cam, eye=cam.eye + 0.3,
                                    fovy=cam.fovy + 5.0)
        assert _key(keys, lambda: call(moved)) == base
        assert _key(keys, lambda: call(dataclasses.replace(
            cam, width=16))) != base


# --- (b) no host read in either region --------------------------------------

def test_regions_make_no_host_read(split, monkeypatch, case):
    """Both regions run under NoHostRead at their capture and at every
    replay (the kernels' plain versions apart: the card runs the
    kernels)."""
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, _unwatched(getattr(mod, name)))

    def watched(region, pool, mode):
        def run():
            with NoHostRead():
                region()
        split.append(region.__name__)
        run()
        return Direct(run)

    monkeypatch.setattr(graphs, "_record", watched)
    params = _leaves(case["port"])
    outs = [_call(case["port"], params, case["cam"], case["tgt"], case["cfg"])
            for _ in range(3)]
    assert split == ["forward", "backward"]
    for img, loss, grads in outs:
        assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())


# --- (c) the split path against the eager route and the reference ------------

def test_split_path_equals_eager_and_meets_reference(split, case):
    port, cam, tgt, cfg = case["port"], case["cam"], case["tgt"], case["cfg"]
    w = case["w"]
    assert w.mean() > 0.99
    params = _leaves(port)
    with graphs.disable_graphs():
        want = _call(port, params, cam, tgt, cfg, w)
    before = dict(graphs.COUNTS)
    # each call's leaves are new tensors over the same memory (the key's
    # addresses), as a loop that detaches its parameters makes them
    calls = [_call(port, {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}, cam, tgt, cfg, w)
             for _ in range(3)]
    assert _moved(graphs.COUNTS, before) == {
        "warm_ups": 1, "captures": 1, "backward_captures": 1, "replays": 2,
        "backward_replays": 2}
    assert split == ["forward", "backward"]
    for got in calls:
        _assert_bit_equal(got, want)

    ref, rcam, r_cfg = case["ref"], case["rcam"], case["r_cfg"]

    def r_loss_fn(p):
        img = rrender.render(r_merge_params(ref, p), rcam, cfg=r_cfg,
                             clamp=False)
        return jnp.sum(w[..., None] * (img - tgt) ** 2)
    r_loss, r_grads = jax.value_and_grad(r_loss_fn)(r_split_params(ref))
    _, loss, grads = calls[-1]
    _check_grads(loss, grads, r_loss, r_grads)


# --- (d) the pending rule ------------------------------------------------------

def test_second_forward_before_backward_runs_eagerly(split):
    """Two forwards of one key (two cameras of one size), then one backward
    of a loss over both: the second runs eagerly, and the gradients equal
    the all-eager call's to the bit."""
    data, cam = _office_port()
    cam2 = dataclasses.replace(cam, eye=cam.eye + torch.tensor([0.2, 0.1, 0]))
    tgt = np.full((32, 32, 3), 0.3, np.float32)
    params = _leaves(data)

    def both():
        scene = merge_params(data, params)
        a = prender.render(scene, cam, clamp=False)
        b = prender.render(scene, cam2, clamp=False)
        loss = _sse(a, tgt) + 0.5 * _sse(b, tgt)
        names = list(params)
        return loss.detach(), dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names], allow_unused=True)))

    with graphs.disable_graphs():
        want = both()
    _call(data, params, cam, tgt, tr.TraceConfig())       # warm-up
    _call(data, params, cam, tgt, tr.TraceConfig())       # capture
    before = dict(graphs.COUNTS)
    got = both()
    assert _moved(graphs.COUNTS, before) == {
        "replays": 1, "pending_eager": 1, "backward_replays": 1}
    # the forward values are the eager ones; each leaf's gradient sums the
    # two images' parts in another grouping
    assert torch.equal(got[0], want[0])
    for k, g in want[1].items():
        assert (g is None) == (got[1][k] is None), k
        if g is not None:
            _scaled_close(got[1][k].numpy(), g.numpy(), GRAD_REL, k)


def test_dropped_output_releases_the_key(split):
    data, cam = _office_port()
    tgt = np.full((32, 32, 3), 0.3, np.float32)
    params = _leaves(data)
    for _ in range(2):
        _call(data, params, cam, tgt, tr.TraceConfig())
    scene = merge_params(data, params)
    img = prender.render(scene, cam, clamp=False)
    entry = next(iter(graphs._CACHE.values()))
    assert graphs._pending(entry)
    before = dict(graphs.COUNTS)
    kept = prender.render(scene, cam, clamp=False)      # pending: eager
    assert _moved(graphs.COUNTS, before) == {"pending_eager": 1}
    del img
    gc.collect()
    assert not graphs._pending(entry)
    before = dict(graphs.COUNTS)
    again = prender.render(scene, cam, clamp=False)
    assert _moved(graphs.COUNTS, before) == {"replays": 1}
    assert torch.equal(again.detach(), kept.detach())


def test_pending_entry_survives_later_keys(split):
    data, cam = _office_port()
    tgt = np.full((32, 32, 3), 0.3, np.float32)
    params = _leaves(data)
    with graphs.disable_graphs():
        want = _call(data, params, cam, tgt, tr.TraceConfig())
    for _ in range(2):
        _call(data, params, cam, tgt, tr.TraceConfig())
    img = prender.render(merge_params(data, params), cam, clamp=False)
    pending = next(iter(graphs._CACHE.values()))
    for i in range(graphs.MAX_GRAPHS):
        prender.render(data, cam, tile=1024 * (i + 1))   # new no-grad keys
    assert any(e is pending for e in graphs._CACHE.values())
    assert graphs.cache_size() == graphs.MAX_GRAPHS
    loss = _sse(img, tgt)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    for (k, w), g in zip(want[2].items(), grads):
        assert torch.equal(w, torch.zeros_like(w) if g is None else g), k
    assert not graphs._pending(pending)
    prender.render(data, cam, tile=1024 * (graphs.MAX_GRAPHS + 1))
    assert not any(e is pending for e in graphs._CACHE.values())


# --- (e) a second backward; create_graph ----------------------------------------

@pytest.mark.parametrize("mode", ["retain_graph", "create_graph"])
def test_second_backward_and_create_graph(split, mode):
    data, cam = _office_port()
    tgt = np.full((32, 32, 3), 0.3, np.float32)
    params = _leaves(data)
    for _ in range(2):
        _call(data, params, cam, tgt, tr.TraceConfig())
    img = prender.render(merge_params(data, params), cam, clamp=False)
    loss = _sse(img, tgt)
    leaves = [params["mat_diffuse"], params["light_pos"], params["vertex_pos"]]
    if mode == "create_graph":
        with pytest.raises(RuntimeError, match="create_graph=True"):
            torch.autograd.grad(loss, leaves, create_graph=True)
        return
    before = dict(graphs.COUNTS)
    first = torch.autograd.grad(loss, leaves, retain_graph=True)
    second = torch.autograd.grad(loss, leaves)
    assert _moved(graphs.COUNTS, before) == {"backward_replays": 2}
    for a, b in zip(first, second):
        assert torch.equal(a, b) and float(a.abs().max()) > 0


# --- (f) capture failures --------------------------------------------------------

@pytest.mark.parametrize("which", ["forward", "backward"])
def test_capture_failure_names_forward_or_backward(split, monkeypatch,
                                                   which):
    record = graphs._record

    def failing(region, pool, mode):
        if region.__name__ == which:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return record(region, pool, mode)

    monkeypatch.setattr(graphs, "_record", failing)
    data, cam = _office_port()
    tgt = np.full((32, 32, 3), 0.3, np.float32)
    params = _leaves(data)
    _call(data, params, cam, tgt, tr.TraceConfig())
    with pytest.raises(graphs.GraphCaptureError,
                       match=rf"graph capture of render \({which}\) failed "
                             rf"at .*in failing"):
        _call(data, params, cam, tgt, tr.TraceConfig())
    entry = next(iter(graphs._CACHE.values()))
    assert entry.forward is None and entry.backward is None


# --- IF nodes in both regions ----------------------------------------------------

def test_split_path_through_if_nodes_equals_eager(split):
    """Segments 1.. under a stand-in IF node in both regions (as under the
    card's two captures; test_torch_cond's ``branching``): the forward
    region's topology and shading nodes and the backward region's nodes,
    which run from the backward's own call; image, loss and gradients
    equal the eager route's to the bit, and a second backward through the
    kept segments gives the same gradients."""
    ref, rcam, cfg, _ = _o04()
    port, cam = to_port(ref), _port_camera(rcam)
    assert port.n_segments == 3
    tgt = np.full((cam.height, cam.width, 3), 0.3, np.float32)
    params = _leaves(port)
    with graphs.disable_graphs():
        want = _call(port, params, cam, tgt, cfg)
    with branching() as seen:
        for _ in range(3):
            got = _call(port, params, cam, tgt, cfg)
        _assert_bit_equal(got, want)
        sites = [site for site, _ in seen]
        img = prender.render(merge_params(port, params), cam, cfg,
                             clamp=False)
        loss = _sse(img, tgt)
        leaves = [params["sphere_center"], params["mat_mirror"]]
        first = torch.autograd.grad(loss, leaves, retain_graph=True)
        second = torch.autograd.grad(loss, leaves)
    fwd = [f"segment {s} of {f}" for f in ("trace_topology", "trace_shade")
           for s in (1, 2)]
    bwd = [f"segment {s} of trace_shade (backward)" for s in (2, 1)]
    # the warm-up's forward and backward, the capture's forward then its
    # backward, and each replay's
    assert sites == (fwd + bwd) * 4
    for a, b in zip(first, second):
        assert torch.equal(a, b) and float(a.abs().max()) > 0
