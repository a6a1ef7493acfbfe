"""The port's differentiable forward vs the reference's.

The reference's ``trace`` and ``render(clamp=False)`` are differentiable
by ``jax.grad`` in every scene leaf and in the rays, and sample textures
bilinearly when asked: they shade through XLA (``fused_shade=False``).
The port's ``trace`` takes the replay route there (the topology without
gradients, then ``trace_shade``), and its K3/K4 chain everywhere else;
the forward-only entry points (``render(clamp=True)``, ``render_aa``,
the sharded forwards) keep the chain. Both packages get the identical
packed scene (``to_port``) and the same rays; the port runs the plain
versions of its kernels (CPU tensors).

Tolerances:
  * losses within rtol 1e-5, every gradient within 5e-4 * max|ref| per
    leaf (GRAD_REL, the training step's bar);
  * images at the render bar: >= 99.5% of pixels within 1e-4;
  * the palette fit's losses within rtol 1e-4 over three Adam steps (the
    Adam updates of the two packages round apart).
"""

import dataclasses
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from myraytracer_tpu.ops import render as rrender
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.parallel.shard_render import (
    merge_params as r_merge_params, split_params as r_split_params)
from myraytracer_tpu.scenes.golden import GOLDEN_SCENES as R_GOLDEN_SCENES
from myraytracer_tpu.utils.image import read_png

from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel import shard_render as sr
from myraytracer_tpu_torch.parallel.mesh import make_mesh
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

from test_grad import grad_scene, textured_scene
from test_torch_render import _kind_scene
from test_torch_scene import office, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 5e-4
#: the loss's channel weights (tests/test_grad.py's loss_of)
CHANNELS = np.asarray([0.3, 0.5, 0.2], np.float32)

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _scaled_close(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    tol = rel * max(float(np.abs(want).max()) if want.size else 0.0, 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def _render_bar(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.995, (diff <= 1e-4).mean()


def _leaves(port):
    """The port scene's float leaves as fresh leaves that require grad."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in split_params(port).items()}


def _port_grads(loss, params):
    names = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, got)}


def _check_grads(loss, grads, r_loss, r_grads):
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-5)
    assert sorted(grads) == sorted(r_grads)
    for k, want in r_grads.items():
        _scaled_close(grads[k].numpy(), np.asarray(want), GRAD_REL, k)


# --- trace under autograd ---------------------------------------------------

#: (scene, texture filter) of each trace case
TRACE_CASES = {"grad_scene": (grad_scene, "nearest"),
               "textured_bilinear": (textured_scene, "bilinear")}


@pytest.fixture(scope="module", params=list(TRACE_CASES))
def trace_case(request):
    make, filt = TRACE_CASES[request.param]
    s = make()
    ref = s.build()
    cam = s.camera
    xs, ys = cam.pixel_grid()
    o, d = cam.primary_rays(xs.ravel(), ys.ravel())
    return dict(name=request.param, filt=filt, ref=ref, port=to_port(ref),
                r_o=o, r_d=d, o=torch.from_numpy(np.array(o)),
                d=torch.from_numpy(np.array(d)))


def test_trace_grad_matches_reference(trace_case):
    """The port's trace under autograd against jax.value_and_grad of the
    reference's trace, every pixel, loss sum(trace * CHANNELS)."""
    c = trace_case
    r_cfg = rtr.TraceConfig(texture_filter=c["filt"])
    ref = c["ref"]

    def r_loss_fn(p):
        return jnp.sum(rtr.trace(r_merge_params(ref, p), c["r_o"], c["r_d"],
                                 r_cfg) * CHANNELS)
    r_loss, r_grads = jax.value_and_grad(r_loss_fn)(r_split_params(ref))

    params = _leaves(c["port"])
    color = tr.trace(merge_params(c["port"], params), c["o"], c["d"],
                     tr.TraceConfig(texture_filter=c["filt"]))
    loss = torch.sum(color * torch.from_numpy(CHANNELS))
    grads = _port_grads(loss, params)
    _check_grads(loss, grads, r_loss, r_grads)
    if c["filt"] == "bilinear":
        # the bilinear fetch reaches the texels and both UV tables
        for k in ("texels", "uv_u", "uv_v"):
            assert float(grads[k].abs().max()) > 0, k
    else:
        for k in ("sphere_center", "vertex_pos", "mat_mirror", "light_pos"):
            assert float(grads[k].abs().max()) > 0, k


def test_trace_bilinear_forward_matches_reference():
    """trace with "bilinear" on a textured scene under no_grad: the
    reference's bilinear forward, at the render bar; the nearest texel
    gives another image."""
    s = textured_scene()
    ref = s.build()
    xs, ys = s.camera.pixel_grid()
    o, d = s.camera.primary_rays(xs.ravel(), ys.ravel())
    want = np.asarray(rtr.trace(ref, o, d,
                                rtr.TraceConfig(texture_filter="bilinear")))
    port = to_port(ref)
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    with torch.no_grad():
        got = tr.trace(port, to, td, tr.TraceConfig(texture_filter="bilinear"))
        nearest = tr.trace(port, to, td)
    assert got.grad_fn is None
    _render_bar(got.numpy(), want)
    assert np.abs(nearest.numpy() - want).max() > 1e-2


# --- render(clamp=False) under autograd -------------------------------------

def _sphere_scene(pkg):
    return _kind_scene("sphere", pkg)


RENDER_CASES = {"office": lambda pkg: office(pkg, tess=2, w=64, h=48),
                "sphere": _sphere_scene}


@pytest.mark.parametrize("name", list(RENDER_CASES))
def test_render_unclamped_grad_matches_reference(name):
    """The port of the reference's
    test_render_clamp_false_stays_differentiable, with values: the SSE of
    render(clamp=False) against a seeded target, its loss and every
    gradient against jax.grad of the reference's render(clamp=False)
    (its "brute" method, the cheapest on the CPU)."""
    rs = RENDER_CASES[name]("ref")
    ref = rs.build()
    cam = RENDER_CASES[name]("port").camera
    tgt = np.random.default_rng(8).uniform(
        0, 1, (cam.height, cam.width, 3)).astype(np.float32)
    r_cfg = rtr.TraceConfig(tri_method="brute")

    def r_loss_fn(p):
        img = rrender.render(r_merge_params(ref, p), rs.camera, cfg=r_cfg,
                             clamp=False)
        return jnp.sum((img - tgt) ** 2)
    r_loss, r_grads = jax.value_and_grad(r_loss_fn)(r_split_params(ref))

    port = to_port(ref)
    params = _leaves(port)
    img = prender.render(merge_params(port, params), cam, clamp=False)
    assert img.shape == (cam.height, cam.width, 3) and img.requires_grad
    loss = torch.sum((img - torch.from_numpy(tgt)) ** 2)
    _check_grads(loss, _port_grads(loss, params), r_loss, r_grads)
    # the image under grad meets the render bar against the no-grad one
    _render_bar(img.detach().numpy(),
                prender.render(port, cam, clamp=False).numpy())


def test_tiled_unclamped_render_grads_equal_one_batch(route):
    """render(clamp=False, tile=...) under autograd: every tile takes the
    replay route over one shared pack, and the image and gradients equal
    the one-batch call's."""
    s = office("port", tess=2, w=64, h=48)
    data = s.build(device="cpu")
    tgt = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (48, 64, 3)).astype(np.float32))
    out = {}
    for tile in (None, 1024):
        params = _leaves(data)
        img = prender.render(merge_params(data, params), s.camera, tile=tile,
                             clamp=False)
        loss = torch.sum((img - tgt) ** 2)
        out[tile] = (img.detach(), loss.detach(), _port_grads(loss, params))
    assert route.count("trace_shade") == 1 + 4  # 64 x 64 padded rays
    (img1, l1, g1), (img4, l4, g4) = out[None], out[1024]
    np.testing.assert_allclose(img4.numpy(), img1.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for k in g1:
        _scaled_close(g4[k].numpy(), g1[k].numpy(), 1e-5, k)


def test_render_unclamped_grad_reaches_the_camera():
    """A camera whose eye requires grad: the rays reach trace_shade
    undetached, so the pose gets a gradient (the reference's pixel
    mode)."""
    s = office("port", tess=2, w=32, h=32)
    data = s.build(device="cpu")
    eye = s.camera.eye.clone().requires_grad_(True)
    cam = dataclasses.replace(s.camera, eye=eye)
    img = prender.render(data, cam, clamp=False)
    (g,) = torch.autograd.grad(img.sum(), [eye])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# --- the route ----------------------------------------------------------------

@pytest.fixture
def route(monkeypatch):
    """Counts the calls of segment_step (the K3/K4 chain, which the
    topology pass runs too), trace_topology and trace_shade (the replay
    route)."""
    calls = []
    for name in ("segment_step", "trace_topology", "trace_shade"):
        fn = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


def _port_camera(rcam):
    """The port's camera of a reference camera."""
    return prender.Camera.make(np.array(rcam.eye), np.array(rcam.center),
                               np.array(rcam.up), float(rcam.fovy),
                               rcam.width, rcam.height)


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo ray mesh in this process, destroyed after the
    module (the graphs first)."""
    m = make_mesh(1, "cpu")
    yield m
    graphs.clear()
    dist.destroy_process_group()


def _textured_port():
    s = textured_scene()
    port = to_port(s.build())
    xs, ys = s.camera.pixel_grid()
    o, d = s.camera.primary_rays(xs.ravel(), ys.ravel())
    return port, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


@pytest.mark.parametrize("case,want", [
    ("nearest no_grad", "segment_step"),
    ("nearest, a scene leaf requires grad", "trace_shade"),
    ("nearest, the rays require grad", "trace_shade"),
    ("nearest, grad mode off", "segment_step"),
    ("bilinear no_grad", "trace_shade"),
    ("bilinear, untextured scene", "segment_step"),
])
def test_trace_route(route, case, want):
    port, o, d = _textured_port()
    cfg = tr.TraceConfig(texture_filter="bilinear" if "bilinear" in case
                         else "nearest")
    if "untextured" in case:
        port = office("port", tess=2, w=16, h=16).build(device="cpu")
    if "scene leaf" in case or "grad mode off" in case:
        port = dataclasses.replace(
            port, mat_diffuse=port.mat_diffuse.clone().requires_grad_(True))
    if "rays" in case:
        d = d.clone().requires_grad_(True)
    with torch.set_grad_enabled("no_grad" not in case
                                and "grad mode off" not in case):
        assert tr.replays(port, o, d, cfg) == (want == "trace_shade")
        out = tr.trace(port, o, d, cfg)
    replay = {"segment_step", "trace_topology", "trace_shade"}
    assert set(route) == (replay if want == "trace_shade"
                          else {"segment_step"}), route
    assert out.requires_grad == (want == "trace_shade"
                                 and "bilinear" not in case)


@pytest.mark.parametrize("entry", ["render", "render_aa", "render_sharded",
                                   "render_aa_sharded"])
def test_forward_only_entry_points_never_replay(route, mesh, entry):
    """render(clamp=True), render_aa and the sharded forwards run the
    K3/K4 chain under no_grad with the nearest texel, even for a scene
    whose leaves require grad and a "bilinear" config, and give the
    image of the plain call."""
    s = textured_scene()
    port = to_port(s.build())
    cam = _port_camera(s.camera)
    leafy = dataclasses.replace(
        port, texels=port.texels.clone().requires_grad_(True))
    cfg = tr.TraceConfig(texture_filter="bilinear")
    if entry.endswith("sharded"):
        fn = getattr(sr, entry)
        call = (lambda sc, c: fn(sc, cam, mesh, c))
    else:
        fn = getattr(prender, entry)
        call = (lambda sc, c: fn(sc, cam, c))
    got = call(leafy, cfg)
    assert set(route) == {"segment_step"}, route
    assert not got.requires_grad
    assert torch.equal(got, call(port, tr.TraceConfig()))


def test_grad_recording_render_makes_its_own_key(monkeypatch):
    """No eager rule for a call that records autograd any more
    (graphs.runs_eagerly has no records_grad clause): on a stand-in CUDA
    device (no eager rule, the warm-up a direct call) a grad-recording
    render(clamp=False) makes one key, whose grad set names the leaf that
    requires grad; the no-grad and clamp=True calls keep keys of their
    own."""
    assert "records_grad" not in inspect.signature(
        graphs.runs_eagerly).parameters
    assert not graphs.runs_eagerly("cuda")
    monkeypatch.setattr(graphs, "runs_eagerly",
                        lambda device, group=None: False)
    monkeypatch.setattr(graphs, "_warm_up", lambda call, device: call())
    graphs.clear()
    s = office("port", tess=2, w=32, h=32)
    data = s.build(device="cpu")
    leafy = dataclasses.replace(
        data, mat_diffuse=data.mat_diffuse.clone().requires_grad_(True))
    img = prender.render(leafy, s.camera, clamp=False)
    assert img.requires_grad and graphs.cache_size() == 1
    (key,) = graphs._CACHE
    staged_grad, held_grad = key[-2]
    static, held = graphs.scene_inputs(leafy)
    assert staged_grad == (False,) and held_grad == tuple(
        t is leafy.mat_diffuse for t in held)
    with torch.no_grad():
        prender.render(leafy, s.camera, clamp=False)
    prender.render(leafy, s.camera)
    keys = list(graphs._CACHE)
    assert len(keys) == 3 and keys[0] == key
    assert keys[1][-2] is None and keys[2][-2] is None
    assert keys[1][1] != keys[2][1]                  # clamp is static
    graphs.clear()


# --- the palette fit ------------------------------------------------------------

def _reference_fit(scene, steps, scale, lr):
    """The losses of tools/fit_palette.py's loop (its main reads the
    reference PNG from another checkout): its cells_jnp and FIT_LEAVES,
    the reference's trace, optax's Adam and the same clip."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fit_palette as ref_tool

    builder, _ = R_GOLDEN_SCENES[scene]
    sc = builder(scale=scale)
    data = sc.build()
    ref_cells = ref_tool.cells_jnp(jnp.asarray(
        read_png(os.path.join(REPO, "outputs", f"{scene}.png"))))
    xs, ys = sc.camera.pixel_grid()
    o, d = sc.camera.primary_rays(xs.ravel(), ys.ravel())
    H, W = sc.camera.height, sc.camera.width
    params = {n: getattr(data, n) for n in ref_tool.FIT_LEAVES}

    def loss_fn(p):
        img = jnp.minimum(rtr.trace(r_merge_params(data, p), o, d)
                          .reshape(H, W, 3), 1.0)
        dc = ref_tool.cells_jnp(img) - ref_cells
        return jnp.mean(dc * dc)

    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(p, st):
        loss, g = jax.value_and_grad(loss_fn)(p)
        up, st = opt.update(g, st, p)
        p = optax.apply_updates(p, up)
        p = {k: jnp.clip(v, 0.0, 1.5 if k.startswith("mat") or k in
                         ("ambience", "background") else 2.0)
             for k, v in p.items()}
        return p, st, loss

    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return ref_tool.FIT_LEAVES, losses


def test_fit_palette_matches_reference_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fit_palette_torch as port_tool

    leaves, want = _reference_fit("o_07_toon_faces", 3, 0.05, 2e-2)
    assert port_tool.FIT_LEAVES == leaves
    got = port_tool.fit("o_07_toon_faces", 3, 0.05, 2e-2, "cpu",
                        log=lambda _: None)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    for k, v in got["params"].items():
        assert float(v.min()) >= 0.0 and float(v.max()) <= (
            port_tool.clip_max(k)), k


def test_fit_palette_cli_runs_on_the_cpu(capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fit_palette_torch as port_tool

    assert port_tool.main(["o_05_cube", "--steps", "2", "--scale", "0.04",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step 0: cell-mse" in out and "step 1: cell-mse" in out
    assert "final cell delta" in out and "--- mat_diffuse ---" in out
