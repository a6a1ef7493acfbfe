"""The port's forward render vs the reference's, end to end, and the
training step on every scene kind.

The reference renders through its fused path (cluster scan + fused
shading kernels, interpret mode on the CPU); the port renders through the
plain PyTorch versions of its kernels. Both get the identical packed
scene. Bar: >= 99.5% of pixels within 1e-4 and a mean abs diff <= 1e-4
(a flipped fp tie changes the hit triangle of a pixel, not the image).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import (FLAT as RFLAT, PHONG as RPHONG,
                                         TriangleMesh as RMesh)
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import intersect as risx
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import (
    render as rrender, render_loss_grad_image as r_loss_grad_image)
from myraytracer_tpu.parallel.shard_render import (
    split_params as r_split_params)
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.scenes import kinds

from test_torch_scene import mesh_scene, office, to_port

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)
#: the reference's authoring API, in the order scenes/kinds.py takes it
REF_API = (RScene, RMaterial, RMesh, RPHONG, RFLAT, r_uv_sphere)
GRAD_REL = 5e-4

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _agree(got, want):
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.995, (diff <= 1e-4).mean()
    assert np.abs(got - want).mean() <= 1e-4


def test_office_render_matches_reference():
    s = office("ref", tess=2, w=64, h=48)
    ref = s.build()
    want = np.asarray(rrender(ref, s.camera, cfg=REF_CFG))
    port = to_port(ref)
    got = prender.render(port, office("port", tess=2, w=64, h=48).camera)
    assert got.shape == (48, 64, 3) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and 0.05 < got.mean() < 0.95
    _agree(got, want)


def test_mirror_mesh_render_matches_reference():
    """Two lights and a mirror material: three Whitted segments."""
    s = mesh_scene("ref")
    s.meshes[1].material.mirror = 0.5
    ref = s.build()
    assert ref.n_segments == 3 and ref.n_lights == 2
    want = np.asarray(rrender(ref, s.camera, cfg=REF_CFG))
    got = prender.render(to_port(ref), mesh_scene("port").camera).numpy()
    _agree(got, want)


def test_tiled_render_equals_whole_frame():
    data = office("port", tess=2, w=64, h=48).build(device="cpu")
    cam = office("port", tess=2, w=64, h=48).camera
    whole = prender.render(data, cam)
    # 3 screen blocks per tile: the last tile is padded
    tiled = prender.render(data, cam, tile=3 * 1024)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_fit_tile_matches_reference_rule():
    from myraytracer_tpu.ops.render import _fit_tile as r_fit_tile

    for R, tile in ((2040 * 1024, 16384), (4096, 3072), (5 * 1024, 2048),
                    (1000, 512)):
        assert prender._fit_tile(R, tile, 1024) == r_fit_tile(R, tile, 1024)


def _kind_scene(what, pkg):
    """The mesh scene plus one visible sphere, plane or cylinder; the
    textured scene; or the mixed scene with mirrors, in either package."""
    api = kinds.PORT_API if pkg == "port" else REF_API
    if what.startswith("texture"):
        return kinds.textured_scene(w=32, h=24, api=api)
    if what == "mixed_mirror":
        return kinds.mixed_scene(mirror=0.35, w=32, h=24, api=api)
    if what == "triless":
        return kinds.mixed_scene(tris=False, w=32, h=24, api=api)
    s = mesh_scene(pkg)
    mat = api[1](diffuse=(0.3, 0.5, 0.6), specular=(0.4, 0.4, 0.4),
                 shininess=15)
    if what == "sphere":
        s.add_sphere((-1.3, 0.4, 0.6), 0.45, mat)
    elif what == "plane":
        s.add_plane((0, -1, 0), (0, 1, 0), mat)
    else:
        s.add_cylinder((-1.3, -0.1, 0.5), (0.1, 1, 0), 0.3, 1.2, mat)
    return s


#: (scene, texture_filter, the port's tri_method) of each training case
KIND_CASES = {"sphere": ("sphere", "nearest", "cluster"),
              "plane": ("plane", "nearest", "cluster"),
              "cylinder": ("cylinder", "nearest", "cluster"),
              "texture": ("texture", "nearest", "cluster"),
              "texture_bilinear": ("texture", "bilinear", "bvh"),
              "mixed_mirror": ("mixed_mirror", "nearest", "bvh"),
              "triless": ("triless", "nearest", "cluster")}


def _ref_cylinder_guarded(o, d, center, axis, radius, height):
    """The reference's ray_cylinder with its root behind a double where:
    the same values, and a finite gradient where disc <= 0."""
    dot = risx.dot_last
    oc = o - center
    d_par, oc_par = dot(d, axis), dot(oc, axis)
    a_v = d - d_par[..., None] * axis
    b_v = oc - oc_par[..., None] * axis
    a, b = dot(a_v, a_v), 2.0 * dot(a_v, b_v)
    c = dot(b_v, b_v) - radius * radius
    degenerate = a < 1e-12
    a_safe = jnp.where(degenerate, 1.0, a)
    disc = b * b - 4.0 * a_safe * c
    pos = disc > 0.0
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    inv2a = 0.5 / a_safe
    t0, t1 = (-b - sq) * inv2a, (-b + sq) * inv2a
    ok0 = (t0 > risx.EPS_HIT) & (jnp.abs(oc_par + t0 * d_par) <= height * 0.5)
    ok1 = (t1 > risx.EPS_HIT) & (jnp.abs(oc_par + t1 * d_par) <= height * 0.5)
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, risx.INF))
    valid = (~degenerate) & (disc >= 0.0) & (ok0 | ok1)
    return jnp.where(valid, t, risx.INF)


@pytest.mark.parametrize("what", list(KIND_CASES))
def test_unported_scene_kinds_raise(what, monkeypatch):
    """The scene kinds the training step once refused (spheres, planes,
    cylinders, textures with either filter, analytic mirrors, scenes
    without triangles) train
    through the autograd replay and match the reference's training step:
    loss within rtol 1e-5, every gradient within 5e-4 * max|a|, the keys
    of split_params. The reference runs its "brute" method, the cheapest
    on the CPU. The target is seeded noise, far from the render: a target
    close to it makes (c - target) tiny, and the gradient then carries
    the ~4e-6 by which XLA's fused CPU shading differs from the same
    expressions run op by op.

    The reference's cylinder gradients are NaN: its resolve_hit runs the
    cylinder test for every ray, and sqrt(max(disc, 0)) turns the zero
    cotangent of a ray with disc < 0 into NaN. The port guards the root;
    on scenes with a cylinder it is held against the reference with the
    same guard (the same values, patched in here)."""
    kind, filt, method = KIND_CASES[what]
    rs = _kind_scene(kind, "ref")
    ref = rs.build()
    port = to_port(ref)
    cam = _kind_scene(kind, "port").camera
    cfg = tr.TraceConfig(tri_method=method, texture_filter=filt)
    assert not cfg.fused_grad(port)
    img = prender.render(prender.restore_mirror_chain(port), cam, cfg=cfg)
    assert bool(torch.isfinite(img).all())
    rng = np.random.default_rng(len(what))
    target = rng.uniform(0.0, 1.0, tuple(img.shape)).astype(np.float32)
    r_cfg = rtr.TraceConfig(tri_method="brute", texture_filter=filt)
    if what == "cylinder":
        _, r_nan = r_loss_grad_image(ref, rs.camera, jnp.asarray(target),
                                     cfg=r_cfg)
        assert not np.isfinite(np.asarray(r_nan["cyl_axis"])).all()
    if ref.n_cylinders:
        # the reference's compiled programs are cached by shape: trace
        # anew with the guard, and drop the guarded programs afterwards
        jax.clear_caches()
        monkeypatch.setattr(risx, "ray_cylinder", _ref_cylinder_guarded)
    try:
        r_loss, r_grads = r_loss_grad_image(
            ref, rs.camera, jnp.asarray(target), cfg=r_cfg)
    finally:
        if ref.n_cylinders:
            jax.clear_caches()
    loss, grads = prender.render_loss_grad_image(
        port, cam, torch.from_numpy(target), cfg=cfg)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert list(grads) == list(r_split_params(ref)) and len(grads) == 23
    for k, want in r_grads.items():
        want = np.asarray(want)
        got = grads[k].numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), k
        tol = GRAD_REL * max(float(np.abs(want).max()) if want.size else 0.0,
                             1e-3)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)
    # the gradient reaches the new kind's own parameters
    reach = {"sphere": "sphere_center", "plane": "plane_normal",
             "cylinder": "cyl_center", "texture": "texels",
             "mixed_mirror": "mat_mirror", "triless": "sphere_radius"}[kind]
    assert np.abs(np.asarray(r_grads[reach])).max() > 0, reach
    if filt == "bilinear":
        assert np.abs(np.asarray(r_grads["uv_u"])).max() > 0


def test_trace_shade_picks_the_segment_by_scene_content(monkeypatch):
    """The fused K5/K6 segment on an untextured triangle-only scene with a
    light (the reference's resolved_fused_shade_grad), the autograd
    replay on a scene with a sphere, whatever fused_shade_grad says."""
    calls = []
    for name in ("_fused_segment", "_replay_segment"):
        fn = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    office_s = office("port", tess=2, w=32, h=32)
    sphere_s = _kind_scene("sphere", "port")
    for s in (office_s, sphere_s):
        data = s.build(device="cpu")
        o, d = prender.primary_rays_blocked(s.camera, "cpu")
        topo = tr.trace_topology(data, o, d)
        calls.clear()
        tr.trace_shade(data, o, d, topo)
        want = "_fused_segment" if s is office_s else "_replay_segment"
        assert calls and set(calls) == {want}, calls
    office_d = office_s.build(device="cpu")
    assert tr.TraceConfig().fused_grad(office_d)
    assert not tr.TraceConfig(fused_shade_grad=False).fused_grad(office_d)
    assert not tr.TraceConfig().fused_grad(sphere_s.build(device="cpu"))


def test_plain_config_runs_the_same_path_on_cpu():
    data = office("port", tess=2, w=32, h=32).build(device="cpu")
    cam = office("port", tess=2, w=32, h=32).camera
    a = prender.render(data, cam)
    b = prender.render(data, cam, cfg=tr.TraceConfig(plain=True))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


#: the entry points that take cfg and tile
ENTRY_POINTS = ("render", "render_aa", "render_loss_grad",
                "render_loss_grad_image")


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_take_cfg_before_tile(entry, monkeypatch):
    """The reference's parameter order (cfg, then tile): a TraceConfig
    passed by position reaches the tracer, and the call equals the one
    by keyword."""
    import inspect

    from myraytracer_tpu.ops import render as rrender_mod

    from myraytracer_tpu_torch.ops import traverse as trv

    ref_fn = getattr(rrender_mod, entry if entry in ("render", "render_aa")
                     else "_" + entry)
    want_names = list(inspect.signature(ref_fn).parameters)
    got_names = list(inspect.signature(getattr(prender, entry)).parameters)
    assert got_names.index("cfg") == want_names.index("cfg")
    assert got_names.index("tile") == want_names.index("tile")
    if entry == "render":
        assert got_names[:5] == want_names[:5]

    s = office("port", tess=2, w=64, h=48)
    data, cam = s.build(device="cpu"), s.camera
    o, d = prender.primary_rays_blocked(cam, "cpu")
    rng = np.random.default_rng(0)
    img_t = torch.from_numpy(rng.uniform(size=(48, 64, 3)).astype(np.float32))
    lead = {"render": (data, cam), "render_aa": (data, cam),
            "render_loss_grad": (data, o, d, torch.zeros_like(o)),
            "render_loss_grad_image": (data, cam, img_t)}[entry]
    fn = getattr(prender, entry)
    calls = []
    brute = trv.intersect_tris_brute
    monkeypatch.setattr(trv, "intersect_tris_brute",
                        lambda *a, **k: (calls.append(1), brute(*a, **k))[1])
    cfg = tr.TraceConfig(tri_method="brute")
    got = fn(*lead, cfg, 2048)
    assert calls, "the positional cfg did not reach the tracer"
    want = fn(*lead, cfg=cfg, tile=2048)
    if entry.startswith("render_loss"):
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    else:
        assert torch.equal(got, want)


def test_render_unclamped_matches_reference():
    """render(..., clamp=False) is the reference's unclamped linear image:
    with the light raised, colors pass 1, and clamping them gives the
    default render."""
    s = office("ref", tess=2, w=64, h=48)
    s.lights = [type(lt)(lt.position, (2.5, 2.5, 2.5)) for lt in s.lights]
    ref = s.build()
    want = np.asarray(rrender(ref, s.camera, cfg=REF_CFG, clamp=False))
    port = to_port(ref)
    cam = office("port", tess=2, w=64, h=48).camera
    got = prender.render(port, cam, clamp=False)
    assert float(got.max()) > 1.0 and want.max() > 1.0
    _agree(got.numpy(), want)
    torch.testing.assert_close(prender.render(port, cam),
                               torch.clamp(got, max=1.0), rtol=0, atol=0)
