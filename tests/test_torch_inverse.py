"""The port's inverse rendering (inverse.py) and profiling helpers vs the
reference's.

Both packages fit the identical packed scene (tests/test_grad.py's
grad_scene, carried across unchanged) from the same rays and targets,
made from NumPy seeds; the targets are the port's traces of the true
scene. The port fits with its default configuration (the BVH walk, plain
versions on the CPU); the reference runs its jitted optax step with the
brute-force triangle oracle, whose hits its own tests hold equal to its
walk's, and which compiles in a fraction of the walk's time.
Bars: losses per step within rtol 1e-4 for materials (ray mode) and
1e-3 for the camera pose (pixel mode, where the ray origins and
directions carry the gradient); the fitted parameters within atol 1e-5.
A checkpointed fit resumed in a new renderer equals an uninterrupted one
within 1e-7.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myraytracer_tpu.inverse import InverseRenderer as RInverseRenderer
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.utils import profiling as rprofiling

from myraytracer_tpu_torch.inverse import (CAMERA_PARAMS, InverseRenderer,
                                           adam, camera_with)
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.utils.profiling import (Timer, profile_trace,
                                                   render_metrics,
                                                   scene_footprint_bytes)

from test_torch_checks import central_pixels, grad_case

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

AUTO = tr.TraceConfig(tri_method="auto")
#: the reference's InverseRenderer configuration with the brute oracle
REF_CFG = rtr.TraceConfig(tri_method="brute", texture_filter="bilinear")


@pytest.fixture(scope="module")
def setup():
    s, ref, port, cam = grad_case()
    xs, ys = central_pixels(cam, 120, 0.2, 9)
    o, d = (x.contiguous() for x in cam.primary_rays(torch.from_numpy(xs),
                                                     torch.from_numpy(ys)))
    target = tr.trace(port, o, d, AUTO)
    return dict(s=s, ref=ref, port=port, cam=cam, o=o, d=d, target=target)


def _scaled(ref, port, field, k):
    return (dataclasses.replace(ref, **{field: getattr(ref, field) * k}),
            dataclasses.replace(port, **{field: getattr(port, field) * k}))


def test_adam_steps_match_reference(setup):
    """Five Adam steps on mat_diffuse from a darkened scene, in ray mode."""
    ref, port = _scaled(setup["ref"], setup["port"], "mat_diffuse", 0.4)
    o, d, target = setup["o"], setup["d"], setup["target"]
    want = RInverseRenderer(ref, param_names=("mat_diffuse",),
                            optimizer=optax.adam(5e-2), cfg=REF_CFG).fit(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(target.numpy()), steps=5)
    inv = InverseRenderer(port, param_names=("mat_diffuse",),
                          optimizer=adam(5e-2))
    got = inv.fit(o, d, target, steps=5)
    assert got.losses[-1] < 0.5 * got.losses[0]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose(got.params["mat_diffuse"].numpy(),
                               np.asarray(want.params["mat_diffuse"]),
                               atol=1e-5)
    assert inv.step_count == 5
    assert torch.equal(got.scene.mat_diffuse, got.params["mat_diffuse"])


def test_camera_pose_steps_match_reference(setup):
    """Eight Adam steps on cam_eye in pixel mode: the rays are formed from
    the current eye every step."""
    s, ref, port, cam = setup["s"], setup["ref"], setup["port"], setup["cam"]
    rng = np.random.default_rng(21)
    xs = rng.uniform(cam.width * 0.25, cam.width * 0.75, 128).astype(np.float32)
    ys = rng.uniform(cam.height * 0.25, cam.height * 0.75, 128).astype(np.float32)
    o, d = cam.primary_rays(torch.from_numpy(xs), torch.from_numpy(ys))
    target = tr.trace(port, o.contiguous(), d, AUTO)
    shift = np.asarray([0.08, -0.06, 0.0], np.float32)
    r_cam = dataclasses.replace(s.camera, eye=s.camera.eye + shift)
    p_cam = dataclasses.replace(cam, eye=cam.eye + torch.from_numpy(shift))
    want = RInverseRenderer(ref, param_names=("cam_eye",),
                            optimizer=optax.adam(1e-2), camera=r_cam,
                            cfg=REF_CFG).fit_pixels(
        xs, ys, jnp.asarray(target.numpy()), steps=8)
    inv = InverseRenderer(port, param_names=("cam_eye",),
                          optimizer=adam(1e-2), camera=p_cam)
    got = inv.fit_pixels(xs, ys, target, steps=8)
    assert np.isfinite(got.losses).all() and min(got.losses) < got.losses[0]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    np.testing.assert_allclose(got.camera.eye.numpy(),
                               np.asarray(want.camera.eye), atol=1e-5)
    assert not torch.equal(got.camera.eye, p_cam.eye)
    # fit(o, d) is refused while the camera is fitted
    with pytest.raises(ValueError, match="fit_pixels"):
        inv.fit(o, d, target, steps=1)


def test_mirror_grows_from_zero(setup):
    """A mirror-free scene traces one segment; fitting mat_mirror traces
    the full chain whatever the mirrors' values, so the mirror can grow
    from 0 (the sphere's is 0.3 in the target)."""
    port = setup["port"]
    flat = dataclasses.replace(
        port, mat_mirror=torch.zeros_like(port.mat_mirror), live_depth=1)
    assert flat.n_segments == 1
    inv = InverseRenderer(flat, param_names=("mat_mirror",),
                          optimizer=adam(3e-2))
    assert inv.base_scene.n_segments == port.max_depth + 1
    res = inv.fit(setup["o"], setup["d"], setup["target"], steps=6)
    assert res.losses[-1] < res.losses[0]
    assert float(res.params["mat_mirror"].max()) > 0.05


@pytest.mark.parametrize("kw,err", [
    (dict(param_names=("tri_vidx",)), ValueError),
    (dict(param_names=("bvh_bbmin",)), ValueError),
    (dict(param_names=("cam_eye",)), ValueError),
    (dict(mesh=object()), NotImplementedError),
])
def test_rejects(kw, err, setup):
    with pytest.raises(err):
        InverseRenderer(setup["port"], **kw)


def test_camera_leaves(setup):
    cam = setup["cam"]
    inv = InverseRenderer(setup["port"], camera=cam)
    assert set(CAMERA_PARAMS) <= set(inv.params) and len(inv.params) == 27
    eye = torch.tensor([1.0, 2.0, 3.0])
    moved = camera_with(cam, {"cam_eye": eye, "mat_diffuse": None})
    assert moved.eye is eye and moved.center is cam.center
    assert camera_with(cam, {}) is cam


def test_checkpoint_resume(setup, tmp_path):
    """Three steps, a checkpoint, and two more in a new renderer equal five
    uninterrupted steps."""
    _, port = _scaled(setup["ref"], setup["port"], "mat_diffuse", 0.5)
    o, d, target = setup["o"], setup["d"], setup["target"]

    def fresh():
        return InverseRenderer(port, param_names=("mat_diffuse", "light_color"),
                               optimizer=adam(3e-2))

    whole = fresh().fit(o, d, target, steps=5)
    first = fresh()
    first.fit(o, d, target, steps=3)
    ck = str(tmp_path / "ckpt")
    first.save_checkpoint(ck)
    second = fresh()
    second.restore_checkpoint(ck)
    assert second.step_count == 3
    for k in first.params:
        assert torch.equal(second.params[k], first.params[k]), k
    rest = second.fit(o, d, target, steps=2)
    assert second.step_count == 5
    np.testing.assert_allclose(rest.losses, whole.losses[3:], rtol=1e-6)
    for k, v in whole.params.items():
        np.testing.assert_allclose(rest.params[k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)
    other = InverseRenderer(port, param_names=("mat_diffuse",))
    with pytest.raises(ValueError, match="checkpoint holds"):
        other.restore_checkpoint(ck)


def test_timer_and_metrics(setup, tmp_path):
    s, ref, data = setup["s"], setup["ref"], setup["port"]
    out, secs = Timer.timed(tr.trace, data, setup["o"], setup["d"])
    assert secs > 0 and bool(torch.isfinite(out).all())
    with Timer("block") as t:
        tr.trace(data, setup["o"], setup["d"])
    assert t.elapsed > 0
    cam = s.camera
    m = render_metrics(data, cam.width, cam.height, render_s=secs, build_s=0.5)
    want = rprofiling.render_metrics(ref, cam.width, cam.height, render_s=secs,
                                     build_s=0.5)
    assert set(m) == set(want)
    for k in ("resolution", "rays", "rays_per_s", "n_tris", "n_spheres",
              "n_planes", "n_cylinders", "n_lights", "bvh_nodes", "max_depth",
              "scene_bytes", "build_s"):
        assert m[k] == want[k], k
    assert m["scene_bytes"] == scene_footprint_bytes(data) > 0
    assert m["bvh_nodes"] == data.n_nodes and m["device"] == "cpu"
    with profile_trace(str(tmp_path / "prof")) as prof:
        tr.trace(data, setup["o"][:16].contiguous(), setup["d"][:16])
    assert len(prof.key_averages()) > 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
