"""The port against the fp64 scalar oracle (tests/oracle.py, used as it is).

Counterparts of tests/test_golden.py (sampled pixels at SCALE 0.08, atol
4e-3; 6e-3 on the mirror scene), tests/test_oracle_full.py (the whole
image at SCALE 0.1 within atol 4e-3, every pixel beyond it certified a
closest-hit tie or ill-conditioned by the oracle and at most 0.4% of the
image excused; render_aa against the oracle's AA rule on two scenes),
tests/test_oracle_native.py (sampled pixels at each golden's native
resolution through render and the budgeted render_aa, atol 4e-3 and 6e-3)
and tests/test_two_phase.py. OracleRenderer reads the scene through
``np.asarray``, so it takes the port's CPU SceneData directly.

Two-phase: (a) trace_shade(trace_topology(...)) equals trace(...)
within rtol/atol 1e-6 on a scene with every primitive kind, a texture,
shadows and a mirror chain; (b) the port's two-phase loss and gradients
on that scene against the reference's two-phase ones (the port has no
full-remat path), loss within rtol 1e-5 and every gradient within
5e-4 x max|reference| (tests/test_torch_render.py's bar; the reference's
cylinder root guarded as there), the rays whose colours differ by more
than 1e-5 weighted 0 once the oracle certifies each ill-conditioned.

The fast tier runs part (a) and the sampled pixels of the cheap scenes;
the rest is slow, as in the reference.
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
from myraytracer_tpu.ops import render as rrender
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.scenes import shapes as rshapes

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, PHONG, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops.render import (AA_SUBP, AA_THRESHOLD, _aa_rays,
                                              render, render_aa)
from myraytracer_tpu_torch.scenes import golden
from myraytracer_tpu_torch.scenes import shapes

from oracle import OracleRenderer
from test_golden import _sample_rays
from test_torch_render import GRAD_REL, _ref_cylinder_guarded
from test_torch_scene import to_port

torch.set_num_threads(1)

SCALE = 0.08
ATOL = 4e-3
#: 16 fp32 subray traces and their mean round a little more
ATOL_AA = 6e-3

#: sampled-pixel scenes in the fast tier (each well under 20 s in one
#: process); the others are slow
FAST = ("o_01_spheres", "o_02_shadow", "o_05_cube", "o_08_office",
        "o_10_pokemon")
SAMPLED = ("o_01_spheres", "o_02_shadow", "o_04_molecule", "o_05_cube",
           "o_06_mask", "o_07_toon_faces", "o_08_office", "o_09_rings",
           "o_10_pokemon")


def built(name, scale):
    sc = golden.GOLDEN_SCENES[name][0](scale=scale)
    return sc, sc.build(device="cpu")


def excused(orc, x, y, delta) -> bool:
    return (orc.is_tie_pixel(int(x), int(y))
            or orc.is_ill_conditioned_pixel(int(x), int(y), float(delta)))


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n in FAST else pytest.mark.slow)
    for n in SAMPLED])
def test_sampled_pixels_match_oracle(name):
    sc, data = built(name, SCALE)
    img = render(data, sc.camera).numpy()
    orc = OracleRenderer(data, sc.camera)
    xs, ys, eye, dirs = _sample_rays(sc.camera, 20, seed=1)
    for x, y, d in zip(xs, ys, dirs):
        want = np.minimum(orc.trace(eye, d), 1.0)
        np.testing.assert_allclose(img[y, x], want, atol=ATOL,
                                   err_msg=f"{name} pixel ({x},{y})")


def test_mirror_scene_oracle_subset():
    # o_03 has max_depth 20: a few pixels
    sc, data = built("o_03_mirror", SCALE)
    img = render(data, sc.camera).numpy()
    orc = OracleRenderer(data, sc.camera)
    xs, ys, eye, dirs = _sample_rays(sc.camera, 6, seed=2)
    for x, y, d in zip(xs, ys, dirs):
        want = np.minimum(orc.trace(eye, d), 1.0)
        np.testing.assert_allclose(img[y, x], want, atol=6e-3)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_full_image_allclose_vs_oracle(name):
    sc, data = built(name, 0.1)
    img = render(data, sc.camera).numpy()
    orc = OracleRenderer(data, sc.camera)
    delta = np.abs(img - orc.render()).max(-1)
    bad = np.argwhere(delta > ATOL)
    not_tie = [(int(x), int(y), float(delta[y, x])) for y, x in bad
               if not excused(orc, x, y, delta[y, x])]
    assert not not_tie, (
        f"{name}: pixels disagree with the oracle beyond atol={ATOL} and "
        f"are not ambiguous ties or silhouettes: {not_tie[:8]}")
    assert len(bad) <= max(2, int(0.004 * delta.size)), (
        f"{name}: {len(bad)} excused pixels")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["o_02_shadow", "o_05_cube"])
def test_aa_matches_oracle_rule(name):
    """render_aa with the budget lifted (budget_frac 1.0) against the
    oracle's exact AA rule; pixels whose pass-1 deviation lies within
    0.005 of the threshold are left out (fp32 noise can flip them)."""
    sc, data = built(name, 0.1)
    img_aa = render_aa(data, sc.camera, budget_frac=1.0).numpy()
    orc = OracleRenderer(data, sc.camera)
    ref1 = orc.render()
    ref_aa = orc.render_aa(img1=ref1, subp=AA_SUBP, threshold=AA_THRESHOLD)
    H, W = ref1.shape[:2]
    dev = np.zeros((H, W))
    c = ref1
    dev[:, :-1] += ((c[:, :-1] - c[:, 1:]) ** 2).sum(-1)
    dev[:, 1:] += ((c[:, 1:] - c[:, :-1]) ** 2).sum(-1)
    dev[:-1, :] += ((c[:-1] - c[1:]) ** 2).sum(-1)
    dev[1:, :] += ((c[1:] - c[:-1]) ** 2).sum(-1)
    near_threshold = np.abs(dev - AA_THRESHOLD) < 0.005
    delta = np.abs(img_aa - ref_aa).max(-1)
    bad = np.argwhere((delta > ATOL) & ~near_threshold)
    not_tie = [(int(x), int(y), float(delta[y, x])) for y, x in bad
               if not orc.is_tie_pixel(int(x), int(y))]
    assert not not_tie, f"{name} AA: {not_tie[:8]}"


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_native_resolution_sampled_oracle(name):
    """48 scattered pixels of render and 8 pixels the budgeted render_aa
    refined, at the golden's native resolution."""
    budget = golden.GOLDEN_SCENES[name][1]
    sc, data = built(name, 1.0)
    H, W = sc.camera.height, sc.camera.width
    img1 = render(data, sc.camera)
    img_aa = render_aa(data, sc.camera, budget_frac=budget).numpy()
    orc = OracleRenderer(data, sc.camera)
    rng = np.random.RandomState(sum(map(ord, name)))
    bad, n_excused = [], 0
    for x, y in zip(rng.randint(1, W - 1, 48), rng.randint(1, H - 1, 48)):
        eye, d = orc._ray(int(x), int(y))
        delta = float(np.abs(img1[y, x].numpy()
                             - np.minimum(orc.trace(eye, d), 1.0)).max())
        if delta > ATOL:
            if excused(orc, x, y, delta):
                n_excused += 1
            else:
                bad.append((int(x), int(y), delta))
    assert not bad, f"{name} @ {W}x{H}: {bad[:6]}"
    assert n_excused <= 4

    top_idx, sel, _, _ = _aa_rays(sc.camera, img1, AA_SUBP, AA_THRESHOLD,
                                  budget)
    refined = top_idx[sel].numpy()
    px, py = refined % W, refined // W
    refined = refined[(px > 0) & (px < W - 1) & (py > 0) & (py < H - 1)]
    steps = (np.arange(AA_SUBP) / AA_SUBP) - 0.5 + 1.0 / (2.0 * AA_SUBP)
    bad = []
    for pix in refined[rng.permutation(refined.size)[:8]]:
        x, y = int(pix % W), int(pix // W)
        acc = np.zeros(3)
        for oy in steps:
            for ox in steps:
                eye, d = orc._ray(x + ox, y + oy)
                acc += orc.trace(eye, d)
        delta = float(np.abs(img_aa[y, x]
                             - np.minimum(acc / AA_SUBP ** 2, 1.0)).max())
        if delta > ATOL_AA and not excused(orc, x, y, delta):
            bad.append((x, y, delta))
    assert not bad, f"{name} @ {W}x{H} AA: {bad[:6]}"


def rich_scene(pkg):
    """tests/test_two_phase.py's scene with either package: spheres, a
    plane, a cylinder, FLAT and PHONG meshes, a texture, two lights and
    mirrors, depth 3."""
    S, Mat, Mesh, flat, phong, sh = (
        (RScene, RMaterial, RMesh, RFLAT, RPHONG, rshapes) if pkg == "ref"
        else (Scene, Material, TriangleMesh, FLAT, PHONG, shapes))
    s = S()
    s.set_camera(eye=(0, 1.2, 5), center=(0, 0.3, 0), up=(0, 1, 0),
                 fovy=50, width=48, height=48)
    s.add_light((3, 5, 4), (0.8, 0.8, 0.75))
    s.add_light((-4, 2, 3), (0.3, 0.3, 0.35))
    s.ambience = (0.2, 0.2, 0.2)
    s.background = (0.1, 0.15, 0.3)
    s.add_sphere((-1.1, 0.2, 0.5), 0.55, Mat(
        diffuse=(0.7, 0.1, 0.1), specular=(0.5,) * 3, shininess=40,
        mirror=0.35))
    s.add_cylinder((1.2, -0.1, 0.2), (0, 1, 0), 0.35, 1.1, Mat(
        diffuse=(0.1, 0.5, 0.6), specular=(0.3,) * 3, shininess=25))
    s.add_plane((0, -0.7, 0), (0, 1, 0), Mat(
        diffuse=(0.4, 0.4, 0.4), mirror=0.25))
    v, f = sh.uv_sphere(0.5, 10, 12, center=(0, 0.4, -0.6))
    s.add_mesh(Mesh(v, f, material=Mat(
        diffuse=(0.8, 0.7, 0.2), specular=(0.4,) * 3, shininess=60),
        draw_mode=phong))
    g, gf, guvi, gu, gv = sh.plane_uv_quad(
        (-2.5, -0.69, 2.5), (2.5, -0.69, 2.5), (2.5, -0.69, -2.5),
        (-2.5, -0.69, -2.5))
    s.add_mesh(Mesh(g, gf, uv_indices=guvi, u_coords=gu, v_coords=gv,
                    texture=sh.checkerboard(),
                    material=Mat(diffuse=(0.6, 0.6, 0.6)), draw_mode=flat))
    s.max_depth = 3
    return s


def pixel_rays(cam):
    xs, ys = cam.pixel_grid("cpu")
    o, d = cam.primary_rays(xs.reshape(-1), ys.reshape(-1))
    return o.contiguous(), d.contiguous()


def test_trace_shade_equals_trace():
    sc = rich_scene("port")
    scene = sc.build(device="cpu")
    assert scene.n_segments == 4 and scene.n_cylinders == 1
    o, d = pixel_rays(sc.camera)
    want = tr.trace(scene, o, d)
    got = tr.trace_shade(scene, o, d, tr.trace_topology(scene, o, d))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.slow
def test_two_phase_grads_match_reference(monkeypatch):
    """Rays whose colours differ between the packages by more than fp32
    noise (1e-5; 2 of 2,304 here) are weighted 0, each certified
    ill-conditioned by the oracle at that delta and at most 0.2% of the
    rays: a ray grazing the cylinder's silhouette (discriminant 5e-5 of
    b^2) has a 1/sqrt(disc) sensitivity that carries the packages'
    rounding (op by op here, fused by XLA there) into a 0.2% gap in
    cyl_center's gradient, most of which that one ray makes."""
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    rs = rich_scene("ref")
    ref = rs.build()
    port = to_port(ref)
    cam = rich_scene("port").camera
    o, d = pixel_rays(cam)
    O, D = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    brute = rtr.TraceConfig(tri_method="brute")
    delta = np.abs(tr.trace(port, o, d).numpy()
                   - np.asarray(rtr.trace(ref, O, D, brute))).max(-1)
    noisy = np.flatnonzero(delta > 1e-5)
    orc = OracleRenderer(port, cam)
    for i in noisy:
        assert orc.is_ill_conditioned_pixel(i % cam.width, i // cam.width,
                                            delta[i]), (i, delta[i])
    assert len(noisy) <= max(2, int(0.002 * delta.size))
    w = np.ones(delta.size, np.float32)
    w[noisy] = 0.0
    target = torch.zeros_like(o)
    loss, grads = prender._loss_grad_tiled(port, o, d, target,
                                           torch.from_numpy(w),
                                           tr.TraceConfig(), 1024)
    jax.clear_caches()
    monkeypatch.setattr(risx, "ray_cylinder", _ref_cylinder_guarded)
    try:
        r_loss, r_grads = rrender._loss_grad_tiled(
            ref, O, D, jnp.zeros((delta.size, 3)), jnp.asarray(w), brute,
            1024)
    finally:
        jax.clear_caches()
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert set(grads) == set(r_grads) and len(grads) == 23
    for k, want in r_grads.items():
        want = np.asarray(want)
        tol = GRAD_REL * max(float(np.abs(want).max()) if want.size else 0.0,
                             1e-3)
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0, atol=tol,
                                   err_msg=k)
