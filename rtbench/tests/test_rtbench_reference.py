"""The plain reference against the program's CPU path, at small sizes,
and the control (the reference in bfloat16) failing the check."""

import numpy as np
import pytest
import torch

from conftest import SEED, SMALL
from rtbench import compare, harness
from rtbench.port_scene import port_camera, port_scene
from rtbench.reference import fit as F
from rtbench.reference import whitted as W
from rtbench.scenes import scene_04_molecule, scene_08_office

CASES = {"office-1080p": (0.0275, lambda: scene_08_office.generate(**SMALL["office-1080p"])),
         "molecule-500": (0.038, lambda: scene_04_molecule.generate(**SMALL["molecule-500"]))}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rtbench_generator_matches_the_programs_golden(name):
    from myraytracer_tpu_torch.scenes import golden

    p = SMALL[name]
    mine = port_scene(CASES[name][1]()).pack(native=False)
    if name == "office-1080p":
        theirs = golden.scene_08_office(tess=p["tess"], resolution=(
            p["width"], p["height"])).pack(native=False)
    else:
        theirs = golden.scene_04_molecule(scale=p["width"] / 500,
                                          n_atoms=p["n_atoms"]).pack(native=False)
    assert mine[1] == theirs[1]
    assert sorted(mine[0]) == sorted(theirs[0])
    for k in mine[0]:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k], err_msg=k)


def _program_aa(arrays, budget):
    from myraytracer_tpu_torch.ops.render import render_aa
    from myraytracer_tpu_torch.ops.tracer import TraceConfig

    data = port_scene(arrays).build(device="cpu")
    return render_aa(data, port_camera(arrays["camera"], "cpu"),
                     TraceConfig(tri_method="auto"), budget_frac=budget)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rtbench_reference_image_matches_the_program(name):
    budget, gen = CASES[name]
    arrays = gen()
    img = _program_aa(arrays, budget)
    ref, unsure = W.render_aa(W.RefScene(arrays, "cpu"), arrays["camera"],
                              budget, 4, 0.02, ties=True)
    got = compare.image_numbers(img, ref, unsure)
    assert got["bad_px"] == 0.0, got
    assert got["mean_abs"] < 1e-6, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_rtbench_control_image_fails(name):
    budget, gen = CASES[name]
    arrays = gen()
    limits = harness.find_cell(f"{name}.aa-orbit").workload["limits"]
    ref, unsure = W.render_aa(W.RefScene(arrays, "cpu"), arrays["camera"],
                              budget, 4, 0.02, ties=True)
    ctl = W.render_aa(W.RefScene(arrays, "cpu", torch.bfloat16),
                      arrays["camera"], budget, 4, 0.02)
    checks = compare.checks(compare.image_numbers(ctl, ref, unsure), limits)
    assert not compare.all_within(checks), checks


def _program_fit(name, arrays, tgt, lr):
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.ops.tracer import TraceConfig

    data = port_scene(arrays).build(device="cpu")
    cam = port_camera(arrays["camera"], "cpu")
    inv = InverseRenderer(data, param_names=F.LEAVES, optimizer=adam(lr),
                          cfg=TraceConfig(tri_method="auto",
                                          texture_filter="bilinear"),
                          camera=cam)
    xs, ys = cam.pixel_grid("cpu")
    start = {k: v.detach().clone() for k, v in inv.params.items()}
    losses = inv.fit_pixels(xs.reshape(-1), ys.reshape(-1), tgt, steps=1).losses
    grad1 = {k: inv.optimizer.state[p]["exp_avg"] / 0.1
             for k, p in inv.params.items()}
    return {"losses": losses, "grad1": grad1,
            "change": {k: v.detach() - start[k] for k, v in inv.params.items()}}


def _target(arrays):
    cam = arrays["camera"]
    g = torch.Generator().manual_seed(SEED)
    return torch.rand((cam["width"] * cam["height"], 3), generator=g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rtbench_reference_fit_step_matches_the_program(name):
    arrays = CASES[name][1]()
    tgt = _target(arrays)
    prog = _program_fit(name, arrays, tgt, 0.05)
    ref = F.fit_steps(W.RefScene(arrays, "cpu"), arrays["camera"], tgt, 0.05, 1)
    got = compare.fit_numbers(prog, ref)
    assert max(got.values()) < 1e-5, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_rtbench_control_fit_fails(name):
    arrays = CASES[name][1]()
    tgt = _target(arrays)
    limits = harness.find_cell(f"{name}.fit").workload["limits"]
    ref = F.fit_steps(W.RefScene(arrays, "cpu"), arrays["camera"], tgt, 0.05, 3)
    ctl = F.fit_steps(W.RefScene(arrays, "cpu", torch.bfloat16),
                      arrays["camera"], tgt, 0.05, 3)
    checks = compare.checks(compare.fit_numbers(ctl, ref), limits)
    assert not compare.all_within(checks), checks


def test_rtbench_triangle_test_agrees_with_a_direct_solve():
    from rtbench import roofline

    g = torch.Generator().manual_seed(7)
    p = torch.rand((40, 3, 3), generator=g, dtype=torch.float64) * 4 - 2
    arrays = {"light_pos": np.zeros((0, 3)), "light_color": np.zeros((0, 3)),
              "ambience": np.zeros(3), "background": np.zeros(3), "max_depth": 0,
              "mat_ambient": np.zeros((1, 3)), "mat_diffuse": np.zeros((1, 3)),
              "mat_specular": np.zeros((1, 3)), "mat_mirror": np.zeros(1),
              "mat_shininess": np.ones(1), "mat_shadowable": np.ones(1),
              "sphere_center": np.zeros((0, 3)), "sphere_radius": np.zeros(0),
              "sphere_mat": np.zeros(0), "plane_center": np.zeros((0, 3)),
              "plane_normal": np.zeros((0, 3)), "plane_mat": np.zeros(0),
              "meshes": [{"vertices": p.reshape(-1, 3).numpy(),
                          "faces": np.arange(120).reshape(40, 3),
                          "mat": 0, "mode": 0}]}
    sc = W.RefScene(arrays, "cpu", torch.float64)
    o = torch.rand((300, 3), generator=g, dtype=torch.float64) * 6 - 3
    d = torch.nn.functional.normalize(
        torch.rand((300, 3), generator=g, dtype=torch.float64) - 0.5, dim=1)
    t = W._tri_t(sc, o, d)
    c = sc.corners
    direct = torch.stack([roofline._tri_t(o, d, c[j, 0].expand(300, 3),
                                          c[j, 1].expand(300, 3),
                                          c[j, 2].expand(300, 3))
                          for j in range(40)], 1)
    direct = torch.where(direct >= 1e38, torch.full_like(direct, np.inf), direct)
    hit = torch.isfinite(direct)
    assert torch.equal(hit, torch.isfinite(t))
    assert torch.allclose(t[hit], direct[hit], rtol=1e-9)
