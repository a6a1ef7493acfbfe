"""The port's sharded paths (parallel/) on spawned gloo ranks on the CPU.

Counterpart of tests/test_parallel.py. One module fixture spawns 2 ranks
and then 3 (parallel/dryrun.spawn: one process per rank, one process
group), and each rank runs dryrun's suite on the toy scene at 64x40 (four
32x32 screen blocks: 3 ranks pad the blocks, the fit's 2,560 rays and
the step's 4,096 rays to their mesh): render_sharded, render_aa_sharded,
one sharded SGD step and a sharded 20-step fit, then the dryrun's step,
the render on a mesh of rank 0 alone, and make_mesh past the world. The
same suite runs on one device in this process.

Bars: the sharded render >= 99.5% of pixels within 1e-4 of the port's
render and of the reference's render_sharded on 2 devices, and equal to
render bit for bit on a mesh of one rank; the sharded AA within 1e-5 of
render_aa (__graft_entry__.py's bar); the step's loss within rtol 1e-5
of the single-device loss and of the reference's train_step_sharded, its
summed gradients within 5e-4 x max|single| (chip_smoke.py's REL_GRAD),
and the gradients its update implies within atol 1e-5 of the
single-device mean-loss gradients (tests/test_parallel.py's bar); the
fit's losses within rtol 1e-5 / atol 1e-7 and its parameters within
rtol 1e-4 / atol 1e-5 of the single-device fit (tests/test_inverse.py's
bars).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.parallel import (make_mesh as r_make_mesh,
                                      render_sharded as r_render_sharded,
                                      train_step_sharded as r_train_step)

from myraytracer_tpu_torch.ops.render import render_loss_grad_image
from myraytracer_tpu_torch.parallel import dryrun, merge_params, split_params
from myraytracer_tpu_torch.parallel.distributed import initialize_from_env

from test_parallel import tiny_scene

torch.set_num_threads(1)

SUITE = dict(scene="toy", scene_kw=dict(w=64, h=40), budget_frac=0.2,
             fit_steps=20)
RANKS = (2, 3)


@pytest.fixture(scope="module")
def runs():
    """{n: [each rank's suite result]} and the single-device suite."""
    sharded = {n: dryrun.spawn("suite", n, SUITE, device="cpu")
               for n in RANKS}
    case = dryrun.suite_case(device="cpu", **SUITE)
    return sharded, dryrun.run_suite(case), case


def agree(a, b, tol=1e-4) -> float:
    return float(((a - b).abs().amax(dim=-1) <= tol).float().mean())


@pytest.mark.parametrize("n", RANKS)
def test_sharded_render_matches_single(runs, n):
    sharded, one, _ = runs
    img = sharded[n][0]["img"]
    assert img.shape == one["img"].shape == (40, 64, 3)
    assert agree(img, one["img"]) >= 0.995
    for r in sharded[n][1:]:
        assert torch.equal(r["img"], img)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_render_is_render_on_one_rank(runs, n):
    sharded, one, _ = runs
    assert torch.equal(sharded[n][0]["img_ws1"], one["img"])
    assert all("img_ws1" not in r for r in sharded[n][1:])


def test_sharded_render_matches_reference(runs, monkeypatch):
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    s = tiny_scene(64, 40)
    want = torch.from_numpy(np.array(
        r_render_sharded(s.build(), s.camera, r_make_mesh(2))))
    assert agree(runs[0][2][0]["img"], want) >= 0.995


@pytest.mark.parametrize("n", RANKS)
def test_sharded_aa_matches_single(runs, n):
    sharded, one, _ = runs
    for r in sharded[n]:
        np.testing.assert_allclose(r["img_aa"].numpy(), one["img_aa"].numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_train_step_matches_single(runs, n):
    sharded, one, _ = runs
    got = sharded[n][0]
    assert got["n_total"] == one["n_total"] == 3 * 64 * 40
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        if g.numel():
            assert float((got["grads"][k] - g).abs().max()) <= (
                5e-4 * float(g.abs().max())), k
    for r in sharded[n][1:]:
        assert r["loss"] == got["loss"]


@pytest.mark.parametrize("n", RANKS)
def test_train_step_grads_match_unsharded(runs, n):
    """The update p - lr g / n_total recovers the single-device gradient of
    the mean squared error (tests/test_parallel.py:80-106)."""
    sharded, one, case = runs
    got, lr = sharded[n][0], dryrun.SUITE_LR
    before = split_params(case.scene)
    for name in ("light_color", "mat_diffuse", "sphere_center",
                 "vertex_pos"):
        implied = (before[name] - got["params"][name]) / lr
        want = one["grads"][name] / one["n_total"]
        np.testing.assert_allclose(implied.numpy(), want.numpy(), atol=1e-5,
                                   err_msg=name)


def test_train_step_reduces_loss(runs):
    """The sharded step's parameters give a lower loss than the start."""
    sharded, one, case = runs
    scene = merge_params(case.scene, sharded[2][0]["params"])
    loss, _ = render_loss_grad_image(scene, case.camera, case.target_img)
    assert float(loss) / one["n_total"] < one["loss"]


@pytest.mark.parametrize("n", RANKS)
def test_train_step_loss_matches_reference(runs, n, monkeypatch):
    """The dryrun's step (toy 16x16, raster rays, black target, lr 0.5)
    against the single-process loss and, on 2 ranks, the reference's
    train_step_sharded on 2 devices."""
    got = runs[0][n][0]["dryrun_loss"]
    np.testing.assert_allclose(got, dryrun.single_process_loss("cpu"),
                               rtol=dryrun.LOSS_RTOL)
    if n == 2:
        monkeypatch.setenv("MRT_NO_NATIVE", "1")
        s = tiny_scene()
        xs, ys = s.camera.pixel_grid()
        o, d = s.camera.primary_rays(xs.ravel(), ys.ravel())
        _, want = r_train_step(s.build(), o, d, jnp.zeros((o.shape[0], 3)),
                               r_make_mesh(2), lr=0.5)
        np.testing.assert_allclose(got, float(want), rtol=1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_fit_matches_single(runs, n):
    sharded, one, _ = runs
    got = sharded[n][0]
    assert len(got["fit_losses"]) == 20
    assert got["fit_losses"][-1] < 0.5 * got["fit_losses"][0]
    np.testing.assert_allclose(got["fit_losses"], one["fit_losses"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["fit_params"]["mat_diffuse"].numpy(),
                               one["fit_params"]["mat_diffuse"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_make_mesh_past_the_world_raises(runs, n):
    for r in runs[0][n]:
        assert r["mesh_error"] == f"need {n + 1} devices, have {n}"


@pytest.mark.parametrize("n", RANKS)
def test_replicate_global_checks_every_rank_passes_the_same(runs, n):
    """The suite's scene went through replicate_global on every rank; a
    tensor that differs from rank 0's raises on the other ranks."""
    first, *rest = runs[0][n]
    assert first["replicate_error"] is None
    for r in rest:
        assert "differs from mesh rank 0's" in r["replicate_error"]


def test_initialize_from_env_without_configuration(monkeypatch):
    for k in ("MRT_COORDINATOR", "MRT_NUM_PROCESSES", "MRT_PROCESS_ID",
              "MRT_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env() is False
    assert not torch.distributed.is_initialized()


def test_dryrun_main(capsys):
    assert dryrun.main(["--cpu"]) == 0
    assert "dryrun OK" in capsys.readouterr().out


def test_spawn_stops_a_failing_rank():
    """A rank that fails stops every rank: spawn raises with its output."""
    with pytest.raises(RuntimeError, match="(?s)rank . failed.*no such scene"):
        dryrun.spawn("suite", 2, dict(scene="no such scene"), device="cpu",
                     deadline_s=60)


def test_spawn_stops_ranks_past_the_deadline():
    with pytest.raises(TimeoutError, match="did not finish in 0.5 s"):
        dryrun.spawn("suite", 2, SUITE, device="cpu", deadline_s=0.5)


def test_suite_case_is_the_reference_scene(monkeypatch):
    """The toy scene is tests/test_parallel.py's tiny_scene, packed
    identically."""
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    ref = tiny_scene(64, 40).build()
    got = dryrun.toy_scene(64, 40).build(device="cpu")
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(ref, f.name)),
                                          err_msg=f.name)
