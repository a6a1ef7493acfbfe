"""The configuration ``rings-700x500`` and its cell: the frozen generator
against the program's golden, the sizes the configuration states, the
orbit's poses framing both tori, the cell run on the CPU at 70x50, and
the readers of the bounce phase (``tracer.tri_bounce_ms.frames``,
``bvh_walk_bounce_roofline``) on synthetic traces."""

import math
import time

import numpy as np
import pytest
import torch

from conftest import SEED
from rtbench import harness
from rtbench import trace as tr
from rtbench.port_scene import port_scene
from rtbench.reference import whitted as W
from rtbench.scenes import scene_09_rings

from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.utils import profiling

CELL = "rings-700x500.aa-orbit"
SMALL = {"width": 70, "height": 50}
BOUNCE_MS = "tracer.tri_bounce_ms.frames"
ROOFLINE = "bvh_walk_bounce_roofline"
K7 = "void (anonymous namespace)::bvh_walk_kernel<false>(float const*)"
K7_ANY = "void (anonymous namespace)::bvh_walk_kernel<true>(float const*)"


def _reader(metric):
    return harness.load_module(harness.HERE / "metrics" / f"{metric}.py")


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_rtbench_rings_generator_matches_the_programs_golden(scale):
    from myraytracer_tpu_torch.scenes import golden

    arrays = scene_09_rings.generate(int(700 * scale), int(500 * scale))
    mine = port_scene(arrays).pack(native=False)
    theirs = golden.scene_09_rings(scale=scale).pack(native=False)
    assert mine[1] == theirs[1]
    assert sorted(mine[0]) == sorted(theirs[0])
    for k in mine[0]:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k], err_msg=k)


def test_rtbench_rings_configuration_states_its_sizes():
    cell = harness.find_cell(CELL)
    arrays = harness.generate(cell.config)
    sizes = cell.config["sizes"]
    assert cell.config["reduced"] == []
    assert sizes["triangles"] == 8192 and sizes["segments"] == 4
    assert sum(m["faces"].shape[0] for m in arrays["meshes"]) == sizes["triangles"]
    assert len(arrays["meshes"]) == sizes["meshes"]
    assert all(m["mode"] == 1 for m in arrays["meshes"])       # PHONG
    assert arrays["sphere_radius"].shape[0] == arrays["plane_mat"].shape[0] == 0
    assert arrays["light_pos"].shape[0] == sizes["lights"]
    # the black light is dropped by the reference as by the program
    assert W.RefScene(arrays, "cpu").light_pos.shape[0] == (
        sizes["lights_after_culling"])
    assert arrays["max_depth"] == sizes["max_depth"] == sizes["segments"] - 1
    cam = arrays["camera"]
    assert cam["width"] * cam["height"] == sizes["pixels"]


def test_rtbench_rings_orbit_frames_both_tori():
    """Every vertex of both tori lies in front of every pose's eye and
    inside its frame, whatever the seed's order."""
    cell = harness.find_cell(CELL)
    run = harness.Run(cell, SEED, None, arrays=harness.generate(cell.config))
    traffic = harness.load_module(harness.HERE / "traffic" / "aa_orbit.py")
    poses = traffic.poses(run)
    assert len(poses) == cell.workload["n_yaw"] * cell.workload["n_pitch"]
    for mesh in run.arrays["meshes"]:
        v = mesh["vertices"].astype(np.float64)
        for p in poses:
            eye, center, up = (np.asarray(p[k], np.float64)
                               for k in ("eye", "center", "up"))
            view = (center - eye) / np.linalg.norm(center - eye)
            right = np.cross(view, up)
            right /= np.linalg.norm(right)
            up2 = np.cross(right, view)
            rel = v - eye
            z = rel @ view
            assert (z > 0).all(), p["eye"]
            th = math.tan(math.radians(p["fovy"]) / 2)
            u = (rel @ right) / (z * th * p["width"] / p["height"])
            w = (rel @ up2) / (z * th)
            assert np.abs(u).max() < 1 and np.abs(w).max() < 1, p["eye"]


def _small_cell(trace: bool = False):
    """The cell at 70x50. Traced, through the cluster scan: the CPU
    profiler records every op, and the plain BVH walk's per-node steps
    make over a million events a frame, which take minutes to read."""
    cell = harness.find_cell(CELL)
    cell.config["params"].update(SMALL)
    if trace:
        cell.config["tri_method"] = "cluster"
    cell.workload["trace_calls"] = 2
    cell.workload["check_frame"] = 1
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_rtbench_rings_cell_runs_correct_on_the_cpu(trace, monkeypatch):
    from myraytracer_tpu_torch.ops import graphs

    graphs.clear()
    monkeypatch.setitem(prender.CALLS, "render_aa", 0)
    line = harness.run_cell(_small_cell(trace), SEED, 0.2, trace,
                            time.perf_counter(), device="cpu")
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    if not trace:
        assert {"frames_per_s", "frame_p95_ms", "peak_mem_gib",
                "setup_s"} <= set(m)
        return
    # render's 4 segments all run, the AA pass's while a subray lives
    assert 4 < m["tracer.segments_run.frames"]["value"] <= 8
    assert 0 < m["tracer.live_share.frames"]["value"] < 100
    # the CPU marks no phase: the device's readers read nothing
    assert BOUNCE_MS not in m and ROOFLINE not in m


def _mark(phase, t):
    return (f"void mrt_mark<{profiling.PHASES.index(phase)}>()", t, t + 1.0)


def _pass1(t0, walks, bounce=True):
    """One frame's device events from ``t0`` (us): pass 1 with segment 0's
    walks, segment 1's (closest ``walks`` us, then any hit 20 us) where
    ``bounce``, then the AA pass, whose walks are never read."""
    seg1 = [_mark("segment", t0 + 100), _mark("tri.bounce", t0 + 110),
            (K7, t0 + 111, t0 + 111 + walks),
            _mark("shade", t0 + 200), _mark("tri.bounce", t0 + 210),
            (K7_ANY, t0 + 211, t0 + 231),
            # segment 2's closest walk: not the first
            _mark("segment", t0 + 250), _mark("tri.bounce", t0 + 260),
            (K7, t0 + 261, t0 + 270)] if bounce else []
    aa = [_mark("aa.select", t0 + 300), _mark("segment", t0 + 310),
          _mark("tri", t0 + 320), (K7, t0 + 321, t0 + 330),
          _mark("segment", t0 + 340), _mark("tri.bounce", t0 + 350),
          (K7, t0 + 351, t0 + 390), _mark("aa.apply", t0 + 395),
          _mark("end", t0 + 398)]
    return ([_mark("rays", t0), _mark("segment", t0 + 10),
             _mark("tri", t0 + 20), (K7, t0 + 21, t0 + 60),
             _mark("shade", t0 + 60), _mark("tri", t0 + 70),
             (K7_ANY, t0 + 71, t0 + 90)] + seg1
            + [_mark("end", t0 + 290)] + aa)


def _frames(walks=(30.0, 50.0), bounce=True):
    dev = [e for i, w in enumerate(walks) for e in _pass1(1000.0 * i, w,
                                                          bounce)]
    host = [(tr.WINDOW, 0.0, 1000.0 * len(walks))] + [
        ("mrt.render_aa", 1000.0 * i, 1000.0 * i + 400.0)
        for i in range(len(walks))]
    return tr.make(dev, host)


def test_rtbench_bounce_phase_reads_ms_per_frame():
    # per frame: 111..(111 + w), 211..231, 261..270, 351..390
    t = _frames()
    want = sum(w + 20 + 9 + 39 for w in (30.0, 50.0)) * 1e-3 / 2
    assert _reader(BOUNCE_MS).read(None, {}, t, {}) == pytest.approx(want)


def test_rtbench_bounce_phase_reads_zero_without_bounces():
    t = _frames(bounce=False)
    # only the AA pass's later segment bounces here; without it, none
    dev = [d for d in t.device if not (390.0 >= d[1] % 1000.0 >= 340.0)]
    t = t._replace(device=dev)
    assert _reader(BOUNCE_MS).read(None, {}, t, {}) == 0.0


def test_rtbench_roofline_reads_each_frames_first_bounce_walk():
    walks, frames = _reader(ROOFLINE).first_bounce_walks(_frames())
    assert frames == 2
    assert walks == [(111.0, 141.0), (1111.0, 1161.0)]


def test_rtbench_bounce_readers_read_nothing_on_a_program_without_the_phase(
        monkeypatch):
    t = _frames()
    monkeypatch.setattr(profiling, "PHASES", profiling.PHASES[:-1])
    assert _reader(BOUNCE_MS).read(None, {}, t, {}) is None
    assert _reader(ROOFLINE).read(None, {"traced_poses": [{}]}, t, {}) is None


@pytest.fixture(scope="module")
def small_run():
    """A run of the rings at 70x50 on the CPU: the program's scene and two
    traced poses."""
    cell = _small_cell()
    run = harness.Run(cell, SEED, torch.device("cpu"),
                      arrays=harness.generate(cell.config))
    run.scene = port_scene(run.arrays).build(device="cpu")
    traffic = harness.load_module(harness.HERE / "traffic" / "aa_orbit.py")
    return run, {"traced_poses": traffic.poses(run)[:2]}


def test_rtbench_roofline_reads_nothing_when_the_launches_do_not_fit(
        small_run):
    run, state = small_run
    read = _reader(ROOFLINE).read
    # one pose for two frames; a frame with no bounce walk
    assert read(run, {"traced_poses": state["traced_poses"][:1]},
                _frames(), {}) is None
    assert read(run, state, _frames(bounce=False), {}) is None
    assert read(run, {}, _frames(), {}) is None


def test_rtbench_roofline_reads_the_bound_over_the_walks(small_run):
    run, state = small_run
    mod = _reader(ROOFLINE)
    share = mod.read(run, state, _frames((30.0, 50.0)), {})
    slower = mod.read(run, state, _frames((60.0, 100.0)), {})
    assert 0 < share < 100
    assert slower == pytest.approx(share / 2)
    # the reflected rays of a pose: those the reference keeps alive into
    # segment 1, off the tori's mirrors
    ref = W.RefScene(run.arrays, "cpu")
    pose = state["traced_poses"][0]
    xs, ys = W.pixel_grid(pose, "cpu")
    o, d = mod.reflected(ref, *W.camera_rays(pose, xs, ys))
    segs = W.trace_segments(ref, *W.camera_rays(pose, xs, ys))
    assert o.shape[0] == segs[1].rows.numel() > 0
    assert torch.isfinite(o).all() and torch.isfinite(d).all()
