"""The configuration ``mirror-1000x400`` and its cell: the frozen generator
against the program's golden, the orbit's poses inside the corridor, the
cell run on the CPU at 100x40, and the readers of the segment counters
(``tracer.live_share.frames``, ``tracer.segments_run.frames``)."""

import time

import numpy as np
import pytest

from conftest import SEED
from rtbench import harness
from rtbench.port_scene import port_scene
from rtbench.scenes import scene_03_mirror

from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer

CELL = "mirror-1000x400.aa-orbit"
SMALL = {"width": 100, "height": 40}
READERS = ("tracer.live_share.frames", "tracer.segments_run.frames")


def _read(metric):
    reader = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    return reader.read(None, {}, None, {})


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_rtbench_mirror_generator_matches_the_programs_golden(scale):
    from myraytracer_tpu_torch.scenes import golden

    arrays = scene_03_mirror.generate(int(1000 * scale), int(400 * scale))
    mine = port_scene(arrays).pack(native=False)
    theirs = golden.scene_03_mirror(scale=scale).pack(native=False)
    assert mine[1] == theirs[1]
    assert sorted(mine[0]) == sorted(theirs[0])
    for k in mine[0]:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k], err_msg=k)


def test_rtbench_mirror_configuration_states_its_sizes():
    cell = harness.find_cell(CELL)
    arrays = harness.generate(cell.config)
    sizes = cell.config["sizes"]
    assert cell.config["reduced"] == []
    assert arrays["sphere_radius"].shape[0] == sizes["spheres"]
    assert arrays["plane_mat"].shape[0] == sizes["planes"]
    assert sum(m["faces"].shape[0] for m in arrays["meshes"]) == sizes["triangles"]
    assert arrays["light_pos"].shape[0] == sizes["lights"]
    assert arrays["max_depth"] == sizes["max_depth"] == sizes["segments"] - 1
    cam = arrays["camera"]
    assert cam["width"] * cam["height"] == sizes["pixels"]


def test_rtbench_mirror_orbit_stays_inside_the_corridor():
    """Every pose's eye lies between the mirror walls (|x| < 2.4) and above
    the floor (y > -0.55), whatever the seed's order."""
    cell = harness.find_cell(CELL)
    run = harness.Run(cell, SEED, None, arrays=harness.generate(cell.config))
    traffic = harness.load_module(harness.HERE / "traffic" / "aa_orbit.py")
    poses = traffic.poses(run)
    assert len(poses) == cell.workload["n_yaw"] * cell.workload["n_pitch"]
    walls = np.abs(run.arrays["plane_center"][:, 0])
    floor = float(run.arrays["meshes"][0]["vertices"][:, 1].min())
    for p in poses:
        assert abs(p["eye"][0]) < walls.min(), p["eye"]
        assert p["eye"][1] > floor, p["eye"]


def _small_cell():
    cell = harness.find_cell(CELL)
    cell.config["params"].update(SMALL)
    cell.workload["trace_calls"] = 2
    cell.workload["check_frame"] = 1
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_rtbench_mirror_cell_runs_correct_on_the_cpu(trace, monkeypatch):
    from myraytracer_tpu_torch.ops import graphs

    graphs.clear()
    monkeypatch.setitem(prender.CALLS, "render_aa", 0)
    line = harness.run_cell(_small_cell(), SEED, 0.2, trace,
                            time.perf_counter(), device="cpu")
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    if not trace:
        assert {"frames_per_s", "frame_p95_ms", "peak_mem_gib",
                "setup_s"} <= set(m)
        return
    # render's 21 segments all run, the AA pass's while a subray lives
    assert 21 < m["tracer.segments_run.frames"]["value"] <= 42
    assert 0 < m["tracer.live_share.frames"]["value"] < 50


@pytest.fixture
def counters(monkeypatch):
    """The program's segment counters and render_aa calls, known."""
    live = {"render": [100, 40, 10], "aa_refine": [20, 5, 0]}
    monkeypatch.setattr(tracer, "live_rays", lambda e, s=None: (
        sum(live[e]) if s is None else live[e][s]))
    monkeypatch.setattr(tracer, "segments_run",
                        {"render": 6, "aa_refine": 4}.__getitem__)
    monkeypatch.setattr(tracer, "rays_run",
                        {"render": 600, "aa_refine": 80}.__getitem__)
    monkeypatch.setattr(prender, "CALLS", {"render_aa": 2})


def test_rtbench_segment_readers_read_the_counters(counters):
    assert _read("tracer.segments_run.frames") == pytest.approx(5.0)
    assert _read("tracer.live_share.frames") == pytest.approx(
        100.0 * 175 / 680)


def test_rtbench_segment_readers_read_nothing_without_counters(monkeypatch):
    for name in ("live_rays", "segments_run", "rays_run"):
        monkeypatch.delattr(tracer, name)
    monkeypatch.delattr(prender, "CALLS")
    for m in READERS:
        assert _read(m) is None, m


def test_rtbench_segment_readers_read_nothing_before_a_frame(monkeypatch):
    from myraytracer_tpu_torch.ops import graphs

    graphs.clear()
    monkeypatch.setattr(prender, "CALLS", {"render_aa": 0})
    for m in READERS:
        assert _read(m) is None, m
