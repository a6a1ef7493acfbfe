"""The configuration ``toon-600x300`` (golden o_07) and the benchmark's two
fit cells on the mirror scenes, ``toon-600x300.fit`` and
``rings-700x500.fit``, on the CPU.

The frozen generator against the program's golden; the sizes the
configuration states; the replay route each cell takes (K5/K6 and
K10/K11 side by side on the toon heads, which mix triangles with a
plane; K5/K6 on the rings); the program's fit step against the plain
reference
(``rtbench/reference/fit.py``) on each at a small size, and the
reference in bfloat16 failing each cell's limits; each cell run
``correct`` by the harness, traced and untraced; a ray of the rings at
700x500 whose replayed re-solve grazes a triangle's edge; the phase
``shade.autograd``, which the autograd replay's forward opens (on the
toon heads with ``fused_shade_grad=False``) and no fused route does;
and the readers of ``replay.autograd_ms.fit`` and
``tracer.live_share.fit`` on synthetic traces and counters."""

import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import compare, harness  # noqa: E402
from rtbench import trace as rtrace  # noqa: E402
from rtbench.port_scene import port_camera, port_scene  # noqa: E402
from rtbench.reference import fit as F  # noqa: E402
from rtbench.reference import whitted as W  # noqa: E402
from rtbench.scenes import scene_07_toon  # noqa: E402
from test_torch_profiling import _recorded  # noqa: E402

from myraytracer_tpu_torch import inverse as I  # noqa: E402
from myraytracer_tpu_torch.ops import graphs  # noqa: E402
from myraytracer_tpu_torch.ops import shade  # noqa: E402
from myraytracer_tpu_torch.ops import tracer as tr  # noqa: E402
from myraytracer_tpu_torch.scenes.golden import (  # noqa: E402
    scene_04_molecule, scene_07_toon_faces, scene_09_rings)
from myraytracer_tpu_torch.utils import profiling  # noqa: E402

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

TOON, RINGS = "toon-600x300.fit", "rings-700x500.fit"
#: each cell's scene at a size a CPU test holds (a tenth of its side)
SMALL = {TOON: (60, 30), RINGS: (70, 50)}
#: a seed above 2**31, as the benchmark's runs draw them
SEED = 2 ** 31 + 977
LIVE_SHARE, AUTOGRAD_MS = "tracer.live_share.fit", "replay.autograd_ms.fit"


def _small(name: str, size=None) -> harness.Cell:
    """The cell ``name`` with its scene at ``size`` (default SMALL)."""
    cell = harness.find_cell(name)
    w, h = size or SMALL[name]
    cell.config["params"].update(width=w, height=h)
    return cell


def _reader(metric):
    return harness.load_module(harness.HERE / "metrics" / f"{metric}.py")


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_toon_generator_matches_the_programs_golden(scale):
    arrays = scene_07_toon.generate(int(600 * scale), int(300 * scale))
    mine = port_scene(arrays).pack(native=False)
    theirs = scene_07_toon_faces(scale=scale).pack(native=False)
    assert mine[1] == theirs[1]
    assert sorted(mine[0]) == sorted(theirs[0])
    for k in mine[0]:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k], err_msg=k)


def test_toon_configuration_states_its_sizes():
    cell = harness.find_cell(TOON)
    arrays = harness.generate(cell.config)
    sizes = cell.config["sizes"]
    assert cell.config["reduced"] == []
    assert cell.config["params"] == {"width": 600, "height": 300}
    assert sizes["triangles"] == 19680 and sizes["segments"] == 4
    assert sum(m["faces"].shape[0] for m in arrays["meshes"]) == (
        sizes["triangles"])
    assert len(arrays["meshes"]) == sizes["meshes"]
    assert all(m["mode"] == 1 for m in arrays["meshes"])       # PHONG
    assert arrays["sphere_radius"].shape[0] == 0
    assert arrays["plane_mat"].shape[0] == sizes["planes"]
    # the heads are no mirrors; the plane is, at 0.08
    assert float(arrays["mat_mirror"][arrays["plane_mat"][0]]) == (
        pytest.approx(0.08))
    assert all(arrays["mat_mirror"][m["mat"]] == 0 for m in arrays["meshes"])
    assert arrays["light_pos"].shape[0] == sizes["lights"]
    assert W.RefScene(arrays, "cpu").light_pos.shape[0] == (
        sizes["lights_after_culling"])
    assert arrays["max_depth"] == sizes["max_depth"] == sizes["segments"] - 1
    cam = arrays["camera"]
    assert cam["width"] * cam["height"] == sizes["pixels"]


def _program(cell: harness.Cell):
    """The cell's scene built for the program on the CPU, its camera, its
    arrays and the trace settings the fit traffic uses."""
    arrays = harness.generate(cell.config)
    data = port_scene(arrays).build(device="cpu")
    cfg = tr.TraceConfig(tri_method=cell.config["tri_method"],
                         texture_filter=cell.workload["texture_filter"])
    return data, port_camera(arrays["camera"], "cpu"), arrays, cfg


@pytest.mark.parametrize("name, route, lights", [(TOON, "fused_mixed", 2),
                                                  (RINGS, "fused_tri", 1)])
def test_fit_cells_take_their_replay_route(name, route, lights):
    data, _, _, cfg = _program(_small(name, (14, 10)))
    assert cfg.replay_route(data) == route
    assert data.n_lights == lights and data.n_segments == 4


def _target(arrays):
    cam = arrays["camera"]
    g = torch.Generator().manual_seed(SEED)
    return torch.rand((cam["width"] * cam["height"], 3), generator=g)


@pytest.mark.parametrize("name", [TOON, RINGS])
def test_fit_step_matches_the_plain_reference(name):
    """One Adam step of ``fit_pixels`` on the cell's scene at a tenth of its
    side: the loss, the first gradient (Adam's ``exp_avg`` / 0.1) and the
    leaves' change within 1e-5 of the reference's."""
    cell = _small(name)
    data, cam, arrays, cfg = _program(cell)
    wl = cell.workload
    inv = I.InverseRenderer(data, param_names=tuple(wl["leaves"]),
                            optimizer=I.adam(wl["lr"]), cfg=cfg, camera=cam)
    xs, ys = cam.pixel_grid("cpu")
    tgt = _target(arrays)
    start = {k: v.detach().clone() for k, v in inv.params.items()}
    losses = inv.fit_pixels(xs.reshape(-1), ys.reshape(-1), tgt,
                            steps=1).losses
    prog = {"losses": losses,
            "grad1": {k: inv.optimizer.state[p]["exp_avg"] / 0.1
                      for k, p in inv.params.items()},
            "change": {k: v.detach() - start[k]
                       for k, v in inv.params.items()}}
    ref = F.fit_steps(W.RefScene(arrays, "cpu"), arrays["camera"], tgt,
                      wl["lr"], 1)
    got = compare.fit_numbers(prog, ref)
    assert max(got.values()) < 1e-5, got


@pytest.mark.parametrize("name", [TOON, RINGS])
def test_control_fit_fails_the_cells_limits(name):
    """The reference in bfloat16, three steps, fails the cell's check."""
    cell = _small(name)
    arrays = harness.generate(cell.config)
    tgt = _target(arrays)
    lr = cell.workload["lr"]
    ref = F.fit_steps(W.RefScene(arrays, "cpu"), arrays["camera"], tgt, lr, 3)
    ctl = F.fit_steps(W.RefScene(arrays, "cpu", torch.bfloat16),
                      arrays["camera"], tgt, lr, 3)
    checks = compare.checks(compare.fit_numbers(ctl, ref),
                            cell.workload["limits"])
    assert not compare.all_within(checks), checks


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [TOON, RINGS])
def test_fit_cell_runs_correct_on_the_cpu(name, trace):
    """The cell through the harness at a fifteenth of its side, one step a
    call. Traced, one call: the CPU profiler records every op, and a step
    of the plain walk makes hundreds of thousands of events, which take
    tens of seconds to read; the rings' traced run takes the brute
    oracle, which makes the fewest."""
    graphs.clear()
    w, h = SMALL[name]
    cell = _small(name, (w * 2 // 3, h * 2 // 3))
    cell.workload.update(chunk=1, trace_calls=1)
    if trace and name == RINGS:
        cell.config["tri_method"] = "brute"
    line = harness.run_cell(cell, SEED, 0.2, trace, time.perf_counter(),
                            device="cpu")
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    if not trace:
        assert {"fit_steps_per_s", "peak_mem_gib", "setup_s"} <= set(m)
        return
    share = m[LIVE_SHARE]["value"]
    # the toon heads: every ray in segment 0, the floor's reflections in
    # segment 1, none later; the rings reflect off both tori
    assert (60 < share < 90) if name == TOON else (0 < share < 60), share
    # the CPU marks no phase and captures no graph: nothing to read there
    assert AUTOGRAD_MS not in m and "replay.fused_share.fit" not in m
    graphs.clear()


@pytest.mark.parametrize("fused", [True, False])
def test_rings_replay_keeps_a_grazing_recorded_hit(fused):
    """Nine pixels of the rings at 700x500 (row 252, columns 346 to 354):
    the replayed ray of column 350 grazes a triangle's edge in segment 2,
    where its re-solve falls just outside the triangle. The replay keeps
    the recorded hit (``ray_triangle(recorded=True)``, K5's solve), so
    ``trace_shade`` of the topology is finite and equals ``trace``; a
    miss there sent the point to INF and the fit's loss to NaN."""
    arrays = harness.generate(harness.find_cell(RINGS).config)
    data = port_scene(arrays).build(device="cpu")
    cam = port_camera(arrays["camera"], "cpu")
    xs = torch.arange(346, 355, dtype=torch.float32)
    o, d = (x.reshape(-1, 3).contiguous()
            for x in cam.primary_rays(xs, torch.full_like(xs, 252.0)))
    cfg = tr.TraceConfig(tri_method="auto", fused_shade_grad=fused)
    topo = tr.trace_topology(data, o, d, cfg)
    # column 350's ray still hits a triangle in segment 2
    assert int(topo.kind[2][4]) == shade.KIND_TRI
    got = tr.trace_shade(data, o, d, topo, cfg)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, tr.trace(data, o, d, cfg), rtol=0,
                               atol=1e-5)


def _scene(name):
    if name == "toon":
        s = scene_07_toon_faces(scale=0.05)
    elif name == "rings":
        s = scene_09_rings(scale=0.05, seg=8)
    else:
        s = scene_04_molecule(scale=0.05, n_atoms=24)
    return s.build(device="cpu"), s.camera


@pytest.mark.parametrize("name, fused, route", [
    ("toon", True, "fused_mixed"), ("rings", True, "fused_tri"),
    ("molecule", True, "fused_ana"), ("rings", False, "autograd"),
    ("toon", False, "autograd")])
def test_shade_autograd_marks_the_autograd_replay_alone(monkeypatch, name,
                                                        fused, route):
    """A fit step's replay marks ``segment`` and then ``shade.autograd`` in
    each segment on the autograd route, ``shade`` on a fused one; the
    topology before it marks ``shade`` for K3/K4 either way."""
    data, cam = _scene(name)
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    assert cfg.replay_route(data) == route
    inv = I.InverseRenderer(data, ("mat_diffuse", "light_color"),
                            optimizer=I.adam(0.05), cfg=cfg, camera=cam)
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid(torch.device("cpu")))
    tgt = torch.full((xs.shape[0], 3), 0.4)
    with _recorded(monkeypatch) as seq:
        inv.fit_pixels(xs, ys, tgt, steps=1)
    topo = seq[seq.index("fit.topology") + 1:seq.index("fit.replay")]
    replay = seq[seq.index("fit.replay") + 1:seq.index("fit.backward")]
    want = "shade.autograd" if route == "autograd" else "shade"
    assert replay == ["segment", want] * data.n_segments
    assert "shade" in topo and "shade.autograd" not in topo
    assert ("shade.autograd" in seq) == (route == "autograd")


def _mark(phase, t):
    return (f"void mrt_mark<{profiling.PHASES.index(phase)}>()", t, t + 1.0)


def _steps(replay="shade.autograd"):
    """Two fit steps' device events (us): the topology, a replay of two
    segments under ``replay`` (gathers of 30 and 20 us, then 40 and 10),
    the backward, Adam; each step a ``mrt.fit.step`` span."""
    dev = []
    for t0, (a, b) in ((0.0, (30.0, 20.0)), (1000.0, (40.0, 10.0))):
        dev += [_mark("fit.topology", t0), _mark("segment", t0 + 10),
                _mark("tri", t0 + 20), ("k7", t0 + 21, t0 + 60),
                _mark("shade", t0 + 60), ("k3", t0 + 61, t0 + 90),
                _mark("fit.replay", t0 + 100), _mark("segment", t0 + 110),
                _mark(replay, t0 + 120), ("gather", t0 + 121, t0 + 121 + a),
                _mark("segment", t0 + 200), _mark(replay, t0 + 210),
                ("gather", t0 + 211, t0 + 211 + b),
                _mark("fit.backward", t0 + 300),
                ("indexing_backward_kernel", t0 + 301, t0 + 700),
                _mark("fit.adam", t0 + 700), ("adam", t0 + 701, t0 + 710),
                _mark("end", t0 + 720)]
    host = [(rtrace.WINDOW, 0.0, 2000.0), ("mrt.fit.step", 0.0, 800.0),
            ("mrt.fit.step", 1000.0, 1800.0)]
    return rtrace.make(dev, host)


def test_autograd_replay_reader_reads_ms_per_step():
    got = _reader(AUTOGRAD_MS).read(None, {}, _steps(), {})
    assert got == pytest.approx((30 + 20 + 40 + 10) * 1e-3 / 2)


def test_autograd_replay_reader_reads_zero_on_a_fused_route():
    assert _reader(AUTOGRAD_MS).read(None, {}, _steps("shade"), {}) == 0.0


def test_autograd_replay_reader_reads_nothing_without_the_phase(monkeypatch):
    t = _steps()
    monkeypatch.setattr(profiling, "PHASES", profiling.PHASES[:-1])
    assert _reader(AUTOGRAD_MS).read(None, {}, t, {}) is None


@pytest.mark.parametrize("live, rays, want", [
    ({None: 300, 0: 200, 1: 100}, 400, 75.0), ({None: 0}, 400, 0.0),
    ({None: 0}, 0, None)])
def test_live_share_reader_reads_the_fit_steps_counters(monkeypatch, live,
                                                         rays, want):
    """Live rays over the rays of the bodies run, of ``fit_step`` alone;
    nothing where no body ran."""
    asked = []

    def live_rays(entry, s=None):
        asked.append(entry)
        return live[s]

    monkeypatch.setattr(tr, "live_rays", live_rays)
    monkeypatch.setattr(tr, "rays_run", lambda entry: rays)
    got = _reader(LIVE_SHARE).read(None, {}, None, {})
    assert got == (None if want is None else pytest.approx(want))
    assert set(asked) <= {"fit_step"}


def test_live_share_reader_reads_nothing_without_counters(monkeypatch):
    monkeypatch.delattr(tr, "live_rays")
    assert _reader(LIVE_SHARE).read(None, {}, None, {}) is None
