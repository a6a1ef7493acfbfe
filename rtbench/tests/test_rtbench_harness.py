"""The harness on the CPU: its files resolve by name, the traced stretch
reads by the stated arithmetic, the result line has the contract's keys,
and a run with its timed path broken comes out not correct."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import ROOT, SEED, run_small, small_cell
from rtbench import harness, roofline
from rtbench import trace as tr

BENCH = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_rtbench_benchmark_json_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for text in [w["why"] for w in BENCH["workloads"] + BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_rtbench_files_are_named_from_name_characters():
    for p in Path(ROOT, "rtbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_rtbench_every_cell_resolves_its_files(cell):
    c = harness.find_cell(cell)
    assert c.config["name"] == c.entry["config"]
    gen = harness.load_module(harness.HERE / "scenes"
                              / f"{c.config['generator']}.py")
    assert callable(gen.generate)
    traffic = harness.load_module(harness.HERE / "traffic"
                                  / f"{c.workload['kind']}.py")
    for fn in ("setup", "window", "traced", "check"):
        assert callable(getattr(traffic, fn))
    assert c.workload["limits"] and c.workload["why"] == c.entry["why"]
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_rtbench_every_metric_resolves_its_reader(metric):
    reader = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    assert callable(reader.read)


def _canned():
    dev = [("k", 0.0, 100.0), ("k", 50.0, 150.0), ("void indexing_backward_kernel"
           "_small_stride<float>(...)", 300.0, 400.0), ("late", 2000.0, 2100.0)]
    host = [(tr.WINDOW, 0.0, 1000.0), ("rtbench.fit_pixels", 0.0, 600.0),
            ("cudaDeviceSynchronize", 600.0, 1000.0)]
    return tr.make(dev, host)


def test_rtbench_idle_and_gather_share_from_a_canned_profile():
    t = _canned()
    assert t.window_s == pytest.approx(1000e-6)
    assert tr.busy_s(t) == pytest.approx(250e-6)
    assert tr.idle_share(t) == pytest.approx(75.0)
    gather = harness.load_module(harness.HERE / "metrics"
                                 / "replay.gather_bwd_share.fit.py")
    assert gather.read(None, {}, t, {}) == pytest.approx(40.0)
    idle = harness.load_module(harness.HERE / "metrics"
                               / "device.idle_share.fit.py")
    assert idle.read(None, {}, t, {}) == pytest.approx(75.0)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["k", pytest.approx(200e-6)]
    assert dict((n, v) for n, v in b["idle_gaps"]) == {
        "rtbench.fit_pixels": pytest.approx(150e-6),
        "cudaDeviceSynchronize": pytest.approx(600e-6)}


def test_rtbench_k7_share_from_a_canned_profile():
    cell = small_cell("office-1080p.aa-orbit")
    run = harness.Run(cell, SEED, torch.device("cpu"))
    run.arrays = harness.generate(cell.config)
    from rtbench.port_scene import port_scene

    run.scene = port_scene(run.arrays).build(device="cpu")
    traffic = harness.load_module(harness.HERE / "traffic" / "aa_orbit.py")
    poses = traffic.poses(run)[:2]
    name = "void (anonymous namespace)::bvh_walk_kernel<false>(float const*)"
    dev = [(name, 0.0, 40.0), (name, 50.0, 60.0), ("x", 70.0, 80.0),
           (name, 100.0, 160.0), (name, 170.0, 175.0)]
    t = tr.make(dev, [(tr.WINDOW, 0.0, 200.0)])
    k7 = harness.load_module(harness.HERE / "metrics"
                             / "bvh_walk_closest_roofline.py")
    got = k7.read(run, {"traced_poses": poses}, t, {})
    # the same arithmetic by hand: every ray of the sample is walked, the
    # counts scaled to the padded grid, over the first launch of each pair
    Hp, Wp = 64, 64
    g = torch.Generator().manual_seed(SEED)
    pick = torch.randperm(Hp * Wp, generator=g)[:Hp * Wp // k7.SAMPLE]
    from rtbench.reference import whitted as W

    d = run.scene
    tv = d.tri_vidx.long()
    corners = torch.cat([d.vertex_pos[tv[:, 0]], d.vertex_pos[tv[:, 1]],
                         d.vertex_pos[tv[:, 2]]], 1)
    total = 0.0
    for p in poses:
        o, dd = W.camera_rays(p, (pick % Wp).float(), (pick // Wp).float())
        w = roofline.walk_work(d.bvh_nodes_packed, d.bvh_links_packed,
                               corners, int(d.max_leaf), o, dd)
        w["visits"] *= Hp * Wp / pick.numel()
        w["slots"] *= Hp * Wp / pick.numel()
        total += roofline.walk_bound_ms(Hp * Wp, w)
    assert got == pytest.approx(100.0 * total / ((40.0 + 60.0) * 1e-3))
    assert k7.read(run, {"traced_poses": poses[:1]}, t, {}) is None


def test_rtbench_walk_counter_finds_the_programs_hits():
    from myraytracer_tpu_torch.ops import traverse

    cell = small_cell("office-1080p.aa-orbit")
    arrays = harness.generate(cell.config)
    from rtbench.port_scene import port_scene
    from rtbench.reference import whitted as W

    d = port_scene(arrays).build(device="cpu")
    xs, ys = W.pixel_grid(arrays["camera"], "cpu")
    o, dd = W.camera_rays(arrays["camera"], xs, ys)
    work = {}
    traverse.traverse_bvh_plain(d, o, dd, stats=work)
    tv = d.tri_vidx.long()
    corners = torch.cat([d.vertex_pos[tv[:, 0]], d.vertex_pos[tv[:, 1]],
                         d.vertex_pos[tv[:, 2]]], 1)
    mine = roofline.walk_work(d.bvh_nodes_packed, d.bvh_links_packed, corners,
                              int(d.max_leaf), o, dd)
    for k in ("visits", "slots", "nodes", "links", "tris"):
        assert mine[k] == work[k], k


@pytest.mark.parametrize("trace", [0, 1])
def test_rtbench_result_line_has_the_contract_keys(trace):
    line = run_small("molecule-500.aa-orbit", trace=bool(trace))
    want = LINE_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "build.scene_s" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s",
                                        "peak_mem_gib"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_rtbench_run_refuses_without_cuda():
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


# --- the timed path broken underneath: the check must fail -------------

def _frames_fault(monkeypatch, kind):
    import myraytracer_tpu_torch.ops.render as R

    orig = R.render_aa
    last = []

    def broken(*a, **k):
        img = orig(*a, **k)
        if kind == "stale":
            out = last[0] if last else img
            last[:] = [img]
            return out
        if kind == "half":
            img = img.clone()
            img[img.shape[0] // 2:] = 0
            return img
        return img * 0.98

    monkeypatch.setattr(R, "render_aa", broken)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_rtbench_frames_fault_is_not_correct(monkeypatch, kind):
    _frames_fault(monkeypatch, kind)
    line = run_small("molecule-500.aa-orbit", seconds=0.5)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_rtbench_fit_fault_is_not_correct(monkeypatch, kind):
    import myraytracer_tpu_torch.inverse as I

    if kind == "unchanged":
        orig = I.adam

        def still(lr=1e-2):
            make = orig(lr)

            def build(params):
                opt = make(params)
                opt.step = lambda *a, **k: None
                return opt
            return build

        monkeypatch.setattr(I, "adam", still)
    else:
        orig = I.InverseRenderer.fit_pixels

        def half(self, xs, ys, target, steps=100, log_every=0):
            return orig(self, xs[::2], ys[::2], target[::2], steps, log_every)

        monkeypatch.setattr(I.InverseRenderer, "fit_pixels", half)
    line = run_small("molecule-500.fit", seconds=0.3)
    assert line["correct"] is False, line["checks"]


@pytest.mark.needs_cuda
def test_rtbench_cell_runs_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "molecule-500.fit",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[:5] == LINE_KEYS
