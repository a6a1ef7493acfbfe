"""One run of one cell: set-up, the measured window or a traced stretch,
the check against the plain reference, and the result line.

Everything a cell is made of is found by name:

  BENCHMARK.json                the cell (``workloads``), its configuration
                                and the metrics it reports
  rtbench/configs/<config>.json the scene generator, its parameters and
                                the configuration's source
  rtbench/scenes/<generator>.py the frozen scene generator (plain arrays)
  rtbench/workloads/<cell>.json the traffic kind, its parameters and the
                                limits of the check
  rtbench/traffic/<kind>.py     the loop of that traffic kind
  rtbench/metrics/<metric>.py   the reader of one per-layer metric

A traffic module has ``setup(run) -> state``, ``window(run, state,
seconds) -> (end-to-end values, calls)``, ``traced(run, state, n) ->
calls`` and ``check(run, state) -> [(name, number, limit)]``;
a metric module has ``read(run, state, trace, spans) -> number or None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from rtbench import compare
from rtbench import trace as tr
from rtbench.port_scene import port_scene

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = "rtbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell as its files give it."""

    name: str
    entry: dict          # its entry in BENCHMARK.json
    config: dict         # rtbench/configs/<config>.json
    workload: dict       # rtbench/workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str, moved: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moved is None or metric.get("moves") in moved


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, moved)]
    return Cell(name, entry, load_json(ROOT / conf["file"]),
                load_json(HERE / "workloads" / f"{name}.json"), e2e, per)


@dataclasses.dataclass
class Run:
    """What one run holds: the cell, the seed, the device, the scene."""

    cell: Cell
    seed: int
    device: torch.device
    arrays: dict = None
    scene: object = None          # the program's SceneData
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free_program(self) -> None:
        """Drop the program's graphs and scene before the reference runs."""
        from myraytracer_tpu_torch.ops import graphs

        graphs.clear()
        self.scene = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def generate(config: dict) -> dict:
    """The configuration's scene as plain arrays, from its generator."""
    gen = load_module(HERE / "scenes" / f"{config['generator']}.py")
    return gen.generate(**config["params"])


def _device_info(device: torch.device, peak: int) -> dict:
    """The result line's ``device``: one card (or the CPU in tests)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda") -> dict:
    """Run ``cell`` once and return the result line (a dict), its checks
    under ``checks`` last. ``t_start`` is the process's start on the
    host clock (``time.perf_counter``)."""
    dev = torch.device(device)
    run = Run(cell, int(seed), dev)
    traffic = load_module(HERE / "traffic" / f"{cell.workload['kind']}.py")
    _log(f"imports done at {time.perf_counter() - t_start:.3f} s")
    run.arrays = generate(cell.config)
    _log(f"scene generated at {time.perf_counter() - t_start:.3f} s")

    host = port_scene(run.arrays)
    t0 = time.perf_counter()
    run.scene = host.build(device=dev)
    run.sync()
    run.spans["build.scene_s"] = time.perf_counter() - t0
    _log(f"scene built in {run.spans['build.scene_s']:.3f} s")
    state = traffic.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up done at {setup_s:.3f} s")

    metrics: Dict[str, dict] = {}
    line_device: Dict[str, float] = {}
    breakdown = None
    if trace:
        calls, trc = _traced(run, traffic, state)
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(run, state, trc, run.spans)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line_device = {"busy_s": tr.busy_s(trc), "window_s": trc.window_s}
        breakdown = tr.breakdown(trc)
    else:
        values, calls = traffic.window(run, state, seconds)
    _log(f"{calls} calls made at {time.perf_counter() - t_start:.3f} s")
    peak = (torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0)
    if not trace:
        values.update(setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    t_check = time.perf_counter()
    checks = traffic.check(run, state)
    _log(f"checked in {time.perf_counter() - t_check:.3f} s")
    line = {"correct": compare.all_within(checks), "attempted": int(calls),
            "failed": sum(1 for _, v, lim in checks
                          if not (v == v and v <= lim)),
            "metrics": metrics,
            "device": {**_device_info(dev, int(peak)), **line_device}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def _log(msg: str) -> None:
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)


def _traced(run: Run, traffic, state):
    """The cell's traffic for ``trace_calls`` calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = int(run.cell.workload["trace_calls"])
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            calls = traffic.traced(run, state, n)
            run.sync()
    return calls, tr.from_profile(prof)
