"""The port's bench (``python -m myraytracer_tpu_torch bench``) on the CPU.

At 64x48, office tess 2, with one timed call and pipelined batches of one
call (the CPU runs the plain versions; the card's numbers come from
chip_smoke.py's phase 19): its lines parse, each one a superset of the
one before, and the last holds the JAX package's bench keys with finite
values. Without ``--backend cpu`` and without a GPU it exits non-zero.
"""

import io
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from myraytracer_tpu_torch import bench
from myraytracer_tpu_torch.cli import main as cli_main
from myraytracer_tpu_torch.ops.render import (AA_THRESHOLD, _deviation,
                                               aa_budget_covered,
                                               sized_aa_budget)

from test_torch_scene import REPO

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

#: the JAX package's bench keys (bench.py)
REF_KEYS = ("metric", "value", "unit", "vs_baseline", "stage", "resolution",
            "n_tris", "bvh_nodes", "scene_build_s", "fwd_s",
            "fwd_s_pipelined", "fwd_bwd_s", "fwd_bwd_s_pipelined",
            "loss_finite", "aa_budget", "aa_s", "aa_s_pipelined",
            "total_wall_s", "device")


def test_bench_lines_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "NPIPE", 1)
    out = io.StringIO()
    assert bench.main(["--backend", "cpu", "--res", "64x48", "--tess", "2"],
                      out=out) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0]["stage"] == "starting"
    for a, b in zip(lines, lines[1:]):
        assert set(a) <= set(b)
    last = lines[-1]
    assert set(REF_KEYS) <= set(bench.KEYS)
    assert set(bench.KEYS) <= set(last), set(bench.KEYS) - set(last)
    assert last["metric"] == "office_1080p_fwd_bwd_rays_per_s"
    assert last["stage"] == "fwd_bwd" and last["resolution"] == "64x48"
    assert last["device"] == "cpu" and last["tri_method"] == "bvh"
    assert last["loss_finite"] is True and last["aa_budget_covered"] is True
    assert last["n_tris"] == 5248 and last["bvh_nodes"] > 1
    for k, v in last.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v >= 0, k
    rate = 64 * 48 / last["fwd_bwd_s"]
    assert abs(last["value"] - rate) <= 1e-3 * rate
    assert abs(last["vs_baseline"]
               - rate / (1920 * 1080 / bench.BASELINE_S)) <= 1e-3


@pytest.mark.parametrize("argv,stage", [
    (["--fwd-only", "--res", "32x24"], "fwd"),
    (["--no-aa", "--res", "16x16"], "fwd_bwd"),
])
def test_bench_skips(argv, stage, monkeypatch):
    monkeypatch.setattr(bench, "REPS", 1)
    monkeypatch.setattr(bench, "NPIPE", 1)
    out = io.StringIO()
    assert bench.main(["--backend", "cpu", "--tess", "1", *argv],
                      out=out) == 0
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last["stage"] == stage and "aa_s" not in last
    assert ("fwd_bwd_s" in last) == (stage == "fwd_bwd")


def test_bench_needs_a_gpu_without_backend_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs")
    out = io.StringIO()
    assert bench.main(["--res", "64x48", "--tess", "2"], out=out) == 2
    assert out.getvalue() == ""
    assert "--backend cpu" in capsys.readouterr().err
    assert cli_main(["bench", "--small"]) == 2


def test_bench_deadline_prints_the_best_line_and_exits_0():
    """At --deadline-s the bench prints its newest line once more and
    exits 0, in the middle of a run that takes about 40 s here."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "myraytracer_tpu_torch", "bench", "--backend",
         "cpu", "--res", "64x48", "--tess", "2", "--deadline-s", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "deadline reached" in out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(lines) >= 2 and lines[-1] == lines[-2]
    assert lines[-1]["stage"] in ("starting", "fwd", "fwd_bwd")
    assert "aa_s_pipelined" not in lines[-1]


def test_bench_rejects_a_bad_resolution():
    with pytest.raises(SystemExit):
        bench.main(["--backend", "cpu", "--res", "64by48"])


def test_sized_aa_budget():
    """The budget covers the pixels above the threshold with a 10% margin,
    in steps of 0.0025, and at least 0.01."""
    img = torch.zeros(40, 40, 3)
    img[10:30, 10:30] = 1.0                       # one bright square
    budget, frac = sized_aa_budget(img)
    assert frac == float((_deviation(img) > AA_THRESHOLD).float().mean()) > 0
    assert budget == max(0.01, math.ceil(frac * 1.1 / 0.0025) * 0.0025)
    assert budget >= frac and aa_budget_covered(img, budget)
    assert sized_aa_budget(torch.zeros(8, 8, 3)) == (0.01, 0.0)
