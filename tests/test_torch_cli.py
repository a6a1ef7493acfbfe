"""The port's command line (``python -m myraytracer_tpu_torch``) on the CPU.

tests/test_cli.py's cases with ``--backend cpu``, plus parity: the same
``render`` through both packages' CLIs gives PNGs within 1/255 on at
least 99.5% of pixels: the port's default (the BVH walk, plain versions
on the CPU) against the reference's brute-force triangle oracle
(``--no-bvh``, which compiles in a fraction of its walk's time); a
flipped fp tie changes a pixel's hit. Without ``--backend cpu`` and
without a GPU every verb exits non-zero: nothing falls back to the CPU.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from myraytracer_tpu.cli import main as r_main
from myraytracer_tpu.utils.image import read_png as r_read_png

from myraytracer_tpu_torch.cli import main
from myraytracer_tpu_torch.utils.image import read_png, write_png

from test_torch_scene import REPO

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

GOLDEN = ["--golden", "o_05_cube", "--scale", "0.08"]
CPU = ["--backend", "cpu"]

SCENE_FILE = (
    "camera 0 0 5  0 0 0  0 1 0  45 32 24\n"
    "light 2 4 4  0.8 0.8 0.8\n"
    "ambience 0.2 0.2 0.2\n"
    "background 0 0 0\n"
    "depth 2\n"
    "sphere 0 0 0  1.0  0.2 0 0  0.7 0 0  0.5 0.5 0.5  30  0\n"
)


@pytest.mark.parametrize("case,args,shape", [
    ("golden", GOLDEN, (40, 40, 3)),
    ("prefix", ["--golden", "o_05", "--scale", "0.08"], (40, 40, 3)),
    ("aa", GOLDEN + ["--aa"], (40, 40, 3)),
    ("brute", GOLDEN + ["--no-bvh"], (40, 40, 3)),
    ("scene_file", None, (24, 32, 3)),
    ("demo", ["--scene", str(REPO / "examples" / "demo.sce")], (480, 640, 3)),
])
def test_render(case, args, shape, tmp_path, capsys):
    if args is None:
        sce = tmp_path / "s.sce"
        sce.write_text(SCENE_FILE)
        args = ["--scene", str(sce)]
    out = str(tmp_path / "r.png")
    assert main(["render", *args, *CPU, "--out", out]) == 0
    img = read_png(out)
    assert img.shape == shape
    assert img.max() > 0.2                      # something rendered
    assert "on cpu" in capsys.readouterr().out


def test_render_matches_reference_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    ours, theirs = str(tmp_path / "p.png"), str(tmp_path / "r.png")
    assert main(["render", *GOLDEN, *CPU, "--out", ours]) == 0
    assert r_main(["render", *GOLDEN, "--no-bvh", "--backend", "cpu",
                   "--out", theirs]) == 0
    a, b = read_png(ours), r_read_png(theirs)
    assert a.shape == b.shape == (40, 40, 3)
    close = np.abs(a - b).max(axis=-1) <= 1 / 255 + 1e-6
    assert close.mean() >= 0.995, close.mean()


def test_fit_verb(tmp_path, capsys):
    # target = a darkened render of the same scene; the fit must move the
    # render toward it by dimming materials
    tgt = str(tmp_path / "t.png")
    assert main(["render", *GOLDEN, *CPU, "--out", tgt]) == 0
    img = read_png(tgt)
    write_png(tgt, np.clip(img * 0.75, 0, 1))
    out = str(tmp_path / "fit.png")
    ck = str(tmp_path / "ckpt")
    fit = ["fit", *GOLDEN, *CPU, "--target", tgt, "--params",
           "mat_diffuse,mat_ambient", "--lr", "0.05", "--out", out,
           "--checkpoint", ck]
    assert main(fit + ["--steps", "12"]) == 0
    assert read_png(out).mean() < img.mean()
    assert "resumed" not in capsys.readouterr().out
    # the checkpoint directory exists now: the next fit resumes from it
    assert main(fit + ["--steps", "3"]) == 0
    assert "resumed from" in capsys.readouterr().out.split("\n")[0]
    assert read_png(out).mean() < img.mean()


@pytest.mark.parametrize("argv", [
    ["fit", *GOLDEN, *CPU, "--target", "{tgt}", "--steps", "1"],
    ["render", "--golden", "nope", *CPU, "--out", "{out}"],
])
def test_bad_input_exits_2(argv, tmp_path):
    tgt = str(tmp_path / "t.png")
    write_png(tgt, np.zeros((8, 8, 3), np.float32))        # wrong size
    argv = [a.format(tgt=tgt, out=tmp_path / "r.png") for a in argv]
    assert main(argv) == 2


@pytest.mark.parametrize("verb", ["render", "fit"])
def test_needs_a_gpu_without_backend_cpu(verb, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs")
    argv = {"render": ["render", *GOLDEN, "--out", str(tmp_path / "r.png")],
            "fit": ["fit", *GOLDEN, "--target", str(tmp_path / "t.png")]}
    assert main(argv[verb]) == 2
    assert "--backend cpu" in capsys.readouterr().err
    assert not (tmp_path / "r.png").exists()


def test_module_entry_point(tmp_path, capsys):
    """``python -m myraytracer_tpu_torch``: the verbs, and its exit code
    (2 for a render without --backend cpu on a box without a GPU)."""
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0
    usage = capsys.readouterr().out
    assert all(v in usage for v in ("render", "fit", "bench"))
    argv = ["render", *GOLDEN, "--out", str(tmp_path / "r.png")]
    if torch.cuda.is_available():
        argv += ["--backend", "cpu"]
    out = subprocess.run([sys.executable, "-m", "myraytracer_tpu_torch",
                          *argv], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == (0 if torch.cuda.is_available() else 2), out.stderr
