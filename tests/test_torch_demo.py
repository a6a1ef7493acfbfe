"""The port's inverse-rendering demo (examples/inverse_demo_torch.py) on
the CPU at 24x24 with 5 steps: each of its three fits lowers its loss,
and the three PNGs are written at the demo's resolution. Without
``--cpu`` and without a GPU it raises: nothing falls back to the CPU.
"""

import importlib.util

import pytest
import torch

from myraytracer_tpu_torch.utils.image import read_png

from test_torch_scene import REPO

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def demo():
    spec = importlib.util.spec_from_file_location(
        "inverse_demo_torch", REPO / "examples" / "inverse_demo_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_fits_on_the_cpu(demo, tmp_path, capsys):
    out = demo.main(["--res", "24", "--steps", "5", "--cpu",
                     "--out", str(tmp_path)])
    for name in ("materials", "pose", "zoom"):
        losses = out[name]
        assert losses[-1] < losses[0], (name, losses)
    assert len(out["materials"]) == 5
    for path in out["pngs"].values():
        assert read_png(path).shape == (24, 24, 3)
    assert "loss: " in capsys.readouterr().out


def test_demo_needs_a_gpu_without_cpu_flag(demo, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--res", "8", "--steps", "1", "--out", str(tmp_path)])
