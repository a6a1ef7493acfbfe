"""Shared helpers of the benchmark's own tests (``python -m pytest
rtbench/tests``). Cells run here on the CPU at a tiny size; the tests
marked ``needs_cuda`` run on the card and skip without one."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import harness  # noqa: E402

#: each configuration's parameters at a size a CPU test can hold
SMALL = {"office-1080p": {"tess": 2, "width": 64, "height": 36},
         "molecule-500": {"n_atoms": 50, "width": 48, "height": 48}}

#: a seed above 2**31, as the benchmark's runs draw them
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(name: str) -> harness.Cell:
    """The cell ``name`` with its configuration cut to CPU size."""
    cell = harness.find_cell(name)
    cell.config["params"].update(SMALL[cell.entry["config"]])
    cell.workload["trace_calls"] = 2
    cell.workload["check_frame"] = 1
    return cell


def run_small(name: str, seconds: float = 0.2, trace: bool = False,
              seed: int = SEED) -> dict:
    """One run of the cut cell on the CPU -> its result line."""
    import time

    return harness.run_cell(small_cell(name), seed, seconds, trace,
                            time.perf_counter(), device="cpu")


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
