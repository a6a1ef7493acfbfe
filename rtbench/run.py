"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. It needs CUDA and as many cards as the cell
asks for; without them it exits 2 and prints no result. It loads the
cell's scene into the program, warms up every graph the cell replays,
then runs its traffic for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or a traced stretch of it (``--trace 1``: the per-layer
metrics, the device's busy time and the breakdown), checks what the
program produced against the plain reference, prints each compared
number beside its limit as the last lines of standard error, and prints
one JSON line last on standard output. It exits 3, printing no result,
if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "myraytracer_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from rtbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("rtbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"rtbench: {cell.name} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            T_START)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
