#!/usr/bin/env python3
"""The port's bench and chip_smoke.py's phase 14 loop, in turns, on one GPU.

    python3 tools/bench_turns.py [--rounds N]

Both time office 1920x1080 (tess 10) through render, the training step
and render_aa on the BVH walk, each call a host clock around the call
and a device synchronise: the bench (``myraytracer_tpu_torch.bench``,
in process) reports the fastest of three calls after a warm one, phase
14's loop (``chip_smoke.timed``) three calls after a warm one, of which
this prints all three. The two run in turns, alternating which goes
first, N rounds each in two process states: "fresh" (only office on the
card) and "gallery" (the ten goldens and the mixed 1080p scene also
built on the card and held, as during chip_smoke.py's phase 14). If the
two agree within a state but the states differ, a difference between
the bench's and phase 14's numbers in one chip_smoke.py run comes from
the state of the process, not from what they time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from myraytracer_tpu_torch import bench
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import (render, render_aa,
                                                   render_loss_grad_image,
                                                   sized_aa_budget)
    from myraytracer_tpu_torch.scenes.golden import scene_08_office
    from myraytracer_tpu_torch.utils.profiling import gpu_line

    dev = "cuda:0"
    scene = scene_08_office(tess=10, resolution=(1920, 1080))
    data, cam = scene.build(device=dev), scene.camera
    cfg = tr.TraceConfig(tri_method="auto")
    budget, _ = sized_aa_budget(render(data, cam, cfg))
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    programs = (("fwd", lambda: render(data, cam, cfg)),
                ("fwd_bwd", lambda: render_loss_grad_image(data, cam, target,
                                                           cfg)),
                ("aa", lambda: render_aa(data, cam, cfg, budget_frac=budget)))

    def smoke():
        """Phase 14's loop: {program: [ms of each of three calls]}."""
        return {name: [round(s * 1e3, 3) for s in chip_smoke.timed(fn)[1]]
                for name, fn in programs}

    def bench_ms():
        """The bench's last line: {program: fastest ms of three}."""
        out = io.StringIO()
        rc = bench.main(["--res", "1920x1080", "--tess", "10"], out=out)
        if rc != 0:
            raise RuntimeError(f"bench exited {rc}")
        last = json.loads(out.getvalue().splitlines()[-1])
        return {name: round(last[f"{name}_s"] * 1e3, 3)
                for name, _ in programs}

    print(gpu_line())
    states = (("fresh", None), ("gallery", chip_smoke.build_gallery))
    for state, setup in states:
        held = setup(dev) if setup else None
        for r in range(args.rounds):
            order = ("smoke", "bench") if r % 2 == 0 else ("bench", "smoke")
            for who in order:
                got = smoke() if who == "smoke" else bench_ms()
                print(f"{state} round {r} {who}: "
                      + ", ".join(f"{k} {v}" for k, v in got.items())
                      + (" ms per call" if who == "smoke"
                         else " ms, fastest of 3"), flush=True)
        del held
    return 0


if __name__ == "__main__":
    sys.exit(main())
