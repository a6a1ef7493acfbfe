#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's office forward render on one GPU.

    python3 tools/torch_profile.py [--trace out.json]

Renders office (tess 10, 1920x1080) once to build and warm up, then five
times under torch.profiler, and prints: the wall time per render (the
profiler inflates it), the device-busy time (summed kernel time; one
stream, so kernels do not overlap), and device time per kernel, largest
first. ``--trace`` also writes a Chrome trace. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    reps, tess, width, height = 5, 10, 1920, 1080

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from myraytracer_tpu_torch.ops.render import render
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    scene = scene_08_office(tess=tess, resolution=(width, height))
    data = scene.build(device="cuda:0")
    render(data, scene.camera)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            render(data, scene.camera)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / reps

    # device-side events only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [(e.self_device_time_total / reps / 1e3, e.count // reps, e.key)
            for e in events if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    own = sum(r[0] for r in rows if r[2].startswith("(anonymous namespace)::"))
    print(f"{gpu}; office tess {tess} {width}x{height}, {data.n_tris} triangles")
    print(f"wall {wall * 1e3:.3f} ms/render (profiled), device busy "
          f"{busy:.3f} ms/render ({100 * busy / (wall * 1e3):.1f}% of the "
          f"window), of which the port's CUDA kernels {own:.3f} ms")
    print(f"{'ms/render':>10} {'calls':>6}  kernel")
    for ms, calls, key in rows[:30]:
        print(f"{ms:10.4f} {calls:6d}  {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
