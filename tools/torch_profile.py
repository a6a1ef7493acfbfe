#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's office render or training step on one GPU.

    python3 tools/torch_profile.py [--fwd-bwd] [--trace out.json]

Runs office (tess 10, 1920x1080) once to build and warm up, then five
times under torch.profiler, and prints: the wall time per run (the
profiler inflates it), the device-busy time (summed kernel time; one
stream, so kernels do not overlap), and device time per kernel, largest
first. By default the run is the forward render; ``--fwd-bwd`` profiles
the training step ``render_loss_grad_image`` instead (loss against a
target image and all 23 parameter gradients). ``--trace`` also writes a
Chrome trace. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


#: prefix of the training step's profiler ranges (ops/render.py)
PHASE = "mrt."


def phase_split(prof, reps: int):
    """[(phase, host ms, device ms)] per step for the training step's
    ranges: host time inside each range on the calling thread, and the
    time of the kernels that start inside the range's span on the device.
    Kernels outside every span ("backward+glue") are the backward, which
    the autograd engine launches from its own thread, and the glue between
    the phases."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = {e.key: e.cpu_time_total / reps / 1e3 for e in prof.key_averages()
            if e.key.startswith(PHASE) and e.device_type != cuda}
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in dev_events if e.name.startswith(PHASE)]
    dev = {}
    for e in dev_events:
        if e.name.startswith(PHASE):
            continue
        t = e.time_range.start
        name = next((n for a, b, n in spans if a <= t < b), "backward+glue")
        dev[name] = dev.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    order = [PHASE + n for n in ("refit", "topology", "replay", "backward")]
    return [(n, host.get(n, 0.0), dev.get(n, 0.0))
            for n in order + ["backward+glue"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fwd-bwd", action="store_true",
                    help="profile render_loss_grad_image, not render")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    reps, tess, width, height = 5, 10, 1920, 1080

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    scene = scene_08_office(tess=tess, resolution=(width, height))
    data = scene.build(device="cuda:0")
    if args.fwd_bwd:
        target = 0.9 * render(data, scene.camera) + 0.02

        def step():
            return render_loss_grad_image(data, scene.camera, target)
    else:
        def step():
            return render(data, scene.camera)
    step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / reps

    # device-side kernel events only (an aten op's row repeats its
    # kernels' time; a phase range shows on the device as a span)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(PHASE)]
    rows = [(e.self_device_time_total / reps / 1e3, e.count // reps, e.key)
            for e in events if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    own = sum(r[0] for r in rows if r[2].startswith("(anonymous namespace)::"))
    what = "fwd+bwd step" if args.fwd_bwd else "render"
    print(f"{gpu}; office tess {tess} {width}x{height}, {data.n_tris} "
          f"triangles; profiled: {what}")
    print(f"wall {wall * 1e3:.3f} ms/{what} (profiled), device busy "
          f"{busy:.3f} ms/{what} ({100 * busy / (wall * 1e3):.1f}% of the "
          f"window), of which the port's CUDA kernels {own:.3f} ms")
    if args.fwd_bwd:
        print(f"{'phase':>14} {'host ms':>9} {'device ms':>10}")
        for name, host, dev in phase_split(prof, reps):
            print(f"{name:>14} {host:9.3f} {dev:10.3f}")
    print(f"{'ms/run':>10} {'calls':>6}  kernel")
    for ms, calls, key in rows[:30]:
        print(f"{ms:10.4f} {calls:6d}  {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
