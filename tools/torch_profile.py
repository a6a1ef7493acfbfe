#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's office render or training step on one GPU.

    python3 tools/torch_profile.py [--fwd-bwd] [--scene NAME] [--segments N]
        [--tri-method {cluster,bvh,brute}] [--eager] [--trace out.json]
        [--reps N]

Runs office (tess 10, 1920x1080) twice to build, warm up and capture its
CUDA graph, then five times under torch.profiler, and prints: the wall
time per run (the profiler inflates the host side, so take wall times
from an unprofiled run), the device-busy time (summed kernel time; one
stream, so kernels do not overlap), the device time per phase, and
device time per kernel, largest first. The phases are the program's
device marks (utils/profiling.mark): each stage of the entry point
(``rays``, ``aa.select``, ``aa.apply``, the training step's ``refit``,
``topology``, ``replay``, ``backward``) and, inside it, the trace's
phases (``segment``, ``analytic``, ``tri``, ``shade``, ``tri.bounce``,
``shade.autograd``);
they split a graph replay as they split an eager run. The entry points replay CUDA
graphs (ops/graphs.py) by default; ``--eager`` runs them under
``disable_graphs()``, the launches one by one. By default the run is the
forward render; ``--fwd-bwd`` profiles the training step
``render_loss_grad_image`` instead (loss against a target image and all
23 parameter gradients); ``--scene NAME`` profiles
``render_aa`` of that golden scene (e.g. o_04_molecule) at its golden
resolution and budget, or with ``--fwd-bwd`` its training step.
``--segments N`` traces only the first N Whitted segments (max_depth
N - 1): where the segments cut are dead, the results stay the same and
the time saved is what those segments cost. ``--tri-method`` picks the
triangle method (``TraceConfig.tri_method``; default "cluster", the
scan; "bvh" the walk K7). ``--trace`` also writes a Chrome trace. It
also prints the peak ``max_memory_reserved`` of the run and, with
``--fwd-bwd``, the gradient entries that are not finite. ``--reps``
sets the profiled runs (5).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time


#: prefix of the program's host spans (utils/profiling.span)
PHASE = "mrt."


def phase_split(prof, reps: int):
    """(stages, phases): device ms per run in each stage and each phase
    that the program's marks open (utils/profiling.mark), each kernel
    charged to the last mark that started before it. A stage is the last
    mark outside ``TRACE_PHASES``, which subdivide it; "(none)" holds
    the kernels before the first mark and after an ``end``."""
    import torch

    from myraytracer_tpu_torch.utils.profiling import TRACE_PHASES, phase_of

    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.events()
                     if e.device_type == cuda and not e.name.startswith(PHASE)
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    stages, phases = {}, {}
    stage = phase = "(none)"
    for e in events:
        mark = phase_of(e.name)
        if mark is not None:
            phase = "(none)" if mark == "end" else mark
            if mark not in TRACE_PHASES:
                stage = phase
            continue
        ms = e.time_range.elapsed_us() / reps / 1e3
        stages[stage] = stages.get(stage, 0.0) + ms
        phases[phase] = phases.get(phase, 0.0) + ms
    return stages, phases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fwd-bwd", action="store_true",
                    help="profile render_loss_grad_image, not render")
    ap.add_argument("--scene", default=None,
                    help="profile this golden scene's render_aa (its "
                         "training step with --fwd-bwd) instead")
    ap.add_argument("--segments", type=int, default=None,
                    help="trace only the first N Whitted segments")
    ap.add_argument("--tri-method", default="cluster",
                    choices=("cluster", "bvh", "brute", "auto"),
                    help="the triangle method (TraceConfig.tri_method)")
    ap.add_argument("--eager", action="store_true",
                    help="run eagerly (disable_graphs), not graph replays")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--reps", type=int, default=5,
                    help="profiled runs (default 5)")
    args = ap.parse_args()
    reps, tess, width, height = args.reps, 10, 1920, 1080

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import (render, render_aa,
                                                   render_loss_grad_image)
    from myraytracer_tpu_torch.ops.tracer import TraceConfig
    from myraytracer_tpu_torch.scenes.golden import (GOLDEN_SCENES,
                                                     scene_08_office)
    from myraytracer_tpu_torch.utils.profiling import gpu_line

    gpu = gpu_line()
    if args.scene:
        builder, budget = GOLDEN_SCENES[args.scene]
        scene = builder()
        width, height = scene.camera.width, scene.camera.height
    else:
        scene = scene_08_office(tess=tess, resolution=(width, height))
    data = scene.build(device="cuda:0")
    if args.segments:
        data = dataclasses.replace(data, max_depth=args.segments - 1,
                                   live_depth=args.segments)
    cfg = TraceConfig(tri_method=args.tri_method)
    if args.scene and not args.fwd_bwd:
        def step():
            return render_aa(data, scene.camera, budget_frac=budget, cfg=cfg)
    elif args.fwd_bwd:
        target = 0.9 * render(data, scene.camera, cfg=cfg) + 0.02

        def step():
            return render_loss_grad_image(data, scene.camera, target, cfg=cfg)
    else:
        def step():
            return render(data, scene.camera, cfg=cfg)
    mode = disable_graphs() if args.eager else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mode:
        step()          # eager: the warm-up; graphed: the key's warm-up
        step()          # graphed: the capture and its first replay
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(reps):
                out = step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / reps

    # device-side kernel events only (an aten op's row repeats its
    # kernels' time; a host span shows on the device as a span)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(PHASE)]
    rows = [(e.self_device_time_total / reps / 1e3, e.count // reps, e.key)
            for e in events if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # the port's kernels live in an anonymous namespace; a template
    # kernel's name (cluster_scan_kernel<...>) carries its return type
    own = sum(r[0] for r in rows if r[2].startswith(
        ("(anonymous namespace)::", "void (anonymous namespace)::")))
    what = ("fwd+bwd step" if args.fwd_bwd
            else "render_aa" if args.scene else "render")
    where = args.scene or f"office tess {tess}"
    print(f"{gpu}; {where} {width}x{height}, {data.n_tris} triangles, "
          f"{data.n_spheres + data.n_planes + data.n_cylinders} analytic "
          f"primitives, {data.n_segments} segment(s); tri_method "
          f"{args.tri_method}; profiled: {what}, "
          f"{'eager' if args.eager else 'CUDA graph replays'}")
    print(f"wall {wall * 1e3:.3f} ms/{what} (profiled), device busy "
          f"{busy:.3f} ms/{what}, of which the port's CUDA kernels "
          f"{own:.3f} ms")
    print(f"max_memory_reserved {torch.cuda.max_memory_reserved() / 2**30:.3f}"
          f" GiB over the warm-up, the capture and the runs")
    if args.fwd_bwd:
        bad = {k: int((~torch.isfinite(g)).sum()) for k, g in out[1].items()}
        print(f"gradient entries not finite: "
              f"{ {k: n for k, n in bad.items() if n} }")
    stages, phases = phase_split(prof, reps)
    for title, table in (("stage", stages), ("phase", phases)):
        print(f"{title:>14} {'device ms':>10}")
        for name, dev in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"{name:>14} {dev:10.3f}")
    print(f"{'ms/run':>10} {'calls':>6}  kernel")
    for ms, calls, key in rows[:30]:
        print(f"{ms:10.4f} {calls:6d}  {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
