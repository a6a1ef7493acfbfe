"""The port's benchmark: office 1920x1080 at 1 spp, forward and backward.

    python -m myraytracer_tpu_torch bench [--small] [--res WxH] [--tess N]
        [--fwd-only] [--no-aa] [--deadline-s S] [--backend cuda|cpu]

Counterpart of the repository's ``bench.py`` (the JAX package's bench),
with its keys. It prints JSON lines to stdout, each a superset of the one
before: **the last complete line wins**. The first line comes as soon as
the scene is built (``"stage": "starting"``), so a run cut by an outside
time limit still leaves a parseable line. While only the forward has been
measured, ``value`` is the forward's rays/s (``"stage": "fwd"``); from the
training step on it is the training step's (``"stage": "fwd_bwd"``):

  {"metric": "office_1080p_fwd_bwd_rays_per_s", "value": N,
   "unit": "rays/s/chip", "vs_baseline": N, ...}

The programs, all with ``TraceConfig(tri_method="auto")`` (the BVH walk,
the JAX package's default off the TPU):

  1. ``render``, the forward;
  2. ``render_loss_grad_image`` against a black target, the training step;
  3. ``render_aa`` with the budget sized from the pass-1 image
     (``ops.render.sized_aa_budget``); ``aa_budget_covered`` says whether
     that budget covers every pixel above the AA threshold.

Each program runs once untimed first (the first call of a process also
builds the CUDA kernels). ``*_s`` is the fastest of three calls, each a
host clock around the call and a device synchronise; ``*_s_pipelined``
the fastest of two batches of five calls with one synchronise a batch,
per call. On the card each program replays a CUDA graph
(ops/graphs.py): the untimed call is its eager warm-up, the first timed
call captures it and replays it, the others replay it, so the fastest
of three and the pipelined batches time replays. ``vs_baseline`` holds
the rate against the reference renderer's published office number, 5.3
s for 1920x1080 (its forward;
``aa_vs_baseline`` against its 5.31 s with supersampling). ``device`` is
the card's name and power limit as nvidia-smi reports them, or "cpu".

Without ``--res`` or ``--small`` a provisional 480x270 run comes first
(its lines carry ``"provisional_small": true``); ``--small`` runs only
that size. ``--deadline-s S`` prints the best line so far after S
seconds and exits 0. ``--backend cuda`` (the default) needs a GPU and
exits 2 without one; ``--backend cpu`` runs the kernels' plain versions
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import time

import torch

#: the reference renderer's published office 1920x1080 times, in seconds:
#: the forward, and the forward with adaptive supersampling
BASELINE_S, BASELINE_AA_S = 5.3, 5.31
#: timed calls of each program, and calls per batch of the pipelined times
REPS, NPIPE = 3, 5
FULL, SMALL = (1920, 1080), (480, 270)

#: the keys of a finished run's last line: the JAX package's bench's,
#: and the port's aa_budget_covered and tri_method
KEYS = ("metric", "value", "unit", "vs_baseline", "stage", "resolution",
        "n_tris", "bvh_nodes", "scene_build_s", "fwd_s", "fwd_s_pipelined",
        "fwd_bwd_s", "fwd_bwd_s_pipelined", "loss_finite", "aa_budget",
        "aa_budget_covered", "aa_s", "aa_s_pipelined", "total_wall_s",
        "device", "tri_method")


class _Lines:
    """The newest result and the stream its JSON lines go to."""

    def __init__(self, out) -> None:
        self.out = out
        self.result = None

    def emit(self) -> None:
        if self.result:
            self.out.write(json.dumps(self.result) + "\n")
            self.out.flush()


def _resolution(text: str):
    try:
        w, h = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected WxH, got {text!r}") from None
    if w <= 0 or h <= 0:
        raise argparse.ArgumentTypeError(f"expected WxH > 0, got {text!r}")
    return w, h


def add_arguments(ap: argparse.ArgumentParser) -> None:
    """The bench's arguments (shared with the CLI's ``bench`` verb)."""
    ap.add_argument("--small", action="store_true",
                    help="only the 480x270 stage")
    ap.add_argument("--res", type=_resolution, default=None,
                    help="one stage at this WxH resolution")
    ap.add_argument("--tess", type=int, default=10,
                    help="office tessellation level")
    ap.add_argument("--fwd-only", action="store_true",
                    help="skip the training step and render_aa")
    ap.add_argument("--no-aa", action="store_true", help="skip render_aa")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="print the best line so far after this many "
                         "seconds and exit 0")
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")


def _measure(lines: _Lines, args, width: int, height: int,
             provisional: bool) -> None:
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import (aa_budget_covered, render,
                                                   render_aa,
                                                   render_loss_grad_image,
                                                   sized_aa_budget)
    from myraytracer_tpu_torch.scenes.golden import scene_08_office
    from myraytracer_tpu_torch.utils.profiling import device_line

    t_start = time.perf_counter()
    dev = torch.device(args.backend)
    sc = scene_08_office(tess=args.tess, resolution=(width, height))
    t0 = time.perf_counter()
    scene = sc.build(device=dev)
    build_s = time.perf_counter() - t0
    cam = sc.camera
    cfg = tr.TraceConfig(tri_method="auto")
    sys.stderr.write(f"bench: {width}x{height}, scene built in {build_s:.2f} s "
                     f"({scene.n_tris} tris)\n")
    n_rays = width * height
    base = FULL[0] * FULL[1] / BASELINE_S

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    result = {
        "metric": "office_1080p_fwd_bwd_rays_per_s",
        "value": 0.0,
        "unit": "rays/s/chip",
        "vs_baseline": 0.0,
        "stage": "starting",
        "resolution": f"{width}x{height}",
        "n_tris": int(scene.n_tris),
        "bvh_nodes": int(scene.n_nodes),
        "tri_method": cfg.resolved_method(),
        "scene_build_s": round(build_s, 6),
        "device": device_line(dev),
    }
    if provisional:
        # a small-size stand-in; any later full-size line supersedes it
        result["provisional_small"] = True
    lines.result = result
    lines.emit()

    def timed(fn, record) -> None:
        """One untimed call, then REPS timed ones; after each, ``record``
        the fastest so far (and that call's output), and a line."""
        fn()
        sync()
        best = math.inf
        for _ in range(REPS):
            t = time.perf_counter()
            out = fn()
            sync()
            best = min(best, time.perf_counter() - t)
            record(best, out)
            result["total_wall_s"] = round(time.perf_counter() - t_start, 3)
            lines.emit()

    def pipelined(fn) -> float:
        """Seconds per call over NPIPE calls and one synchronise, the
        fastest of two batches (a loaded host can starve one batch)."""
        best = math.inf
        for _ in range(2):
            t = time.perf_counter()
            for _ in range(NPIPE):
                fn()
            sync()
            best = min(best, (time.perf_counter() - t) / NPIPE)
        return round(best, 6)

    def fwd():
        return render(scene, cam, cfg)

    def fwd_record(s, _):
        result.update(stage="fwd", value=round(n_rays / s, 1),
                      vs_baseline=round(n_rays / s / base, 3),
                      fwd_rays_per_s=round(n_rays / s, 1), fwd_s=round(s, 6))

    timed(fwd, fwd_record)
    result["fwd_s_pipelined"] = pipelined(fwd)
    lines.emit()
    if args.fwd_only:
        return

    target = torch.zeros((height, width, 3), device=dev)

    def fwd_bwd():
        return render_loss_grad_image(scene, cam, target, cfg)

    def fwd_bwd_record(s, out):
        loss, grads = out
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        result.update(stage="fwd_bwd", value=round(n_rays / s, 1),
                      vs_baseline=round(n_rays / s / base, 3),
                      fwd_bwd_s=round(s, 6), loss_finite=finite)

    timed(fwd_bwd, fwd_bwd_record)
    result["fwd_bwd_s_pipelined"] = pipelined(fwd_bwd)
    lines.emit()
    if args.no_aa:
        return

    img1 = render(scene, cam, cfg)
    budget, frac = sized_aa_budget(img1)
    result.update(aa_budget=budget,
                  aa_budget_covered=aa_budget_covered(img1, budget))
    sys.stderr.write(f"bench: AA above-threshold fraction {frac:.4f} -> "
                     f"budget {budget}\n")
    base_aa = FULL[0] * FULL[1] / BASELINE_AA_S

    def aa():
        return render_aa(scene, cam, cfg, budget_frac=budget)

    def aa_record(s, _):
        result.update(aa_s=round(s, 6), aa_rays_per_s=round(n_rays / s, 1),
                      aa_vs_baseline=round(n_rays / s / base_aa, 3))

    timed(aa, aa_record)
    result["aa_s_pipelined"] = pipelined(aa)
    result["total_wall_s"] = round(time.perf_counter() - t_start, 3)
    lines.emit()


def run(args, out=None) -> int:
    """Run the bench with parsed ``args``, writing its JSON lines to
    ``out`` (stdout by default); returns the exit code."""
    if args.backend == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; --backend cpu runs on the CPU",
              file=sys.stderr)
        return 2
    lines = _Lines(out or sys.stdout)
    if args.deadline_s:
        def on_deadline(signum, frame):
            sys.stderr.write("bench: deadline reached, printing the best "
                             "line so far\n")
            lines.emit()
            os._exit(0)

        signal.signal(signal.SIGALRM, on_deadline)
        signal.alarm(max(1, math.ceil(args.deadline_s)))
    try:
        if args.res:
            stages = [(args.res, False)]
        elif args.small:
            stages = [(SMALL, False)]
        else:
            stages = [(SMALL, True), (FULL, False)]
        for (w, h), provisional in stages:
            _measure(lines, args, w, h, provisional)
    finally:
        if args.deadline_s:
            signal.alarm(0)
    return 0


def main(argv=None, out=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m myraytracer_tpu_torch bench",
        description="office 1920x1080: forward, training step, render_aa")
    add_arguments(ap)
    return run(ap.parse_args(argv), out)


if __name__ == "__main__":
    sys.exit(main())
