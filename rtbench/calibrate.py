"""Readings that the limits of a cell's check are set from (not run by the
benchmark's own runs).

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,3
        --what program|control|faults

Each reading prints as one JSON line: the numbers that ``compare.py``
compares, for

  program  the program against the reference. Frames: every pose of the
           orbit (the checked frame of any seed is one of them), with
           whether the AA budget covered the pixels above the threshold
           and how many differing pixels lie where the two sides refined
           different pixels. Fit: the first three steps of each seed.
  control  the reference computed in bfloat16 against the reference.
           Frames: the pose of each seed's sampled frame. Fit: each seed.
  faults   planted in the reference put in the program's place. Frames:
           the AA pass left out (the 1-spp image) at each seed's sampled
           pose. Fit: the loss taken over every other pixel, the mean over
           those.

One process reads every seed, so the set-up is paid once.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rtbench import compare, harness  # noqa: E402
from rtbench.reference import fit as F  # noqa: E402
from rtbench.reference import whitted as W  # noqa: E402


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _traffic(cell):
    return harness.load_module(harness.HERE / "traffic"
                               / f"{cell.workload['kind']}.py")


def frames_program(run, traffic) -> None:
    from myraytracer_tpu_torch.ops.render import render, render_aa
    from myraytracer_tpu_torch.ops.tracer import TraceConfig

    from rtbench.port_scene import port_camera

    wl = run.cell.workload
    cfg = TraceConfig(tri_method=run.cell.config["tri_method"])
    scene = W.RefScene(run.arrays, run.device)
    for i, pose in enumerate(traffic.poses(run)):
        cam = port_camera(pose, run.device)
        img = render_aa(run.scene, cam, cfg, subp=wl["subp"],
                        threshold=wl["threshold"], budget_frac=wl["budget"])
        img1 = render(run.scene, cam, cfg)
        ref, unsure = W.render_aa(scene, pose, wl["budget"], wl["subp"],
                                  wl["threshold"], ties=True)
        ref1 = W.render(scene, pose)
        H, Wd = img.shape[:2]
        K = min(max(1, int(H * Wd * wl["budget"])), H * Wd)

        def chosen(im):
            top, pix = torch.topk(W.deviation(im).reshape(-1), K)
            m = torch.zeros(H * Wd, dtype=torch.bool, device=im.device)
            m[pix[top > wl["threshold"]]] = True
            return m

        sym = chosen(img1) ^ chosen(ref1)
        bad = ((img - ref).abs().amax(-1) > compare.PIXEL_TOL).reshape(-1)
        above = int((W.deviation(ref1) > wl["threshold"]).sum())
        _emit(pose=i, yaw_pitch=pose["eye"], covered=above <= K, above=above,
              K=K, n_bad=int(bad.sum()), n_bad_where_refined_differs=int(
                  (bad & sym).sum()), n_refined_differs=int(sym.sum()),
              n_bad_sure=int((bad & ~unsure.reshape(-1)).sum()),
              unsure=float(unsure.float().mean()),
              **compare.image_numbers(img, ref, unsure))


def frames_reference(run, traffic, seeds, what: str) -> None:
    wl = run.cell.workload
    s32 = W.RefScene(run.arrays, run.device)
    s16 = W.RefScene(run.arrays, run.device, torch.bfloat16)
    for seed in seeds:
        run.seed = seed
        frame = int(np.random.default_rng(seed + 1).integers(
            0, wl["check_frame"]))
        pose = traffic.poses(run)[frame]
        ref, unsure = W.render_aa(s32, pose, wl["budget"], wl["subp"],
                                  wl["threshold"], ties=True)
        got = (W.render_aa(s16, pose, wl["budget"], wl["subp"],
                           wl["threshold"]) if what == "control"
               else W.render(s32, pose))
        _emit(seed=seed, what=what, **compare.image_numbers(got, ref, unsure))


def fit_program(run, traffic, seeds) -> None:
    wl = run.cell.workload
    scene = W.RefScene(run.arrays, run.device)
    for seed in seeds:
        run.seed = seed
        st = traffic.setup(run)
        first = st["first"]
        ref = F.fit_steps(scene, run.arrays["camera"], traffic.target(run),
                          wl["lr"], len(first["losses"]))
        _emit(seed=seed, what="program", **compare.fit_numbers(first, ref))
        del st
        from myraytracer_tpu_torch.ops import graphs
        graphs.clear()


def fit_reference(run, traffic, seeds, what: str) -> None:
    wl = run.cell.workload
    s32 = W.RefScene(run.arrays, run.device)
    other = (W.RefScene(run.arrays, run.device, torch.bfloat16)
             if what == "control" else s32)
    for seed in seeds:
        run.seed = seed
        tgt = traffic.target(run)
        ref = F.fit_steps(s32, run.arrays["camera"], tgt, wl["lr"], 3)
        got = F.fit_steps(other, run.arrays["camera"], tgt, wl["lr"], 3,
                          half=(what == "faults"))
        _emit(seed=seed, what=what, **compare.fit_numbers(got, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control", "faults"),
                    required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = harness.find_cell(args.workload)
    traffic = _traffic(cell)
    run = harness.Run(cell, seeds[0], torch.device("cuda"))
    run.arrays = harness.generate(cell.config)
    t0 = time.perf_counter()
    if args.what == "program":
        from rtbench.port_scene import port_scene

        run.scene = port_scene(run.arrays).build(device=run.device)
        if cell.workload["kind"] == "fit":
            fit_program(run, traffic, seeds)
        else:
            traffic.setup(run)
            frames_program(run, traffic)
    elif cell.workload["kind"] == "fit":
        fit_reference(run, traffic, seeds, args.what)
    else:
        frames_reference(run, traffic, seeds, args.what)
    print(f"calibrate: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
