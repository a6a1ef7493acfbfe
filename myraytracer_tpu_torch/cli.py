"""Command-line interface of the port.

    python -m myraytracer_tpu_torch render --scene examples/demo.sce --out img.png
    python -m myraytracer_tpu_torch render --golden o_08_office --scale 0.5 --aa
    python -m myraytracer_tpu_torch fit --golden o_05_cube --target t.png
    python -m myraytracer_tpu_torch bench [--res WxH] ...

Counterpart of ``myraytracer_tpu/cli.py``, with its verbs and arguments.
``--backend cuda`` (the default) runs on the GPU and exits 2 without one;
``--backend cpu`` runs the kernels' plain versions on the CPU. ``render``
and ``fit`` trace with ``TraceConfig(tri_method="auto")``, the BVH walk
(``--no-bvh``: every triangle, the brute-force oracle).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    from myraytracer_tpu_torch import bench

    ap = argparse.ArgumentParser(prog="python -m myraytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene file or golden scene")
    src = r.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="path to a .sce scene file")
    src.add_argument("--golden", help="golden scene name (e.g. o_08_office)")
    r.add_argument("--out", default="render.png")
    r.add_argument("--scale", type=float, default=1.0,
                   help="resolution scale for golden scenes")
    r.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    r.add_argument("--aa", action="store_true", help="adaptive supersampling")
    r.add_argument("--no-bvh", action="store_true", help="brute-force triangles")

    b = sub.add_parser("bench", help="run the office 1080p benchmark")
    bench.add_arguments(b)

    f = sub.add_parser(
        "fit", help="inverse rendering: fit scene parameters to a target "
                    "image (gradient descent through the renderer)")
    fsrc = f.add_mutually_exclusive_group(required=True)
    fsrc.add_argument("--scene", help="path to a .sce scene file")
    fsrc.add_argument("--golden", help="golden scene name")
    f.add_argument("--target", required=True, help="target PNG to match "
                   "(must be the scene's resolution)")
    f.add_argument("--params", default="mat_diffuse,light_color",
                   help="comma-separated float leaves to optimize (e.g. "
                   "mat_diffuse,light_pos,vertex_pos,cam_eye,cam_fovy)")
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--lr", type=float, default=5e-2)
    f.add_argument("--scale", type=float, default=1.0)
    f.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    f.add_argument("--out", default="fitted.png",
                   help="render of the fitted scene")
    f.add_argument("--checkpoint", help="checkpoint directory to save "
                   "(and resume from, if it exists)")
    return ap


def _load_scene(args):
    """The Scene of --scene or --golden (a unique substring of a golden's
    name is taken); None after printing why there is none."""
    if args.scene:
        from myraytracer_tpu_torch.models.sceneio import read_scene

        return read_scene(args.scene)
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES

    name = args.golden
    if name not in GOLDEN_SCENES:
        matches = [k for k in GOLDEN_SCENES if name in k]
        if len(matches) != 1:
            print(f"unknown golden scene {name!r}; choose from "
                  f"{sorted(GOLDEN_SCENES)}", file=sys.stderr)
            return None
        name = matches[0]
    return GOLDEN_SCENES[name][0](scale=args.scale)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.cmd == "bench":
        from myraytracer_tpu_torch import bench

        return bench.run(args)

    import torch

    if args.backend == "cuda" and not torch.cuda.is_available():
        print(f"{args.cmd}: no CUDA device; --backend cpu runs on the CPU",
              file=sys.stderr)
        return 2

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_aa
    from myraytracer_tpu_torch.utils.image import write_png

    sc = _load_scene(args)
    if sc is None:
        return 2
    cam = sc.camera

    if args.cmd == "fit":
        from myraytracer_tpu_torch.inverse import InverseRenderer, adam
        from myraytracer_tpu_torch.utils.image import read_png

        target = read_png(args.target)
        if target.shape[:2] != (cam.height, cam.width):
            print(f"target is {target.shape[1]}x{target.shape[0]} but the "
                  f"scene renders {cam.width}x{cam.height}", file=sys.stderr)
            return 2
        params = tuple(p for p in args.params.split(",") if p)
        data = sc.build(device=args.backend)
        inv = InverseRenderer(data, param_names=params,
                              optimizer=adam(args.lr), camera=cam)
        if args.checkpoint and os.path.isdir(args.checkpoint):
            inv.restore_checkpoint(args.checkpoint)
            print(f"resumed from {args.checkpoint} at step {inv.step_count}")
        xs, ys = cam.pixel_grid(data.device)
        t0 = time.time()
        res = inv.fit_pixels(xs.reshape(-1), ys.reshape(-1),
                             target.reshape(-1, 3), steps=args.steps,
                             log_every=max(1, args.steps // 10))
        dt = time.time() - t0
        if args.checkpoint:
            inv.save_checkpoint(args.checkpoint)
        img = render(res.scene, res.camera or cam,
                     tr.TraceConfig(tri_method="auto"))
        write_png(args.out, img.cpu().numpy())
        print(f"fit {','.join(params)} for {args.steps} steps in {dt:.1f}s: "
              f"loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f} -> "
              f"{args.out}")
        return 0

    t0 = time.time()
    data = sc.build(device=args.backend)
    t1 = time.time()
    cfg = tr.TraceConfig(tri_method="brute" if args.no_bvh else "auto")
    fn = render_aa if args.aa else render
    img = fn(data, cam, cfg=cfg).cpu().numpy()
    t2 = time.time()
    write_png(args.out, img)
    n_rays = cam.width * cam.height
    print(f"{cam.width}x{cam.height} | {data.n_tris} tris, "
          f"{data.n_spheres} spheres, {data.n_planes} planes, "
          f"{data.n_cylinders} cylinders | build {t1 - t0:.2f}s render "
          f"{t2 - t1:.2f}s ({n_rays / (t2 - t1) / 1e6:.2f} Mray/s) on "
          f"{args.backend} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
