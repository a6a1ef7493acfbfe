"""Fit a golden scene's palette to its reference PNG by inverse rendering,
with the PyTorch/CUDA port.

The port's counterpart of tools/fit_palette.py, step for step: render the
golden scene at ``--scale`` of its resolution through the port's
differentiable ``trace`` (on the card: the topology kernels, then the
shading replay and its backward), clamp to 1, take the mean colour of
each cell of a GRID x GRID partition, and move the colour-like scene
leaves (FIT_LEAVES) by Adam against the same cells of the reference PNG
(``outputs/<scene>.png`` unless ``--target`` names another). After each
step the leaves are clipped to physical ranges, as the reference tool
clips them.

Usage:
  python tools/fit_palette_torch.py o_07_toon_faces [--steps 300]
      [--scale 0.25] [--lr 2e-2] [--device cuda] [--target PATH]

It runs on the GPU by default; ``--device cpu`` runs it on the CPU with
the kernels' plain versions. Prints the cell MSE every 25 steps and at
the last, the final cell deltas and the fitted leaves.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from myraytracer_tpu_torch.ops import tracer as tr  # noqa: E402
from myraytracer_tpu_torch.parallel.shard_render import merge_params  # noqa: E402
from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES  # noqa: E402
from myraytracer_tpu_torch.utils.image import read_png  # noqa: E402

GRID = 8

#: leaves the palette fit may move (colors + global light/tone; geometry
#: and camera stay fixed so composition cannot drift)
FIT_LEAVES = ("mat_ambient", "mat_diffuse", "mat_specular", "light_color",
              "ambience", "background", "mat_mirror")


def cells(img: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """[grid, grid, 3] mean colour of each cell of [H, W, 3] ``img``."""
    h, w, _ = img.shape
    ys = np.linspace(0, h, grid + 1).astype(int)
    xs = np.linspace(0, w, grid + 1).astype(int)
    return torch.stack([
        torch.stack([img[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean((0, 1))
                     for j in range(grid)]) for i in range(grid)])


def clip_max(name: str) -> float:
    """The upper bound of a leaf after each step (the lower is 0)."""
    return 1.5 if name.startswith("mat") or name in (
        "ambience", "background") else 2.0


def fit(scene_name: str, steps: int, scale: float, lr: float, device: str,
        target: Optional[str] = None, log=print) -> Dict:
    """Adam on FIT_LEAVES for ``steps`` steps. Returns the cell MSE of
    each step (before its update), the seconds of each step, the final
    cell deltas (mean and max over the cells of the mean absolute
    channel difference) and the fitted leaves."""
    builder, _ = GOLDEN_SCENES[scene_name]
    sc = builder(scale=scale)
    data = sc.build(device=device)
    ref = read_png(target or os.path.join(REPO, "outputs",
                                          f"{scene_name}.png"))
    ref_cells = cells(torch.from_numpy(ref).to(device))

    cam = sc.camera
    xs, ys = cam.pixel_grid(device)
    o, d = (t.contiguous() for t in cam.primary_rays(xs.reshape(-1),
                                                     ys.reshape(-1)))
    H, W = cam.height, cam.width
    params = {n: getattr(data, n).detach().clone().requires_grad_(True)
              for n in FIT_LEAVES}
    opt = torch.optim.Adam(params.values(), lr=lr)

    def image(p) -> torch.Tensor:
        img = tr.trace(merge_params(data, p), o, d).reshape(H, W, 3)
        return torch.clamp(img, max=1.0)

    losses: List[float] = []
    secs: List[float] = []
    for i in range(steps):
        t = time.perf_counter()
        opt.zero_grad()
        dc = cells(image(params)) - ref_cells
        loss = torch.mean(dc * dc)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for k, v in params.items():
                v.clamp_(0.0, clip_max(k))
        losses.append(float(loss.detach()))
        secs.append(time.perf_counter() - t)
        if i % 25 == 0 or i == steps - 1:
            log(f"step {i}: cell-mse {losses[-1]:.6f}")

    with torch.no_grad():
        diff = (cells(image(params)) - ref_cells).abs().mean(-1)
    return dict(losses=losses, step_s=secs,
                cell_delta_mean=float(diff.mean()),
                cell_delta_max=float(diff.max()),
                params={k: v.detach() for k, v in params.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", choices=sorted(GOLDEN_SCENES))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--target", help="reference PNG (default "
                    "outputs/<scene>.png)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("fit_palette_torch: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2

    out = fit(args.scene, args.steps, args.scale, args.lr, args.device,
              args.target)
    print(f"final cell delta: mean {out['cell_delta_mean']:.4f} "
          f"max {out['cell_delta_max']:.4f}")
    np.set_printoptions(precision=3, suppress=True)
    for n in FIT_LEAVES:
        print(f"--- {n} ---")
        print(out["params"][n].cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
