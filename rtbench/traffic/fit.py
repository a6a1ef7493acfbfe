"""Traffic ``fit``: Adam steps of ``InverseRenderer.fit_pixels`` over every
pixel of the image, against a target photograph.

The cell's file gives the fitted leaves (``leaves``), the learning rate
(``lr``), the texel fetch (``texture_filter``; the triangle method is the
configuration's), and how many steps one call of ``fit_pixels`` takes
(``chunk``). The target is a low-frequency colour field drawn from the
seed on the device (``target``): ``waves`` cosines per channel over the
image, of up to ``cycles`` periods across it, around a mean of 0.5,
clamped to [0.02, 0.98]. A step's work does not depend on the target,
so every seed does the same work.

Set-up builds the renderer and takes its first three steps through
``fit_pixels`` (one, then two): the first is the eager warm-up, the
second captures the step, the third replays it. It keeps each step's
loss, the first gradient as Adam holds it (``exp_avg`` / (1 - beta1)
after one step) and the leaves' change over the three; the window goes
on with the same renderer. Checked: those against the reference's three
steps from the scene's own leaves.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from rtbench import compare
from rtbench.port_scene import port_camera
from rtbench.reference import fit as F
from rtbench.reference import whitted as W


def target(run) -> torch.Tensor:
    """The seed's target photograph, [H * W, 3] in raster order."""
    cam, p = run.arrays["camera"], run.cell.workload["target"]
    g = torch.Generator(device=run.device).manual_seed(run.seed)
    H, Wd = cam["height"], cam["width"]
    k = int(p["waves"])

    def draw(*shape):
        return torch.rand(shape, generator=g, device=run.device)

    freq = (draw(3, k, 2) * 2.0 - 1.0) * float(p["cycles"])
    phase = draw(3, k) * 2.0 * math.pi
    amp = draw(3, k) * (0.4 / k)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=run.device) / H,
        torch.arange(Wd, dtype=torch.float32, device=run.device) / Wd,
        indexing="ij")
    arg = (2.0 * math.pi * (freq[..., 0, None, None] * xs
                            + freq[..., 1, None, None] * ys)
           + phase[..., None, None])
    img = 0.5 + (amp[..., None, None] * torch.cos(arg)).sum(1)   # [3, H, W]
    return img.clamp(0.02, 0.98).permute(1, 2, 0).reshape(-1, 3).contiguous()


def setup(run) -> Dict[str, object]:
    """The renderer, its first three steps and what they left."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.ops.tracer import TraceConfig

    wl = run.cell.workload
    cam = port_camera(run.arrays["camera"], run.device)
    inv = InverseRenderer(
        run.scene, param_names=tuple(wl["leaves"]), optimizer=adam(wl["lr"]),
        cfg=TraceConfig(tri_method=run.cell.config["tri_method"],
                        texture_filter=wl["texture_filter"]), camera=cam)
    xs, ys = cam.pixel_grid(run.device)
    st = {"inv": inv, "xs": xs.reshape(-1), "ys": ys.reshape(-1),
          "target": target(run)}
    start = {k: v.detach().clone() for k, v in inv.params.items()}
    losses = _steps(st, 1)
    beta1 = inv.optimizer.param_groups[0]["betas"][0]
    # an optimizer that kept no state gives no gradient (read as zeros)
    grad1 = {k: inv.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
             .detach().clone() / (1.0 - beta1)
             for k, p in inv.params.items()}
    losses += _steps(st, 2)
    st["first"] = {"losses": losses, "grad1": grad1,
                   "change": {k: v.detach() - start[k]
                              for k, v in inv.params.items()}}
    return st


def _steps(st, n: int):
    return st["inv"].fit_pixels(st["xs"], st["ys"], st["target"],
                                steps=n).losses


def window(run, st, seconds: float):
    """Calls of ``chunk`` steps until ``seconds`` have passed -> (metrics,
    steps)."""
    chunk = int(run.cell.workload["chunk"])
    n = 0
    t0 = time.perf_counter()
    while True:
        _steps(st, chunk)
        n += chunk
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    return {"fit_steps_per_s": n / (t1 - t0)}, n


def traced(run, st, n: int) -> int:
    """``n`` calls of ``chunk`` steps, each a span."""
    from torch.profiler import record_function

    chunk = int(run.cell.workload["chunk"])
    for _ in range(n):
        with record_function("rtbench.fit_pixels"):
            _steps(st, chunk)
    return n * chunk


def check(run, st):
    """The first three steps against the reference's."""
    wl = run.cell.workload
    first = st.pop("first")
    st.clear()
    run.free_program()
    tgt = target(run)
    scene = W.RefScene(run.arrays, run.device)
    ref = F.fit_steps(scene, run.arrays["camera"], tgt, wl["lr"],
                      len(first["losses"]))
    return compare.checks(compare.fit_numbers(first, ref), wl["limits"])
