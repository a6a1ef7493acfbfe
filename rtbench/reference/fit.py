"""The plain reference of a fit: the mean squared error of the linear image
against a target, its gradient in the fitted leaves, and Adam's steps.

The leaves are the material table's diffuse colours (``mat_diffuse``)
and the lights' colours (``light_color``). Neither moves a hit or a
shadow, so the segments are traced once (whitted.py, no gradient) and
each step shades them again under autograd: the loss is
``mean((colour - target)^2)`` over every pixel and channel, and Adam
(``lr * m_hat / (sqrt(v_hat) + eps)``, betas 0.9 and 0.999, eps 1e-8)
updates the leaves. Rays are traced ``rows`` at a time.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from rtbench.reference import whitted as W

LEAVES = ("mat_diffuse", "light_color")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def fit_steps(scene: W.RefScene, cam: dict, target: torch.Tensor, lr: float,
              steps: int, rows: int = 1 << 18, half: bool = False
              ) -> Dict[str, object]:
    """Take ``steps`` Adam steps from the scene's own leaves against
    ``target`` [H * W, 3] (raster order). Returns ``losses`` (one per
    step, before its update), ``grad1`` (each leaf's first gradient) and
    ``change`` (each leaf after the steps less before) and ``grads`` (each
    step's gradients). ``half`` plants a
    fault for calibrating the check: the loss is the mean over every
    other pixel only."""
    xs, ys = W.pixel_grid(cam, scene.device)
    blocks = []
    for i in range(0, xs.shape[0], rows):
        o, d = W.camera_rays(cam, xs[i:i + rows], ys[i:i + rows], scene.dtype)
        with torch.no_grad():
            blocks.append((slice(i, i + o.shape[0]), d,
                           W.trace_segments(scene, o, d)))
    start = {k: v.detach().clone() for k, v in W.state_dict(scene).items()}
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    n = target.numel() // (2 if half else 1)
    losses: List[float] = []
    history = []
    for step in range(1, steps + 1):
        total = None
        for sl, d, segs in blocks:
            c = W.shade(scene, d, segs, d.shape[0], params["mat_diffuse"],
                        params["light_color"])
            sq = (c - target[sl].to(c.dtype)) ** 2
            if half:
                sq = sq[(torch.arange(sl.start, sl.stop, device=sq.device)
                         % 2) == 0]
            part = sq.sum()
            total = part if total is None else total + part
        loss = total / n
        grads = torch.autograd.grad(loss, [params[k] for k in LEAVES])
        losses.append(float(loss.detach()))
        g = dict(zip(LEAVES, grads))
        history.append({k: x.detach().clone() for k, x in g.items()})
        with torch.no_grad():
            for k in LEAVES:
                m[k] = BETA1 * m[k] + (1 - BETA1) * g[k]
                v2[k] = BETA2 * v2[k] + (1 - BETA2) * g[k] ** 2
                m_hat = m[k] / (1 - BETA1 ** step)
                v_hat = v2[k] / (1 - BETA2 ** step)
                params[k] -= lr * m_hat / (torch.sqrt(v_hat) + EPS)
    return dict(losses=losses, grad1=history[0], grads=history,
                change={k: params[k].detach() - start[k] for k in LEAVES})
