"""The comparisons that decide ``correct``: the numbers, each against its
limit from the cell's file (``rtbench/workloads/<cell>.json``).

Frames: ``bad_px`` is the share of the image's pixels whose colour
differs from the reference's by more than 1/255 in some channel;
``mean_abs`` the mean absolute difference over pixels and channels.
Both leave out the pixels that the reference marks as decided by a tie
(``whitted.render_aa(..., ties=True)``): two materials at one distance.

Fit: ``loss_gap`` is the largest relative gap between the program's and
the reference's loss over the first steps; ``grad_gap`` and
``change_gap`` the gap between the two norms of a leaf's first gradient,
and of its change over those steps, over the larger of the reference's
norm of that leaf and of the median leaf, the worst leaf's.

The change leaves out the entries whose reference gradient falls, at any
of the steps, under ``STILL`` of the median leaf's first gradient norm:
Adam moves each entry by about ``lr`` whatever its gradient's size, so
such an entry moves by the sign of a gradient that is nought to
rounding, and its move says nothing of the program.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

#: a pixel whose channels all lie within this of the reference's is equal
PIXEL_TOL = 1.0 / 255.0

#: an entry of a leaf whose reference gradient is under this share of the
#: median leaf's first gradient norm at some step is left out of the change
STILL = 1e-3

Check = Tuple[str, float, float]


def image_numbers(img: torch.Tensor, ref: torch.Tensor,
                  unsure: torch.Tensor) -> Dict[str, float]:
    """``bad_px`` and ``mean_abs`` of an [H, W, 3] image against the
    reference's, over the pixels that ``unsure`` [H, W] does not mark."""
    diff = (img.float() - ref.float()).abs()
    sure = ~unsure.to(diff.device)
    n = max(int(sure.sum()), 1)
    return {"bad_px": float(((diff.amax(-1) > PIXEL_TOL) & sure).sum()) / n,
            "mean_abs": float((diff * sure[..., None]).sum()) / (3 * n)}


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> float:
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    floor = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], floor, 1e-30) for k in ref)


def fit_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's first
    steps (``losses``, ``grad1``, ``change``) against the reference's
    (with ``grads``, its gradient at each step)."""
    lp, lr = prog["losses"], ref["losses"]
    floor = STILL * statistics.median(
        float(torch.linalg.vector_norm(g.double())) for g in
        ref["grad1"].values())
    moved = {k: torch.stack([g[k].abs() for g in ref["grads"]]).amin(0)
             >= floor for k in ref["change"]}
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": _leaf_gap(
                {k: v.to(moved[k].device) * moved[k]
                 for k, v in prog["change"].items()},
                {k: v * moved[k] for k, v in ref["change"].items()})}


def checks(numbers: Dict[str, float], limits: Dict[str, float],
           prefix: str = "") -> List[Check]:
    """(name, number, limit) for every limited number."""
    return [(prefix + k, numbers[k], float(limits[k])) for k in limits]


def all_within(items: Sequence[Check]) -> bool:
    return bool(items) and all(v == v and v <= lim for _, v, lim in items)
