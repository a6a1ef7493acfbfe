"""Per-ray triangle hit record and the packed corner table (torch).

Counterpart of the parts of ``myraytracer_tpu/ops/traverse.py`` that the
cluster scan uses; the threaded-BVH walk itself is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriHit(NamedTuple):
    """Per-ray closest triangle: index (-1 = miss) and distance."""

    idx: torch.Tensor   # [R] int32
    t: torch.Tensor     # [R] float32 (INF on miss)


def pack_tri_vertices(scene) -> torch.Tensor:
    """[T, 16] packed triangle corners (p0 p1 p2, padded 9 -> 16)."""
    vp = scene.vertex_pos
    tv = scene.tri_vidx.long()
    packed = torch.cat([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], dim=1)
    return torch.nn.functional.pad(packed, (0, 7))
