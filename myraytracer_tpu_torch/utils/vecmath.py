"""Batched 3-vector math on ``[..., 3]`` float tensors.

Counterpart of ``myraytracer_tpu/utils/vecmath.py`` with the same guard
semantics, so both packages normalize near-zero vectors the same way.
"""

from __future__ import annotations

import torch

#: epsilon used to guard normalization of near-zero vectors.
EPS_NORMALIZE = 1e-20


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of ``[..., 3]`` tensors -> ``[...]``."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of ``[..., 3]`` tensors."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def norm(a: torch.Tensor) -> torch.Tensor:
    """Euclidean norm along the last axis."""
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe row-wise normalization (zero vectors stay zero-ish)."""
    n2 = torch.sum(a * a, dim=-1)
    inv = torch.where(n2 > EPS_NORMALIZE,
                      torch.reciprocal(torch.sqrt(torch.clamp(n2, min=EPS_NORMALIZE))),
                      torch.zeros_like(n2))
    return a * inv[..., None]
