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


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect incident direction ``d`` about normal ``n``: ``d - 2 (d.n) n``
    (the mirror bounce)."""
    return d - 2.0 * dot(d, n)[..., None] * n


def mirror(l: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror a light vector about normal ``n``: ``2 (l.n) n - l`` (the
    specular term's reflected light direction)."""
    return 2.0 * dot(l, n)[..., None] * n - l


def det2(a, b, c, d):
    """2x2 determinant ``a d - b c``."""
    return a * d - b * c


def det3(c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor) -> torch.Tensor:
    """3x3 determinant from three column vectors ``[..., 3]``, by cofactor
    expansion along the first row (the Cramer solve's form)."""
    return (
        c1[..., 0] * det2(c2[..., 1], c3[..., 1], c2[..., 2], c3[..., 2])
        - c2[..., 0] * det2(c1[..., 1], c3[..., 1], c1[..., 2], c3[..., 2])
        + c3[..., 0] * det2(c1[..., 1], c2[..., 1], c1[..., 2], c2[..., 2])
    )
