"""Texture-atlas sampling (torch).

Counterpart of ``myraytracer_tpu/ops/texture.py``. Every mesh's texels
are concatenated into one flat [X, 3] atlas with a per-triangle
(width, height, offset) record. ``sample_nearest`` is the forward fetch:
clamp UV to [0, 1], flip v, ``px = round(u (W - 1))``,
``py = round((1 - v) (H - 1))``, with rounding half to even.

On the forward path K3 (``ops/cuda_shade.shade_pre``) computes the same
atlas index itself; ``sample_nearest`` waits for its caller, the
differentiable replay of textured scenes, which is not ported yet.
"""

from __future__ import annotations

import torch


def sample_nearest(texels, tex_rec, u, v):
    """Nearest-neighbour atlas fetch.

    texels [X, 3]; tex_rec [R, 3] int32 (W, H, offset) per ray, W = -1 for
    untextured rays (the caller selects the material diffuse there); u, v
    [R] interpolated UV. Returns [R, 3] texel colours.
    """
    w = torch.clamp(tex_rec[:, 0], min=1)
    h = torch.clamp(tex_rec[:, 1], min=1)
    off = torch.clamp(tex_rec[:, 2], min=0)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = torch.clamp(v, 0.0, 1.0)
    px = torch.round(uc * (w - 1).to(u.dtype)).to(torch.int32)
    py = torch.round((1.0 - vc) * (h - 1).to(v.dtype)).to(torch.int32)
    flat = torch.clamp(off + py * w + px, 0, texels.shape[0] - 1)
    return texels[flat.long()]
