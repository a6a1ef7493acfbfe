"""Texture-atlas sampling (torch).

Counterpart of ``myraytracer_tpu/ops/texture.py``. Every mesh's texels
are concatenated into one flat [X, 3] atlas with a per-triangle
(width, height, offset) record. ``sample_nearest`` is the forward fetch:
clamp UV to [0, 1], flip v, ``px = round(u (W - 1))``,
``py = round((1 - v) (H - 1))``, with rounding half to even.
``sample_bilinear`` is the differentiable relaxation: gradients flow into
the texels and into (u, v).

On the forward path K3 (``ops/cuda_shade.shade_pre``) computes the
nearest atlas index itself; both fetches here serve the training
replay (``shade.resolve_hit``, by ``TraceConfig.texture_filter``).
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


def sample_bilinear(texels, tex_rec, u, v):
    """Bilinearly filtered atlas fetch (differentiable in texels and UV).

    The arguments of :func:`sample_nearest`. The four neighbours of
    ``(u (W - 1), (1 - v) (H - 1))`` clamp at the texture's last row and
    column.
    """
    w = torch.clamp(tex_rec[:, 0], min=1)
    h = torch.clamp(tex_rec[:, 1], min=1)
    off = torch.clamp(tex_rec[:, 2], min=0)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = torch.clamp(v, 0.0, 1.0)
    fx = uc * (w - 1).to(u.dtype)
    fy = (1.0 - vc) * (h - 1).to(v.dtype)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    x1i = torch.minimum(x0i + 1, w - 1)
    y1i = torch.minimum(y0i + 1, h - 1)

    def fetch(xi, yi):
        flat = torch.clamp(off + yi * w + xi, 0, texels.shape[0] - 1)
        return texels[flat.long()]

    c00 = fetch(x0i, y0i)
    c10 = fetch(x1i, y0i)
    c01 = fetch(x0i, y1i)
    c11 = fetch(x1i, y1i)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty
