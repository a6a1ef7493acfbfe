"""Runtime guards on radiance and images.

Counterpart of ``myraytracer_tpu/utils/checks.py``. NaN or Inf can pass
silently through masked lanes and come out as black pixels;
:func:`checked_trace` traces and raises instead. The reference checks
inside its traced program (``checkify``); here the checks are explicit
reductions after the trace, with the reference's messages. For tests and
debugging: the render and training entry points stay guard-free.
"""

from __future__ import annotations

import numpy as np
import torch

from myraytracer_tpu_torch.ops import tracer as tr


def checked_trace(scene, o: torch.Tensor, d: torch.Tensor,
                  cfg: tr.TraceConfig = tr.TraceConfig()) -> torch.Tensor:
    """:func:`tracer.trace` that raises ValueError on non-finite radiance
    or radiance below -1e-4; returns the [R, 3] colours."""
    color = tr.trace(scene, o, d, cfg)
    if not bool(torch.isfinite(color).all()):
        raise ValueError("non-finite radiance in trace output")
    if not bool((color > -1e-4).all()):
        raise ValueError("negative radiance in trace output")
    return color


def assert_valid_image(img) -> None:
    """Raise ValueError unless ``img`` (a tensor on any device, or an
    array) is a finite [H, W, 3] image within [0, 1]."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] image, got {arr.shape}")
    if not np.isfinite(arr).all():
        raise ValueError("image contains non-finite values")
    if arr.min() < -1e-6 or arr.max() > 1.0 + 1e-6:
        raise ValueError(f"image outside [0, 1]: [{arr.min()}, {arr.max()}]")
