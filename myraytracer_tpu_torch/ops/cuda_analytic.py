"""The dense analytic tests over the K8 CUDA kernel (csrc/analytic.cu).

Closest hit and any hit of a ray batch against a scene's spheres, planes
and cylinders, read from their ``ShadeGeom.ana16`` rows (spheres, then
planes, then cylinders). The plain versions are the bodies of
ops/tracer.py's ``_closest_analytic_plain`` and
``_analytic_occlusion_plain``, which the tracer runs for CPU tensors and
``TraceConfig.plain``; these wrappers take CUDA tensors and raise for any
other. K8 computes every t in the plain versions' fp32 expressions and
order, so its outputs equal theirs to the bit.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.kernels import _build


def _check(name: str, o, d, ana16, counts, **more) -> None:
    """Raise ValueError for inputs K8 does not take."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: K8 takes CUDA tensors, got {dev}")
    ws = o.shape[1] if o.dim() == 2 else 0
    _build.check_inputs(name, dev, widths=dict(o_f=ws, d_f=ws, ana16_f=16),
                        o_f=o, d_f=d, ana16_f=ana16, **more)
    R = o.shape[0]
    if ws not in (3, 4) or d.shape != o.shape or any(
            t.shape != (R,) for t in more.values()):
        raise ValueError(
            f"{name}: rays must be [R, 3] or [R, 4] and every other input "
            f"[R], got o {tuple(o.shape)}, d {tuple(d.shape)}, "
            + ", ".join(f"{k[:-2]} {tuple(t.shape)}" for k, t in more.items()))
    if min(counts) < 0 or ana16.shape[0] < sum(counts):
        raise ValueError(f"{name}: ana16 has {ana16.shape[0]} rows for "
                         f"{counts} spheres, planes and cylinders")


def closest_analytic(o, d, ana16, counts):
    """Closest sphere, plane or cylinder hit of each ray (K8).

    o, d [R, 3] or [R, 4] f32 (xyz first); ana16 [A, 16] f32 whose first
    rows are ``counts`` = (spheres, planes, cylinders). Returns (kind [R]
    i32, idx [R] i32 the index within the kind, aidx [R] i32 the ana16
    row, t [R] f32): KIND_MISS, 0, 0 and INF where no primitive is hit.
    """
    _check("closest_analytic", o, d, ana16, counts)
    R, dev = o.shape[0], o.device
    kind = torch.empty(R, dtype=torch.int32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    aidx = torch.empty(R, dtype=torch.int32, device=dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    _build.launch("mrt_analytic", "analytic_closest", dev, o.data_ptr(),
                  d.data_ptr(), None, None, ana16.data_ptr(), kind.data_ptr(),
                  idx.data_ptr(), aidx.data_ptr(), t.data_ptr(), None, R,
                  o.shape[1], *counts, 0)
    return kind, idx, aidx, t


def analytic_anyhit(o, d, dist, cast, ana16, counts):
    """Is o -> o + dist d occluded by a sphere, plane or cylinder? (K8)

    o, d as :func:`closest_analytic`; dist [R] f32; cast [R] bool, or
    None for every ray. Returns occ [R] bool: False where cast is False,
    else whether some primitive's t (INF on a miss) is below dist.
    """
    more = dict(dist_f=dist) if cast is None else dict(dist_f=dist,
                                                       cast_b=cast)
    _check("analytic_anyhit", o, d, ana16, counts, **more)
    R = o.shape[0]
    occ = torch.empty(R, dtype=torch.bool, device=o.device)
    _build.launch("mrt_analytic", "analytic_anyhit", o.device, o.data_ptr(),
                  d.data_ptr(), dist.data_ptr(),
                  None if cast is None else cast.data_ptr(), ana16.data_ptr(),
                  None, None, None, None, occ.data_ptr(), R, o.shape[1],
                  *counts, 1)
    return occ
