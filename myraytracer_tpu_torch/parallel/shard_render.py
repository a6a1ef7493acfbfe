"""Sharded rendering and the sharded training step (torch.distributed).

Counterpart of ``myraytracer_tpu/parallel/shard_render.py``. Every rank
of a ray mesh (parallel/mesh.py) holds the whole scene and traces its
contiguous share of the rays with the single-device functions of
ops/render.py; the forward does no communication until the image is
assembled. A training step sums the loss, every scene-parameter
gradient and the ray weights with one ``all_reduce`` and applies the
same SGD update on every rank.

Images are assembled by writing each rank's colours into a zero-filled
buffer of the whole batch and summing the buffers: the other ranks' rows
add zeros, which is exact, and ``all_reduce`` works on every backend
(gloo has no ``all_gather`` of CUDA tensors).

Scene parameters are a flat dict of tensors (:func:`split_params`,
:func:`merge_params`): the float tensor fields of a SceneData minus the
acceleration structure (``bvh_``/``cl_`` prefixes), whose bounds are
traversal topology and get no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, SceneData
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.mesh import mesh_rank

#: acceleration-structure arrays: not scene parameters
_ACCEL_PREFIXES = ("bvh_", "cl_")


def split_params(scene: SceneData) -> Dict[str, torch.Tensor]:
    """The differentiable (float) leaves of ``scene`` as a flat dict."""
    return {name: getattr(scene, name) for name in ARRAY_FIELDS
            if not name.startswith(_ACCEL_PREFIXES)
            and getattr(scene, name).is_floating_point()}


def merge_params(scene: SceneData, params: Dict[str, torch.Tensor]
                 ) -> SceneData:
    """``scene`` with its float leaves replaced by ``params``."""
    return dataclasses.replace(scene, **params)


def _pad_rays(o, d, n_shards: int):
    """Pad (o, d) [R, 3] to a multiple of ``n_shards`` rays by repeating
    the last ray; returns (o, d, R)."""
    R = o.shape[0]
    pad = -R % n_shards
    if pad:
        o = torch.cat([o, o[-1:].expand(pad, 3)])
        d = torch.cat([d, d[-1:].expand(pad, 3)])
    return o, d, R


def _shard(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n].contiguous()


def _gather_rows(part: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``part`` stacked in mesh order, on every rank."""
    rank, n = mesh_rank(mesh), part.shape[0]
    full = part.new_zeros((mesh.size() * n,) + tuple(part.shape[1:]))
    full[rank * n:(rank + 1) * n] = part
    dist.all_reduce(full, group=mesh.get_group())
    return full


def _trace_shard(scene, o, d, mesh, cfg: tr.TraceConfig,
                 tile: Optional[int], quantum: int) -> torch.Tensor:
    """Trace this rank's share of (o, d), already padded to the mesh, and
    assemble every rank's colours."""
    from myraytracer_tpu_torch.ops.render import _trace_tiled

    rank, size = mesh_rank(mesh), mesh.size()
    o_s, d_s = _shard(o, rank, size), _shard(d, rank, size)
    colors = _trace_tiled(scene, o_s, d_s, cfg,
                          o_s.shape[0] if tile is None else tile, quantum)
    return _gather_rows(colors, mesh)


def render_sharded(scene, camera, mesh,
                   cfg: tr.TraceConfig = tr.TraceConfig(),
                   tile: Optional[int] = None) -> torch.Tensor:
    """Forward render with the rays split over ``mesh`` -> [H, W, 3].

    The rays are laid out in BLOCK x BLOCK screen blocks and padded to a
    multiple of mesh size x BLOCK^2, so each rank traces whole blocks,
    under :func:`ops.render.render`'s tile rule (``tile`` rays, rounded
    down to whole blocks; None traces the rank's share in one batch). At
    mesh size 1 the image equals ``render``'s bit for bit. Every rank
    returns the whole image, clamped to <= 1.
    """
    from myraytracer_tpu_torch.ops.render import BLOCK, primary_rays_blocked

    H, W = camera.height, camera.width
    b = BLOCK
    Hp, Wp = -(-H // b) * b, -(-W // b) * b
    o, d = primary_rays_blocked(camera, scene.device, b)
    o, d, R = _pad_rays(o, d, mesh.size() * b * b)
    if tile is not None:
        tile = max(b * b, (tile // (b * b)) * (b * b))
    color = _trace_shard(scene, o, d, mesh, cfg, tile, b * b)[:R]
    img = (color.reshape(Hp // b, Wp // b, b, b, 3)
           .permute(0, 2, 1, 3, 4)
           .reshape(Hp, Wp, 3)[:H, :W])
    return torch.clamp(img, max=1.0)


def render_aa_sharded(scene, camera, mesh,
                      cfg: tr.TraceConfig = tr.TraceConfig(),
                      tile: Optional[int] = None,
                      subp: Optional[int] = None,
                      threshold: Optional[float] = None,
                      budget_frac: float = 0.10) -> torch.Tensor:
    """:func:`render_sharded` plus the adaptive-supersampling pass ->
    [H, W, 3].

    Every rank selects the pixels from the whole pass-1 image
    (``ops/render._aa_rays``); only the subpixel rays, padded to a
    multiple of mesh size x subp^2, are split over the mesh, and traced
    with the exact phase-1 as ``render_aa`` traces them. At mesh size 1
    the image equals ``render_aa``'s bit for bit.
    """
    from myraytracer_tpu_torch.ops import render as R

    subp = R.AA_SUBP if subp is None else subp
    threshold = R.AA_THRESHOLD if threshold is None else threshold
    img1 = render_sharded(scene, camera, mesh, cfg, tile)
    top_idx, sel, o, d = R._aa_rays(camera, img1, subp, threshold,
                                    budget_frac)
    o, d, Rr = _pad_rays(o, d, mesh.size() * subp * subp)
    colors = _trace_shard(scene, o, d, mesh, cfg._replace(phase1="exact"),
                          tile, 1)[:Rr]
    return R._aa_apply(camera, img1, top_idx, sel, colors, subp)


def loss_grad_sharded(scene, o, d, target, w, mesh,
                      cfg: tr.TraceConfig = tr.TraceConfig(),
                      tile: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                 torch.Tensor]:
    """The SSE loss ``sum(w (c - target)^2)`` and its gradients with
    respect to ``split_params(scene)``, summed over the mesh, and the
    number of colour channels it covers (3 * the summed ``w``).

    o, d, target [n, 3] and w [n] are this rank's share
    (distributed.shard_rays_global). Each rank runs the single-device
    step (``ops/render._loss_grad_tiled``: refit, topology, replay,
    backward; ``tile`` None runs its share as one tile); one
    ``all_reduce`` sums the loss, every gradient and ``sum(w)``.
    """
    from myraytracer_tpu_torch.ops.render import _loss_grad_tiled

    loss, grads = _loss_grad_tiled(scene, o, d, target, w, cfg,
                                   o.shape[0] if tile is None else tile)
    names = list(grads)
    flat = torch.cat([loss.reshape(1), w.sum().reshape(1).to(loss.dtype)]
                     + [grads[k].reshape(-1) for k in names])
    dist.all_reduce(flat, group=mesh.get_group())
    out, off = {}, 2
    for k in names:
        n = grads[k].numel()
        out[k] = flat[off:off + n].view_as(grads[k])
        off += n
    return flat[0], out, 3.0 * flat[1]


def make_train_step(mesh, cfg: tr.TraceConfig = tr.TraceConfig(),
                    lr: float = 1e-3, tile: Optional[int] = None):
    """A sharded inverse-rendering SGD step.

    Returns ``step(scene, o, d, target, w) -> (scene', loss)``: o, d,
    target and w are this rank's share of the rays, their target colours
    and weights (distributed.shard_rays_global); ``loss`` is the mean
    squared error over the weighted channels of every rank, and every
    rank applies the same update ``p - lr * g / n_total`` with
    ``n_total = 3 * sum(w)`` over the mesh. A scene whose mirrors are
    above 0 traces its full mirror chain (``ops/render.restore_mirror_chain``).
    """
    from myraytracer_tpu_torch.ops.render import restore_mirror_chain

    def step(scene, o, d, target, w):
        scene = restore_mirror_chain(scene)
        loss, grads, n_total = loss_grad_sharded(scene, o, d, target, w,
                                                 mesh, cfg, tile)
        params = split_params(scene)
        new = {k: p - lr * grads[k] / n_total for k, p in params.items()}
        return merge_params(scene, new), loss / n_total

    return step


def train_step_sharded(scene, o, d, target, mesh, lr: float = 1e-3,
                       cfg: tr.TraceConfig = tr.TraceConfig()):
    """One sharded step (:func:`make_train_step`) on a ray batch that
    every rank passes in full: o, d, target [R, 3]. The batch is padded
    to the mesh with copies of the last ray, weighted 0."""
    rank, size = mesh_rank(mesh), mesh.size()
    R0 = o.shape[0]
    o, d, _ = _pad_rays(o, d, size)
    pad = o.shape[0] - R0
    w = torch.cat([torch.ones(R0, dtype=o.dtype, device=o.device),
                   torch.zeros(pad, dtype=o.dtype, device=o.device)])
    target = torch.nn.functional.pad(target, (0, 0, 0, pad))
    return make_train_step(mesh, cfg, lr)(
        scene, *(_shard(x, rank, size) for x in (o, d, target, w)))
