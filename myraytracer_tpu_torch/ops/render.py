"""Render and training entry points in screen-block order (torch).

Counterpart of ``render``, ``render_aa`` and ``render_loss_grad(_image)``
in ``myraytracer_tpu/ops/render.py``. Pixels are padded to whole BLOCK x
BLOCK screen blocks and the rays of one block are contiguous, so every
compaction subgroup of the cluster scan is a compact screen footprint.
The frame is traced in one batch by default; ``tile`` cuts it into
batches of whole screen blocks to bound memory.

:func:`render_aa` adds the adaptive supersampling pass: the pixels whose
4-neighbourhood colour deviation exceeds AA_THRESHOLD, at most a budget
of them (the largest deviations first), are traced again with an
AA_SUBP x AA_SUBP stratified grid of subpixel rays and averaged. The
result equals the unbounded rule whenever the budget covers every pixel
above the threshold (:func:`aa_budget_covered`).

The training step (:func:`render_loss_grad_image`) returns the SSE loss
against a target image and its gradient with respect to every float
scene parameter: refit, a gradient-free topology pass over every tile,
then the differentiable shading replay of each tile, summed, and one
backward over the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops.refit import refit_accel
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

#: screen-block edge of the primary ray order
BLOCK = 32

#: adaptive supersampling: subpixel grid edge and deviation threshold
AA_SUBP = 4
AA_THRESHOLD = 0.02


def _fit_tile(R: int, tile: int, quantum: int) -> int:
    """Nudge ``tile`` to a nearby size that divides R exactly.

    Searches downward in whole quanta (screen blocks) and accepts the
    first exact divisor within 75% of the request; otherwise keeps the
    requested size (the last tile is then padded).
    """
    want = max(1, tile // quantum)
    nq = R // quantum
    if nq == 0 or R % quantum:
        return tile
    for k in range(min(want, nq), 0, -1):
        if nq % k == 0:
            return k * quantum if 4 * k >= 3 * want else tile
    return tile


def _trace_tiled(scene, o, d, cfg: tr.TraceConfig, tile: int,
                 quantum: int = 1) -> torch.Tensor:
    """Trace a flat [R, 3] ray batch in tiles of ``tile`` rays."""
    R = o.shape[0]
    pack = tr.pack_trace(scene, cfg)
    if R <= tile:
        return tr.trace(scene, o, d, cfg, pack)
    tile = _fit_tile(R, tile, quantum)
    colors = []
    for start in range(0, R, tile):
        o_t, d_t = o[start:start + tile], d[start:start + tile]
        n = o_t.shape[0]
        if n < tile:
            # the padded tail traces from the origin along the last real
            # direction
            o_t = torch.cat([o_t, o_t.new_zeros((tile - n, 3))])
            d_t = torch.cat([d_t, d_t[-1:].expand(tile - n, 3)])
        colors.append(tr.trace(scene, o_t.contiguous(), d_t.contiguous(),
                               cfg, pack)[:n])
    return torch.cat(colors)


def _to_blocks(a: torch.Tensor, block: int) -> torch.Tensor:
    """[Hp, Wp, ...] -> [Hp * Wp, ...] in screen-block order."""
    Hp, Wp = a.shape[:2]
    lead = tuple(a.shape[2:])
    return (a.reshape((Hp // block, block, Wp // block, block) + lead)
            .permute((0, 2, 1, 3) + tuple(range(4, 4 + len(lead))))
            .reshape((-1,) + lead))


def primary_rays_blocked(camera: Camera, device, block: int = BLOCK):
    """Primary rays of the padded frame in block order -> (o, d) [R, 3]."""
    H, W = camera.height, camera.width
    Hp = -(-H // block) * block
    Wp = -(-W // block) * block
    ys, xs = torch.meshgrid(
        torch.arange(Hp, dtype=torch.float32, device=device),
        torch.arange(Wp, dtype=torch.float32, device=device), indexing="ij")
    o, d = camera.primary_rays(_to_blocks(xs, block), _to_blocks(ys, block))
    return o.contiguous(), d.contiguous()


def render(scene, camera: Camera, cfg: tr.TraceConfig = tr.TraceConfig(),
           tile: Optional[int] = None, clamp: bool = True) -> torch.Tensor:
    """Primary 1-spp render -> [H, W, 3] on the scene's device.

    Colors are clamped to <= 1 per pixel like the reference kernel unless
    ``clamp=False``, which returns the unclamped linear image. ``tile``
    (rays, rounded down to whole screen blocks) traces the frame in
    batches; None traces it in one.
    """
    H, W = camera.height, camera.width
    b = BLOCK
    Hp = -(-H // b) * b
    Wp = -(-W // b) * b
    o, d = primary_rays_blocked(camera, scene.device, b)
    R = o.shape[0]
    tile_eff = R if tile is None else max(b * b, (tile // (b * b)) * (b * b))
    color = _trace_tiled(scene, o, d, cfg, tile_eff, quantum=b * b)
    img = (color.reshape(Hp // b, Wp // b, b, b, 3)
           .permute(0, 2, 1, 3, 4)
           .reshape(Hp, Wp, 3)[:H, :W])
    return torch.clamp(img, max=1.0) if clamp else img


def _deviation(img: torch.Tensor) -> torch.Tensor:
    """[H, W] sum of squared colour distances to the 4-neighbourhood; the
    1-pixel border never supersamples (0 there)."""
    c = img
    dev = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    dev[:, :-1] += torch.sum((c[:, :-1] - c[:, 1:]) ** 2, dim=-1)
    dev[:, 1:] += torch.sum((c[:, 1:] - c[:, :-1]) ** 2, dim=-1)
    dev[:-1, :] += torch.sum((c[:-1] - c[1:]) ** 2, dim=-1)
    dev[1:, :] += torch.sum((c[1:] - c[:-1]) ** 2, dim=-1)
    dev[0, :] = 0.0
    dev[-1, :] = 0.0
    dev[:, 0] = 0.0
    dev[:, -1] = 0.0
    return dev


def aa_budget_covered(img1: torch.Tensor, budget_frac: float,
                      threshold: float = AA_THRESHOLD) -> bool:
    """Does the budget of :func:`render_aa` cover every pixel of the
    pass-1 image ``img1`` whose deviation exceeds ``threshold``?"""
    H, W = img1.shape[:2]
    K = min(max(1, int(H * W * budget_frac)), H * W)
    return int((_deviation(img1) > threshold).sum()) <= K


def _aa_rays(camera: Camera, img1, subp: int, threshold: float,
             budget_frac: float):
    """The AA pass's pixel selection and subpixel rays.

    Returns (top_idx [K], sel [K], o, d [K * subp^2, 3]) with the K
    largest deviations re-sorted into screen-block order; sel marks those
    above the threshold. The rays of the other slots are guaranteed-miss
    probes (origin 3e18, direction +x) whose colour is never used.
    """
    H, W = camera.height, camera.width
    dev = _deviation(img1).reshape(-1)
    K = min(max(1, int(H * W * budget_frac)), H * W)
    top_dev, top_idx = torch.topk(dev, K)
    sel = top_dev > threshold
    # re-sort the selection into screen-block order (a unique key), so
    # the subray batch is spatially coherent for the cluster scan
    pxi, pyi = top_idx % W, top_idx // W
    bkey = (pyi // BLOCK) * (-(-W // BLOCK)) + pxi // BLOCK
    bkey = bkey * (BLOCK * BLOCK) + (pyi % BLOCK) * BLOCK + (pxi % BLOCK)
    ordk = torch.argsort(bkey)
    top_idx, sel = top_idx[ordk], sel[ordk]

    px = (top_idx % W).to(torch.float32)
    py = (top_idx // W).to(torch.float32)
    # stratified subp x subp offsets at cell centres
    steps = (torch.arange(subp, dtype=torch.float32, device=img1.device)
             / subp) - 0.5 + 1.0 / (2.0 * subp)
    ox, oy = torch.meshgrid(steps, steps, indexing="ij")
    xs = (px[:, None] + ox.reshape(-1)[None, :]).reshape(-1)
    ys = (py[:, None] + oy.reshape(-1)[None, :]).reshape(-1)
    o, d = camera.primary_rays(xs, ys)
    sel_ray = sel.repeat_interleave(subp * subp)[:, None]
    o = torch.where(sel_ray, o, torch.full_like(o, 3e18))
    d = torch.where(sel_ray, d, d.new_tensor([1.0, 0.0, 0.0]).expand_as(d))
    return top_idx, sel, o.contiguous(), d.contiguous()


def _aa_apply(camera: Camera, img1, top_idx, sel, colors, subp: int):
    """Average each selected pixel's subpixel colours into the image."""
    H, W = camera.height, camera.width
    K = top_idx.shape[0]
    avg = torch.clamp(colors.reshape(K, subp * subp, 3).mean(dim=1), max=1.0)
    flat = img1.reshape(-1, 3).clone()
    flat[top_idx] = torch.where(sel[:, None], avg, flat[top_idx])
    return flat.reshape(H, W, 3)


def _aa_refine(scene, camera: Camera, img1,
               cfg: tr.TraceConfig = tr.TraceConfig(),
               tile: Optional[int] = None, subp: int = AA_SUBP,
               threshold: float = AA_THRESHOLD, budget_frac: float = 0.10
               ) -> torch.Tensor:
    """The adaptive-supersampling pass over a finished pass-1 image."""
    top_idx, sel, o, d = _aa_rays(camera, img1, subp, threshold, budget_frac)
    # the subray batch is screen-scattered: its any-hit queries take the
    # exact phase-1 (K2), where the segment hulls would be loose
    colors = _trace_tiled(scene, o, d, cfg._replace(phase1="exact"),
                          o.shape[0] if tile is None else tile)
    return _aa_apply(camera, img1, top_idx, sel, colors, subp)


def render_aa(scene, camera: Camera, cfg: tr.TraceConfig = tr.TraceConfig(),
              tile: Optional[int] = None, subp: int = AA_SUBP,
              threshold: float = AA_THRESHOLD, budget_frac: float = 0.10
              ) -> torch.Tensor:
    """Render + adaptive supersampling -> [H, W, 3] in [0, 1].

    ``budget_frac`` bounds the supersampled pixels as a fraction of the
    image; above-threshold pixels beyond the budget (smallest deviations
    first) keep their pass-1 colour. ``tile`` (rays) bounds each pass's
    trace batch; None traces each pass in one.
    """
    img1 = render(scene, camera, cfg, tile)
    return _aa_refine(scene, camera, img1, cfg, tile, subp, threshold,
                      budget_frac)


def restore_mirror_chain(scene):
    """Un-trim ``live_depth`` when the scene's current mirrors need it.

    ``Scene.build`` trims mirror-free scenes to one Whitted segment. If a
    caller then moves ``mat_mirror`` above 0, the trimmed trace would drop
    the reflected radiance and its gradient: any mirror > 0 restores the
    full chain (max_depth + 1 segments). All mirrors 0 leave the scene as
    it is, which loses nothing: every weight is 0 after segment 0.
    """
    if not (scene.live_depth and scene.live_depth <= scene.max_depth):
        return scene
    if float(scene.mat_mirror.max()) > 0.0:
        return dataclasses.replace(scene, live_depth=scene.max_depth + 1)
    return scene


def _loss_grad_tiled(scene, o, d, target, w, cfg: tr.TraceConfig,
                     tile: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSE loss ``sum(w (c - target)^2)`` of a flat ray batch and its
    gradient with respect to ``split_params(scene)``.

    Refit, then the topology of every tile (no gradients), then the
    replay of every tile against one pack of the parameters, summed, and
    one backward, so the pack's gather backward runs once per pass.
    Padded rays (o 0, d 1, target 0) carry w 0. The replay of a tile runs
    under ``torch.utils.checkpoint`` unless it takes the fused K5/K6
    segment (:meth:`tr.TraceConfig.fused_grad`, the reference's rule),
    whose residuals are its inputs. The four phases are
    profiler ranges (``mrt.refit``, ``mrt.topology``, ``mrt.replay``,
    ``mrt.backward``) that tools/torch_profile.py reports.
    """
    rf = torch.profiler.record_function
    with rf("mrt.refit"):
        scene = refit_accel(scene)
    R = o.shape[0]
    tile = _fit_tile(R, min(tile, R), 1024)
    n_tiles = max(1, -(-R // tile))
    pad = n_tiles * tile - R
    F = torch.nn.functional
    o_p = F.pad(o, (0, 0, 0, pad))
    d_p = F.pad(d, (0, 0, 0, pad), value=1.0)
    t_p = F.pad(target, (0, 0, 0, pad))
    w_p = F.pad(w, (0, pad))

    def tiles(a):
        return [a[i * tile:(i + 1) * tile].contiguous()
                for i in range(n_tiles)]

    o_t, d_t, t_t, w_t = tiles(o_p), tiles(d_p), tiles(t_p), tiles(w_p)
    with rf("mrt.topology"):
        pack = tr.pack_trace(scene, cfg)
        topo = [tr.trace_topology(scene, ot, dt, cfg, pack)
                for ot, dt in zip(o_t, d_t)]

    params = {k: v.detach().requires_grad_(True)
              for k, v in split_params(scene).items()}
    merged = merge_params(scene, params)

    def tile_loss(geom, ot, dt, tt, wt, tp):
        c = tr.trace_shade(merged, ot, dt, tp, cfg, geom)
        return torch.sum(wt[:, None] * (c - tt) ** 2)

    total = None
    fused = cfg.fused_grad(scene)
    with rf("mrt.replay"):
        geom = shade.pack_shade_geom(merged)
        for ot, dt, tt, wt, tp in zip(o_t, d_t, t_t, w_t, topo):
            args = (geom, ot, dt, tt, wt, tp)
            if fused:
                part = tile_loss(*args)
            else:
                part = torch.utils.checkpoint.checkpoint(
                    tile_loss, *args, use_reentrant=False)
            total = part if total is None else total + part
    names = list(params)
    with rf("mrt.backward"):
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
    return total.detach(), {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads)}


def render_loss_grad(scene, o: torch.Tensor, d: torch.Tensor,
                     target: torch.Tensor,
                     cfg: tr.TraceConfig = tr.TraceConfig(),
                     tile: Optional[int] = None):
    """SSE loss + scene-parameter grads for a flat ray batch.

    o, d, target [R, 3]. Returns (loss, grads), grads keyed like
    :func:`split_params`. ``tile`` (rays) bounds the replay's memory; None
    runs the batch as one tile. For whole images prefer
    :func:`render_loss_grad_image` (block-coherent tiles).
    """
    scene = restore_mirror_chain(scene)
    w = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)
    return _loss_grad_tiled(scene, o, d, target, w, cfg,
                            o.shape[0] if tile is None else tile)


def render_loss_grad_image(scene, camera: Camera, target: torch.Tensor,
                           cfg: tr.TraceConfig = tr.TraceConfig(),
                           tile: Optional[int] = None):
    """Whole-image SSE loss + scene-parameter grads: the training step.

    ``target`` [H, W, 3] on the scene's device. Rays and target pixels
    run in screen-block order; padded pixels carry weight 0. ``tile``
    (rays, rounded down to whole screen blocks) cuts the frame into
    replay tiles; None runs it as one. Returns (loss, grads), grads keyed
    like :func:`split_params`; a parameter the loss does not reach gets
    zeros.
    """
    scene = restore_mirror_chain(scene)
    H, W = camera.height, camera.width
    b = BLOCK
    Hp = -(-H // b) * b
    Wp = -(-W // b) * b
    o, d = primary_rays_blocked(camera, scene.device, b)
    F = torch.nn.functional
    tgt = F.pad(target.to(o.dtype), (0, 0, 0, Wp - W, 0, Hp - H))
    w = F.pad(torch.ones((H, W), dtype=o.dtype, device=o.device),
              (0, Wp - W, 0, Hp - H))
    R = o.shape[0]
    tile_eff = R if tile is None else max(b * b, (tile // (b * b)) * (b * b))
    return _loss_grad_tiled(scene, o, d, _to_blocks(tgt, b),
                            _to_blocks(w, b), cfg, tile_eff)
