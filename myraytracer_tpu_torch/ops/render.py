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

On a CUDA device each entry point replays a CUDA graph
(ops/graphs.py, the counterpart of the reference's jit): ``render`` and
``render_aa``'s pass 1 are one graph, the AA refine another, and each
training step one graph of forward and backward. The camera reaches the
graph as a staged input, so a new camera of the same size replays the
same graph. ``graphs.disable_graphs()`` runs them eagerly; CPU tensors
always do.

Each entry point's call is a host span (``mrt.render``, ``mrt.render_aa``,
``mrt.aa_refine``; utils/profiling.span), :data:`CALLS` counts the calls
of ``render_aa``, and the device work inside its
graphs is split by phase marks (``rays``, ``aa.select``, ``aa.apply``,
the training step's ``refit``, ``topology``, ``replay`` and
``backward``, and the trace's own; utils/profiling.mark).

``render(clamp=False)`` is differentiable, as the reference's is: under
autograd its trace takes the replay route (``tracer.replays``), and on
the card the call replays two graphs, the counterparts of the
reference's jitted forward and its transpose: a forward graph (the
topology pass and the shading replay of every tile, with the autograd
residuals kept) and a backward graph, which writes the gradient of every
scene and camera tensor that requires grad from the image's cotangent
(``graphs.run(..., records_grad=True)``). The caller's loss and
optimizer run between them. The forward-only entry points
(``render(clamp=True)``, ``render_aa`` and the sharded forwards) trace
under ``torch.no_grad()`` with the nearest texel (:func:`forward_only`),
the counterpart of the reference's ``fused_shade=True``, so they keep
the K3/K4 chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.ops import graphs, shade
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops.refit import refit_accel
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)
from myraytracer_tpu_torch.utils.profiling import mark, span

#: screen-block edge of the primary ray order
BLOCK = 32

#: calls of ``render_aa`` so far: what the segment counters of its graphs
#: ``render`` and ``aa_refine`` (tracer.live_rays) are divided by per frame
CALLS = {"render_aa": 0}

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


def forward_only(cfg: tr.TraceConfig) -> tr.TraceConfig:
    """The config of the entry points that take no gradient: the nearest
    texel, the fetch of K3/K4 (the reference's ``fused_shade=True``)."""
    return cfg.validate()._replace(texture_filter="nearest")


def _trace_tiled(scene, o, d, cfg: tr.TraceConfig, tile: int,
                 quantum: int = 1) -> torch.Tensor:
    """Trace a flat [R, 3] ray batch in tiles of ``tile`` rays, sharing
    one ``pack_trace`` (its shade rows among it) across the tiles."""
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


def _graphed(name: str, fn, scene, camera: Camera, static=(), held=(),
             staged=(), group=None, records_grad: bool = False):
    """``fn(camera, *staged)`` through :func:`graphs.run`: the scene's
    tensors and ``held`` read in place, the camera (packed) and
    ``staged`` copied into the graph's buffers, keyed by the scene's
    static fields, the camera's size, ``static`` and the process
    ``group`` of a sharded entry point; a forward and a backward graph
    where ``records_grad`` (autograd records the call)."""
    W, H = camera.width, camera.height
    with span("graphs.key", name):
        scene_static, scene_held = graphs.scene_inputs(scene)
    with span("graphs.stage", name):
        cam = camera.packed()

    def body(cam, *rest):
        return fn(Camera.from_packed(cam, W, H), *rest)

    return graphs.run(name, body, scene.device,
                      static=(scene_static, W, H) + tuple(static),
                      held=scene_held + list(held),
                      staged=(cam,) + tuple(staged), group=group,
                      records_grad=records_grad)


def render(scene, camera: Camera, cfg: tr.TraceConfig = tr.TraceConfig(),
           tile: Optional[int] = None, clamp: bool = True) -> torch.Tensor:
    """Primary 1-spp render -> [H, W, 3] on the scene's device.

    Colors are clamped to <= 1 per pixel like the reference kernel unless
    ``clamp=False``, which returns the unclamped linear image. ``tile``
    (rays, rounded down to whole screen blocks) traces the frame in
    batches; None traces it in one. One CUDA graph on the card.

    ``clamp=True`` takes no gradient: it traces under ``torch.no_grad()``
    with :func:`forward_only`'s nearest texel. ``clamp=False`` is
    differentiable in every scene tensor and the camera: where autograd
    records the call (``tracer.records_grad``) each tile takes the replay
    route and the image carries the autograd graph. On the card that
    call replays a forward graph of every tile and, at the image's
    backward, a backward graph (``graphs.run``'s differentiable region:
    the scene's tensors read in place, the camera staged, which of them
    require grad part of the key). A forward of the key whose previous
    image still awaits its backward runs eagerly. Without autograd the
    call replays one graph.
    """
    with span("render"):
        if clamp:
            cfg = forward_only(cfg)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not clamp):
            return _graphed("render",
                            lambda cam: _render(scene, cam, cfg, tile, clamp),
                            scene, camera, static=(cfg, tile, clamp),
                            records_grad=tr.records_grad(
                                scene, camera.eye, camera.center, camera.up,
                                camera.fovy))


def _render(scene, camera: Camera, cfg: tr.TraceConfig, tile: Optional[int],
            clamp: bool) -> torch.Tensor:
    """The body of :func:`render`."""
    mark("rays", scene.device)
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


def sized_aa_budget(img1: torch.Tensor) -> Tuple[float, float]:
    """The :func:`render_aa` budget for the pass-1 image ``img1``, sized as
    the bench sizes it: the fraction of pixels above AA_THRESHOLD times
    1.1, rounded up to a multiple of 0.0025, at least 0.01. The deviation
    map is fixed for a scene and resolution, so the margin only covers
    rounding across runs. Returns (budget, the above-threshold fraction).
    """
    frac = float((_deviation(img1) > AA_THRESHOLD).float().mean())
    return max(0.01, math.ceil(frac * 1.1 / 0.0025) * 0.0025), frac


#: the AA pass's probe direction (+x), one constant per device: made on
#: the first (eager) call of a key, never inside a graph capture
_PROBE_DIR: Dict[torch.device, torch.Tensor] = {}


def _probe_dir(device: torch.device) -> torch.Tensor:
    d = _PROBE_DIR.get(device)
    if d is None:
        d = _PROBE_DIR[device] = torch.tensor([1.0, 0.0, 0.0], device=device)
    return d


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
    d = torch.where(sel_ray, d, _probe_dir(d.device).expand_as(d))
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
    """The adaptive-supersampling pass over a finished pass-1 image: one
    CUDA graph on the card, with ``img1`` staged (copied into the graph's
    buffer) like the camera. No gradient, the nearest texel."""
    with span("aa_refine"), torch.no_grad():
        cfg = forward_only(cfg)
        return _graphed(
            "aa_refine",
            lambda cam, img: _aa_refine_body(scene, cam, img, cfg, tile,
                                             subp, threshold, budget_frac),
            scene, camera, static=(cfg, tile, subp, threshold, budget_frac),
            staged=(img1,))


def _aa_refine_body(scene, camera: Camera, img1, cfg: tr.TraceConfig,
                    tile: Optional[int], subp: int, threshold: float,
                    budget_frac: float) -> torch.Tensor:
    """The body of :func:`_aa_refine`."""
    mark("aa.select", img1.device)
    top_idx, sel, o, d = _aa_rays(camera, img1, subp, threshold, budget_frac)
    # the subray batch is screen-scattered: its any-hit queries take the
    # exact phase-1 (K2), where the segment hulls would be loose
    colors = _trace_tiled(scene, o, d, cfg._replace(phase1="exact"),
                          o.shape[0] if tile is None else tile)
    mark("aa.apply", img1.device)
    return _aa_apply(camera, img1, top_idx, sel, colors, subp)


def render_aa(scene, camera: Camera, cfg: tr.TraceConfig = tr.TraceConfig(),
              tile: Optional[int] = None, subp: int = AA_SUBP,
              threshold: float = AA_THRESHOLD, budget_frac: float = 0.10
              ) -> torch.Tensor:
    """Render + adaptive supersampling -> [H, W, 3] in [0, 1].

    ``budget_frac`` bounds the supersampled pixels as a fraction of the
    image; above-threshold pixels beyond the budget (smallest deviations
    first) keep their pass-1 colour. ``tile`` (rays) bounds each pass's
    trace batch; None traces each pass in one. Two CUDA graphs on the
    card, as the reference's two jits: pass 1 (:func:`render`'s) and the
    refine. No gradient, the nearest texel (:func:`forward_only`).
    """
    CALLS["render_aa"] += 1
    with span("render_aa"):
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
    Padded rays (o 0, d 1, target 0) carry w 0. The replay of a tile
    keeps no residual (``trace_shade(..., checkpoint=True)``): its
    autograd replay recomputes each segment in the backward, and the
    fused K5/K6 and K10/K11 segments (:meth:`tr.TraceConfig.replay_route`)
    keep only their inputs. The four stages are device
    phases (``refit``, ``topology``, ``replay``, ``backward``; the
    trace's phases subdivide them) that tools/torch_profile.py reports.
    """
    dev = o.device
    mark("refit", dev)
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
    mark("topology", dev)
    pack = tr.pack_trace(scene, cfg)
    topo = [tr.trace_topology(scene, ot, dt, cfg, pack)
            for ot, dt in zip(o_t, d_t)]

    params = {k: v.detach().requires_grad_(True)
              for k, v in split_params(scene).items()}
    merged = merge_params(scene, params)

    total = None
    mark("replay", dev)
    geom = shade.pack_shade_geom(merged, cfg.plain)
    for ot, dt, tt, wt, tp in zip(o_t, d_t, t_t, w_t, topo):
        c = tr.trace_shade(merged, ot, dt, tp, cfg, geom, checkpoint=True)
        part = torch.sum(wt[:, None] * (c - tt) ** 2)
        total = part if total is None else total + part
    names = list(params)
    mark("backward", dev)
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
    :func:`render_loss_grad_image` (block-coherent tiles). One CUDA
    graph of forward and backward on the card, with o, d and target read
    in place; ``restore_mirror_chain`` runs before it, and its
    ``live_depth`` is part of the graph's key (the reference's
    ``_MirrorAwareJit``).
    """
    scene = restore_mirror_chain(scene)
    tile = o.shape[0] if tile is None else tile

    def body():
        w = torch.ones(o.shape[0], dtype=o.dtype, device=o.device)
        return _loss_grad_tiled(scene, o, d, target, w, cfg, tile)

    static, held = graphs.scene_inputs(scene)
    return graphs.run("render_loss_grad", body, scene.device,
                      static=(static, cfg, tile), held=held + [o, d, target])


def render_loss_grad_image(scene, camera: Camera, target: torch.Tensor,
                           cfg: tr.TraceConfig = tr.TraceConfig(),
                           tile: Optional[int] = None):
    """Whole-image SSE loss + scene-parameter grads: the training step.

    ``target`` [H, W, 3] on the scene's device. Rays and target pixels
    run in screen-block order; padded pixels carry weight 0. ``tile``
    (rays, rounded down to whole screen blocks) cuts the frame into
    replay tiles; None runs it as one. Returns (loss, grads), grads keyed
    like :func:`split_params`; a parameter the loss does not reach gets
    zeros. One CUDA graph of forward and backward on the card, with the
    target read in place and the camera staged; ``restore_mirror_chain``
    runs before it, and its ``live_depth`` is part of the graph's key
    (the reference's ``_MirrorAwareJit``).
    """
    scene = restore_mirror_chain(scene)
    return _graphed(
        "render_loss_grad_image",
        lambda cam: _loss_grad_image(scene, cam, target, cfg, tile),
        scene, camera, static=(cfg, tile), held=(target,))


def _loss_grad_image(scene, camera: Camera, target: torch.Tensor,
                     cfg: tr.TraceConfig, tile: Optional[int]):
    """The body of :func:`render_loss_grad_image`."""
    mark("rays", scene.device)
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
