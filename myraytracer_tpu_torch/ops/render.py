"""Render driver: one primary ray per pixel in screen-block order (torch).

Counterpart of ``myraytracer_tpu/ops/render.render``. Pixels are padded
to whole BLOCK x BLOCK screen blocks and the rays of one block are
contiguous, so every compaction subgroup of the cluster scan is a compact
screen footprint. The frame is traced in one batch by default; ``tile``
cuts it into batches of whole screen blocks to bound memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.ops import tracer as tr

#: screen-block edge of the primary ray order
BLOCK = 32


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
    pack = tr.pack_trace(scene)
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


def primary_rays_blocked(camera: Camera, device, block: int = BLOCK):
    """Primary rays of the padded frame in block order -> (o, d) [R, 3]."""
    H, W = camera.height, camera.width
    Hp = -(-H // block) * block
    Wp = -(-W // block) * block
    ys, xs = torch.meshgrid(
        torch.arange(Hp, dtype=torch.float32, device=device),
        torch.arange(Wp, dtype=torch.float32, device=device), indexing="ij")

    def to_blocks(a):
        return (a.reshape(Hp // block, block, Wp // block, block)
                .permute(0, 2, 1, 3).reshape(-1))

    o, d = camera.primary_rays(to_blocks(xs), to_blocks(ys))
    return o.contiguous(), d.contiguous()


def render(scene, camera: Camera, tile: Optional[int] = None,
           cfg: tr.TraceConfig = tr.TraceConfig()) -> torch.Tensor:
    """Primary 1-spp render -> [H, W, 3] on the scene's device.

    Colors are clamped to <= 1 per pixel like the reference kernel.
    ``tile`` (rays, rounded down to whole screen blocks) traces the frame
    in batches; None traces it in one.
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
    return torch.clamp(img, max=1.0)
