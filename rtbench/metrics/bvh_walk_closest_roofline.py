"""``bvh_walk_closest_roofline``: percent of K7's roofline in each traced
frame's pass-1 closest-hit walk.

Kernels read: ``bvh_walk_kernel<false>`` (``csrc/bvh_walk.cu``, launched
by ``ops/traverse.py``), which a frame of ``render_aa`` on a mirror-free
scene launches twice: for the pass-1 primary rays, then for the AA
subrays. The first of each frame's pair is read.

The bound is the work those primary rays need over the BVH the program
built: the plain walk's counts (rtbench/roofline.py ``walk_work``) on a
seeded sample of one in ``SAMPLE`` of the frame's padded 32 x 32-block
grid of primary rays, its node steps and slot solves scaled to the whole
grid, its distinct rows as the sample read them (fewer than the whole
grid reads, so the bound is low rather than high), at the published
peaks (``walk_bound_ms``). The share is the frames' bounds summed over
the launches' device time summed, in percent. Nothing where the trace
holds no such launches, or not two a frame.
"""

import torch

from rtbench import roofline
from rtbench.reference import whitted as W

KERNELS = ("bvh_walk_kernel<false>",)
SAMPLE = 32
BLOCK = 32


def read(run, state, trace, spans):
    launches = [(a, b) for n, a, b in trace.device
                if any(k in n for k in KERNELS)]
    poses = state.get("traced_poses") or []
    if not poses or len(launches) != 2 * len(poses):
        return None
    pass1_ms = sum(b - a for a, b in launches[0::2]) * 1e-3
    data = run.scene
    cam = poses[0]
    Hp = -(-cam["height"] // BLOCK) * BLOCK
    Wp = -(-cam["width"] // BLOCK) * BLOCK
    R = Hp * Wp
    g = torch.Generator(device=run.device).manual_seed(run.seed)
    pick = torch.randperm(R, generator=g, device=run.device)[:max(1, R // SAMPLE)]
    xs, ys = (pick % Wp).float(), (pick // Wp).float()
    tv = data.tri_vidx.long()
    vp = data.vertex_pos.detach()
    corners = torch.cat([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], 1)
    bound = {}
    for p in poses:
        key = (p["eye"], p["center"])
        if key in bound:
            continue
        o, d = W.camera_rays(p, xs, ys)
        work = roofline.walk_work(data.bvh_nodes_packed.detach(),
                                  data.bvh_links_packed, corners,
                                  int(data.max_leaf), o, d)
        scale = R / pick.numel()
        work["visits"] *= scale
        work["slots"] *= scale
        bound[key] = roofline.walk_bound_ms(R, work)
    total = sum(bound[(p["eye"], p["center"])] for p in poses)
    return 100.0 * total / pass1_ms
