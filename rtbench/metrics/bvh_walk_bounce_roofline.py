"""``bvh_walk_bounce_roofline``: percent of K7's roofline in each traced
frame's first closest-hit walk of reflected rays.

Kernel read: ``bvh_walk_kernel<false>`` (``csrc/bvh_walk.cu``, launched
by ``ops/traverse.py``). Of each traced frame's pass 1 (from its
``rays`` mark to the next ``end``), the first such launch that starts in
a ``tri.bounce`` stretch (a phase lasts from its mark to the next mark,
rtbench/spans.py): segment 1's closest-hit walk, which the program
launches over the whole static batch, dead rays too.

The bound is the work that the rays alive in segment 1 need over the BVH
the program built: on a seeded sample of one in ``SAMPLE`` of the
frame's padded 32 x 32-block grid of primary rays, the plain reference
(rtbench/reference/whitted.py) finds each ray's closest hit and forms the
reflected origin and direction of each ray that hit a mirror, as its
``trace_segments`` does; the plain walk's counts on those rays
(rtbench/roofline.py ``walk_work``), their number, node steps and slot
solves scaled to the whole grid, their distinct rows as the sample read
them (fewer than the whole grid reads, so the bound is low rather than
high), at the published peaks (``walk_bound_ms``). Dead rays need no
work, so the time a launch spends on them reads as lost share. The share
is the frames' bounds summed over the launches' device time summed, in
percent. Nothing where the program has no ``tri.bounce`` phase, or the
traced frames do not hold one such launch each.
"""

import bisect

import torch

from rtbench import roofline
from rtbench import spans as sp
from rtbench.reference import whitted as W

KERNELS = ("bvh_walk_kernel<false>",)
PHASE = "tri.bounce"
SAMPLE = 32
BLOCK = 32


def first_bounce_walks(trace):
    """(start, end) us of the first closest walk in a ``tri.bounce``
    stretch of each pass 1 that holds one, in order, and the number of
    pass-1 stretches; None where the program has no such phase or the
    stretch no mark."""
    table = sp.program_attr("utils.profiling", "PHASES")
    ms = sp.marks(trace) if table is not None and PHASE in table else None
    if not ms:
        return None
    # the pass-1 stretch that each mark lies in (None outside one)
    k, inside, frame_of = -1, False, []
    for phase, _ in ms:
        if phase == "rays":
            k, inside = k + 1, True
        elif phase == "end":
            inside = False
        frame_of.append(k if inside else None)
    starts = [a for _, a in ms]
    first = {}
    for name, a, b in trace.device:
        if not any(s in name for s in KERNELS):
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and ms[i][0] == PHASE and frame_of[i] is not None:
            first.setdefault(frame_of[i], (a, b))
    return [first[f] for f in sorted(first)], k + 1


def reflected(scene, o, d):
    """The rays that the reference keeps alive into segment 1: from each
    mirror hit along d - 2 (d.n) n, EPS_OFFSET off the surface."""
    kind, idx, t = W.closest_hit(scene, o, d)
    surf = W.resolve(scene, o, d, kind, idx, t)
    mirror = torch.where(surf.hit, scene.mat_mirror[surf.mat], 0.0)
    go = surf.hit & (mirror > 0)
    refl = d - 2.0 * (d * surf.normal).sum(-1, keepdim=True) * surf.normal
    return (surf.point + W.EPS_OFFSET * refl)[go], refl[go]


def read(run, state, trace, spans):
    found = first_bounce_walks(trace)
    poses = state.get("traced_poses") or []
    if found is None or not poses:
        return None
    walks, frames = found
    if not (len(walks) == frames == len(poses)):
        return None
    walk_ms = sum(b - a for a, b in walks) * 1e-3
    data = run.scene
    ref = W.RefScene(run.arrays, run.device)
    cam = poses[0]
    Hp = -(-cam["height"] // BLOCK) * BLOCK
    Wp = -(-cam["width"] // BLOCK) * BLOCK
    R = Hp * Wp
    g = torch.Generator(device=run.device).manual_seed(run.seed)
    pick = torch.randperm(R, generator=g, device=run.device)[:max(1, R // SAMPLE)]
    xs, ys = (pick % Wp).float(), (pick // Wp).float()
    scale = R / pick.numel()
    tv = data.tri_vidx.long()
    vp = data.vertex_pos.detach()
    corners = torch.cat([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], 1)
    bound = {}
    for p in poses:
        key = (p["eye"], p["center"])
        if key in bound:
            continue
        o, d = reflected(ref, *W.camera_rays(p, xs, ys))
        if not o.shape[0]:
            bound[key] = 0.0
            continue
        work = roofline.walk_work(data.bvh_nodes_packed.detach(),
                                  data.bvh_links_packed, corners,
                                  int(data.max_leaf), o, d)
        work["visits"] *= scale
        work["slots"] *= scale
        bound[key] = roofline.walk_bound_ms(round(o.shape[0] * scale), work)
    total = sum(bound[(p["eye"], p["center"])] for p in poses)
    return 100.0 * total / walk_ms
