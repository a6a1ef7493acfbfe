#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (myraytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
nvcc. Phases:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build the CUDA kernels from myraytracer_tpu_torch/csrc (seconds);
  3. build the office scene (tess 10, 18,664 triangles) on the card;
  4. every kernel against its plain PyTorch version, on the inputs of the
     office 1920x1080 frame's first Whitted segment: errors, id agreement,
     both times from CUDA events, and registers and shared memory per
     block (ptxas's -v report; K2's and K1's dynamic shared memory at
     these shapes); then K2, K1 and K1' against their plain versions on
     the cluster scan's edge batches (scenes/kinds.cluster_edge_rays:
     axis-parallel rays, origins on box faces and inside boxes, finite
     t0, inactive subgroups, clusters of one and of M triangles);
  5. office at 480x270 through the kernels and through the plain versions;
  6. office at 1920x1080 through the kernels, warm, three times: launch
     counts of that run, median seconds, rays/s, image checks;
  7. the shade-segment kernels K5 (forward) and K6 (backward, the row
     cotangents summed into the tri_pack cotangent) against their plain
     versions on the 1080p frame's first segment, with the topology from
     trace_topology and seeded random cotangents (K6's tri_pack
     cotangent once more without the rays whose re-solve fails, whose
     entries near 3e38 set the scale of the first comparison); beside K6,
     the time of the row scatter that a reverse without the row sum needs
     after it (index_add_ of the per-ray rows into tri_pack), the other
     half of the same function done that way; registers, spills and SASS
     counts of K5 and K6; then K12, the backward of the pack's material
     gather, against its plain version on seeded cotangents of office's
     shape: equal to the bit, twice and in a graph, within float rounding
     of index_put_ with accumulation (PyTorch's backward of the gather),
     both timed;
  8. the training step render_loss_grad_image at 480x270 three ways
     (kernels, plain versions, the autograd replay): losses and all 23
     gradients;
  9. the training step at 1920x1080 through the kernels, warm, three
     times (launch counts of that run, median seconds, rays/s, finite
     loss and gradients), then three Adam steps on mat_diffuse and
     light_color toward a darker render: the loss must fall;
 10. K3 and K4 against their plain versions on the first Whitted segment
     of o_04 (spheres and planes, two lights), of o_10 (textured meshes)
     and of the mixed scene at 1920x1080 (every hit kind, a cylinder):
     errors, id agreement, both times; then K8, the dense analytic tests
     (closest hit, any hit), against their plain versions on o_04's
     pass-1 rays and on the light-major shadow batch K3 emits for their
     hits: kinds and ids equal and t to the bit, occlusion equal, both
     times, the bound, registers, spills and SASS counts; then K10 and
     K11, the fused shade segment on sphere and plane hits, against their
     plain versions on o_04's first two segments at golden resolution
     (the recorded topology, seeded cotangents): per-ray outputs at the
     shading bar (and how many equal to the bit), the table and
     environment sums at the cotangent bars, K11 twice on the same
     inputs equal to the bit and with only the fit cell's cotangents
     (mat16, the lights, the weight) equal to the bit to those of a full
     run, each kernel's ms of 20 launches in a graph beside the plain
     version's and the bound in bytes over 3.35 TB/s, registers, spills
     and SASS counts;
 11. the golden gallery: each of the ten goldens at its golden
     resolution through render_aa, warm, three times (median seconds,
     launch counts of that run, peak device memory), held against its
     plain-version run (>= 99.5% of pixels within 1e-4) and against the
     committed outputs/<name>.png (mean 8x8 cell delta below 1e-3,
     >= 99% of pixels within 2/255), K8 launched in both modes exactly
     where the scene holds a sphere, plane or cylinder; the mixed scene
     at 1920x1080 through render_aa;
 12. office at 1920x1080 through render_aa, warm, three times, with the
     AA budget sized from the pass-1 image as bench.py sizes it, and
     whether that budget covers every pixel above the threshold;
 13. the BVH walk K7 against its plain version on the office 1920x1080
     frame's primary rays (closest hit) and on the shadow batch K3 emits
     for those hits (any-hit, t_max, active): ids, errors, both times,
     lanes busy (the plain walk's step counts per warp: over the rays in
     call order, and for any-hit over the active rays compacted as K7
     launches them), issue slots per warp step, registers, spills and
     SASS counts;
     beside it, on the same rays, the cluster scan's K2 + K1 and K1'
     times and its ids' agreement with K7's; then the list walk of the
     bounce segments on the rings (o_09, 700x500, 8,192 triangles):
     segment 1's closest query and its shadow query, recorded from a
     render with the live masks it made, through KL (the list of the
     live rays, traverse.walk_list) against its plain version (ids,
     count, the dead rays' misses) and through K7's listed launch
     against the plain walk and K7's launch over the whole batch, to the
     bit; KL's and each listed walk's ms, bound, registers and SASS, and
     KL's launches in one graphed render_aa of the rings (12);
 14. office at 1920x1080 with tri_method="bvh": render, render_aa and
     render_loss_grad_image, each warm and three times (median seconds,
     launches of that run: the walk launched, no cluster kernel), held
     against the cluster path's image, loss and gradients;
 15. the seven goldens with triangles through render_aa with "bvh" at
     golden resolution, against the committed PNGs (phase 11's bars);
 16. training on o_04 (spheres and planes) and o_10 (textured, bilinear
     fetch) at golden resolution with "bvh": three warm steps (median
     seconds, finite loss and gradients) and three Adam steps in which
     the loss falls; o_04 takes the fused K10/K11 route (both launched,
     no K5/K6), o_10 the autograd replay (neither);
 17. the CLI's render verb in process (python -m myraytracer_tpu_torch
     render): examples/demo.sce at 640x480 (sphere, cylinder, mesh,
     mirror floor, depth 3) with and without --aa, and --golden
     o_08_office; each PNG against render / render_aa called directly
     with tri_method="auto", demo.sce's kernel render against its
     plain-version render (>= 99.5% of pixels within 1e-4), seconds and
     launches of each CLI call and the build seconds it prints (the
     native BVH, Scene.build's default where g++ is found);
 18. inverse rendering on office at 1920x1080 over every pixel
     (InverseRenderer.fit_pixels, "auto"): five Adam steps on mat_diffuse
     and light_color toward a darker render (the loss falls, losses and
     parameters finite, median step seconds), a checkpoint saved,
     restored into a new renderer and stepped once more, and three steps
     on cam_eye (finite, K6 launched: the pose gradient comes through
     K6's ray cotangents);
 19. the port's bench (myraytracer_tpu_torch.bench) at 1920x1080, tess
     10, in process: its JSON lines, each printed after "bench: "; its
     last line must hold every key, stage fwd_bwd, a covering AA budget
     and the card's name and power limit as its device; its
     scene_build_s printed.

Phases 17 to 19 run the "bvh" path (tri_method="auto"): each sets the
launch counts to 0 just before it and checks after it that the walk, K3
and K4 (and, where it trains, K5 and K6) were launched and the cluster
scan's kernels were not.

 20. the sharded path (parallel/) on office at 1920x1080, tess 10:
     render_sharded, render_aa_sharded (the budget sized as phase 12
     sizes it), one sharded SGD step (loss_grad_sharded and
     make_train_step on the screen-block batch) and three Adam steps of
     InverseRenderer(mesh=...) on mat_diffuse (parallel/dryrun.run_suite,
     each part three times, the third timed: on the card a replay of a
     captured graph): first on one device, then at world size 1 over NCCL
     in this process, graphed and under disable_graphs(), then at world
     size 2 over gloo, two ranks on cuda:0 spawned by
     parallel/dryrun.spawn (the scene through replicate_global;
     make_mesh(3) and replicate_global of a different tensor on each rank
     must raise). At world size 1 each part's third call must replay (the
     fit's third step captures and replays) and equal its eager run:
     images bit-equal, launches equal, the step's loss within rtol 1e-6
     and its parameters within lr / n_total x REL_GRAD x max|eager
     gradient| plus one ulp, fit losses within rtol 1e-5; five fit steps
     with a checkpoint saved (an eager barrier on the group) between the
     replays of steps 4 and 5; the render, AA and step timed in turns
     against eager (10 pairs); o_04's sharded render_aa and step (bvh) in
     5 pairs, whose captures must hold 4 and 6 IF nodes and skip 2 and 3
     bodies a replay. At world size 2 over gloo no graph is warmed up,
     captured or replayed (eager by rule). Each rank's
     launches per part (K2, K1, K1', K3 and K4 for the render and AA;
     the cluster scan, K3, K5 and K6 for the step; the walk, K3, K4, K5
     and K6, and no cluster kernel, for the fit), held against the
     single-device results: images >= 99.5% of pixels within 1e-4 (at
     world size 1 equal bit for bit), the loss within rtol 1e-5, every
     gradient within REL_GRAD * max|single|, the fit's losses within
     rtol 1e-5; wall seconds beside the single device's (third calls);
 21. the native BVH builder (runtime/native.py) against NumPy on office
     tess 10 and tess 28: BVH seconds and whole Scene.build seconds of
     each and of the default (which must be the native builder: g++ is
     on this host), which arrays are equal, and a 480x270 render of the
     native-built scene against the NumPy-built one (>= 99.5% of pixels
     within 1e-4); on tess 28 (110,572 triangles, 1,356 clusters) the
     cluster scan (K2 + K1) against the walk (K7) on the 480x270 primary
     rays: hit masks and ids agree on >= 99.5%, t within rtol 5e-5 where
     the ids agree;
 22. the port's inverse demo (examples/inverse_demo_torch.py) at its
     defaults on the card: each of its three fits lowers its loss, its
     seconds;
 23. the entry points replayed as CUDA graphs (ops/graphs.py) against
     their eager runs under disable_graphs(), on office at 1920x1080
     with "cluster" and "auto": render, render_aa (the budget sized as
     phase 12 sizes it), the training step and five fit steps. The third
     call of each (the fit's third step on) must replay a captured graph
     that holds no IF node (office has one segment), launch the same
     kernels as often as the eager call, and agree with it: images
     bit-equal, the loss within rtol 1e-6, gradients within REL_GRAD x
     max|eager|, fit losses within rtol 1e-5. Each is then timed in
     turns, 10 (eager, graphed) pairs alternating which runs first
     (medians, pairs won, the largest graphed/eager ratio), with each
     path's device-busy time from torch.profiler over three calls and
     its share of the median wall time; the 1080p training step's
     max_memory_reserved eager and graphed; o_03's and o_04's render_aa
     and o_04's and o_03's training steps (o_04's is phase 16's) the
     same way, in 5 pairs, busy time over one call: their captures hold
     IF nodes (segments 1.. under a CUDA-graph IF node,
     ops/graphs.if_node), printed with the bodies run and skipped per
     replay and the launches that ran graphed against eager (which runs
     every segment and selects); on o_04, whose third segment is dead, a
     replay must skip a body. A training step holds three IF nodes per
     segment after the first (the topology's, trace_shade's forward and
     its backward): o_04's step must capture 6 and skip 3 (its skipped
     sites printed), o_03's capture 60 (its replay K5/K6 beside
     K10/K11, the "fused_mixed" route; its gradients' non-finite
     entries, behind re-solves that fail on a mirror, must be the same
     graphed as eager); o_04's
     step's max_memory_reserved eager and graphed.

 24. the differentiable forward: render(clamp=False) under autograd,
     whose trace takes the replay route (the topology kernels, then
     trace_shade and its backward), run eagerly (disable_graphs). (a)
     office at 1920x1080, tess 10, "cluster" and "auto": the SSE against
     0.9 * render + 0.02, its loss and 23 gradients against
     render_loss_grad_image's (rtol 1e-5, REL_GRAD x max|g|), its image
     against the no-grad render(clamp=False) (the render bar), the
     launches of one call (K2, K1, K1', K3, K4, K5 and K6, or K7 with K3
     to K6 and no cluster kernel), no graph made, the median of three
     warm forward+backward walls beside render_loss_grad_image's graphed
     median, and the peak reserved memory; (b) o_10 (textured) at golden
     resolution with "bilinear": the kernels' route against plain=True
     (the image at the render bar, every gradient at the gradient bar,
     texels, uv_u and uv_v nonzero), and the no-grad render(clamp=False)
     graphed (its third call a replay) at the render bar against the
     image under grad; (c) o_04 at golden resolution under autograd
     against render_loss_grad_image, timed; (d) tools/fit_palette_torch.py
     on o_07 at scale 1.0 for 50 Adam steps at the tool's learning rate
     and at a tenth of it (FIT_LRS): the cell MSE falls at the tenth, the
     median seconds per step.
 25. the same render(clamp=False) under autograd graphed: a forward
     graph and, at the loss's backward, a backward graph
     (ops/graphs.py's differentiable region), against disable_graphs()
     and against the graphed render_loss_grad_image of the same target.
     Office 1920x1080 on "cluster" and "auto", 10 pairs in turns: the
     warm-up, the capture of both graphs and a replay of both in the
     first three calls; the image bit-equal to eager, the loss within
     rtol 1e-6 and the 23 gradients within REL_GRAD x max|g| of eager
     (phase 23's bars) and within rtol 1e-5 / REL_GRAD of the training
     step (phase 24's); one launch of each of K2, K1, K1', K3, K4, K5,
     K6 and K12 per replayed call on "cluster" and of K7 (closest,
     any-hit), K3, K4, K5, K6 and K12 on "auto" (each kernel's
     diff_launches); on "cluster"
     the pending rule (two forwards of one key, then one backward: the
     second runs eagerly, the gradients at phase 23's bars against
     all-eager; a dropped output frees the key) and max_memory_reserved
     eager and graphed; device busy of a graphed and an eager call
     (torch.profiler). o_04 at 500x500 (5 pairs): 6 IF nodes in the two
     graphs, 3 bodies skipped per replay (named), loss and gradients
     equal to eager's to the bit, K10 and K11 launched twice a replayed
     call (segments 0 and 1; their diff_launches) and K5/K6 never. o_10
     at 600x300 with "bilinear" (5 pairs): the same bars as office.

On a CUDA device the entry points replay CUDA graphs by default, so the
phases before 23 run them graphed too: their launch counts are per
replay (ops/graphs.py), with the launches of the IF nodes' bodies that
ran added after each call (graphs.count_bodies), and every run through
the kernels' plain versions (cfg plain=True, which read the host by
design) runs under disable_graphs(). Kernel times ("ms") are the card's own: 20 launches
captured in one CUDA graph, replayed and timed by CUDA events
(graph_ms); the plain versions' times are host-clocked launches
(time_ms).

Every kernel entry of the JSON summary carries its bound: the larger of
the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and the operations these inputs need over 67 TFLOP/s
(fp32, H100 SXM data sheet); the operation counts per ray, box or
triangle test are estimates from the plain versions' expressions. Both
count what this run's data needs: a gathered table only the distinct
rows its indices select, the scans the slab tests, visits and real
triangles (not padded slots) that the plain scan counts on these inputs,
and the walk the distinct node, link and corner rows and the node steps
and slot solves that the plain walk counts. K2's bound counts the work
its exact warp cull leaves on these rays: a bundle test per (warp, box)
of the warps it culls and a slab test per (active ray, box) that the
cull keeps; beside it, its entry carries all_pairs_bound_ms (and
all_pairs_bound_by), every (ray, box) slab test. K8 counts the
ray-primitive pairs it tests on these rays (closest hit: every pair;
any hit: each casting ray's rows in ana16 order up to its first
occluder, from the plain dense tests) at OPS_ANA operations a pair, what
a miss costs, and reads each ray's xyz origin and direction, its
distance and cast flag, and the 32 bytes of each row it stages.

Prints one JSON line with the per-kernel summary, then a final JSON status
line; ``--log PATH`` writes the whole output to PATH as well. Any failed
check raises and the exit code is non-zero; without a CUDA device it
exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: (launch counter, source, the TPU kernel it replaces)
KERNELS = (
    ("phase1_exact", "myraytracer_tpu_torch/csrc/phase1.cu",
     "myraytracer_tpu/ops/pallas_cluster.py:286"),
    ("cluster_scan_closest", "myraytracer_tpu_torch/csrc/cluster_scan.cu",
     "myraytracer_tpu/ops/pallas_cluster.py:85"),
    ("cluster_scan_anyhit", "myraytracer_tpu_torch/csrc/cluster_scan.cu",
     "myraytracer_tpu/ops/pallas_cluster.py:85"),
    ("shade_pre", "myraytracer_tpu_torch/csrc/shade.cu",
     "myraytracer_tpu/ops/pallas_shade.py:143"),
    ("shade_phong", "myraytracer_tpu_torch/csrc/shade.cu",
     "myraytracer_tpu/ops/pallas_shade.py:336"),
    ("seg_fwd", "myraytracer_tpu_torch/csrc/shade_grad.cu",
     "myraytracer_tpu/ops/shade_grad.py:503"),
    ("seg_bwd", "myraytracer_tpu_torch/csrc/shade_grad.cu",
     "myraytracer_tpu/ops/shade_grad.py:516"),
)

#: K7, the BVH walk behind TraceConfig(tri_method="bvh")
BVH_KERNELS = tuple(
    (name, "myraytracer_tpu_torch/csrc/bvh_walk.cu",
     "tools/studies/pallas_traverse.py:79")
    for name in ("bvh_walk_closest", "bvh_walk_anyhit"))

#: KL, the list of a bounce query's live rays that K7 walks; it replaces
#: no TPU kernel
WALK_LIST_KERNELS = (
    ("bvh_walk_list", "myraytracer_tpu_torch/csrc/bvh_walk.cu",
     "none: the reference's walk runs over the whole batch "
     "(tools/studies/pallas_traverse.py:79)"),)

#: K8, the dense analytic tests; it replaces no TPU kernel
ANALYTIC_KERNELS = tuple(
    (name, "myraytracer_tpu_torch/csrc/analytic.cu",
     "none: the reference's tests are XLA, myraytracer_tpu/ops/tracer.py:193")
    for name in ("analytic_closest", "analytic_anyhit"))

#: K10/K11, the fused shade segment on sphere and plane hits; they
#: replace no TPU kernel
ANA_SEG_KERNELS = tuple(
    (name, "myraytracer_tpu_torch/csrc/shade_grad_ana.cu",
     "none: the reference replays sphere and plane hits through autodiff "
     "(myraytracer_tpu/ops/shade.py resolve_hit)")
    for name in ("seg_ana_fwd", "seg_ana_bwd"))

#: K12, the fixed-order row sum of the shade pack's material gather; it
#: replaces no TPU kernel
PACK_KERNELS = (
    ("pack_rowsum", "myraytracer_tpu_torch/csrc/pack_rowsum.cu",
     "none: the reference leaves the pack gather's scatter-add to XLA "
     "(myraytracer_tpu/ops/shade.py pack_shade_geom)"),)

#: K3/K4's analytic and texture branches, each its own summary entry:
#: (entry, launch counter, source, TPU kernel, the scene whose first
#: segment compares it and whose render_aa run counts its launches)
BRANCHES = tuple(
    (f"{k}[{case}]", k, "myraytracer_tpu_torch/csrc/shade.cu",
     f"myraytracer_tpu/ops/pallas_shade.py:{line}", scene)
    for case, scene in (("analytic", "o_04_molecule"),
                        ("texture", "o_10_pokemon"),
                        ("mixed", "mixed_1080p"))
    for k, line in (("shade_pre", 143), ("shade_phong", 336)))

#: peak rates of one H100 SXM (data sheet): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

#: operation estimates from the plain versions' expressions: a slab test
#: (K2, and the scan's per-pair box test), one ray-triangle slot solve
#: (K1), the per-ray shading work by hit kind and per light (K3, K4), and
#: the shade segment (K5; K6 about three times K5)
OPS_SLAB, OPS_TRI = 24, 51
OPS_PRE = {"tri": 110, "texture": 25, "sphere": 20, "plane": 12,
           "cylinder": 35, "ray": 10, "light": 30}
OPS_PHONG_RAY, OPS_PHONG_LIGHT = 30, 45
OPS_SEG_RAY, OPS_SEG_LIGHT, BWD_OVER_FWD = 150, 45, 3
#: K8's operations per ray-primitive pair up to the miss decision (a
#: sphere's discriminant; a plane's two dots, parallel test and divide; a
#: cylinder's quadratic), for spheres, planes, cylinders
OPS_ANA = (20, 14, 45)

#: the gallery's bars: kernels vs plain, and vs the committed PNGs
GALLERY_AGREE, PNG_CELL_MEAN, PNG_PIX, PNG_PIX_FRAC = 0.995, 1e-3, 2 / 255, 0.99

#: kernels each path must launch: the forward render (cluster scan, BVH
#: walk); the cluster kernels, which the "bvh" path must not launch
CLUSTER_KERNELS = ("phase1_exact", "cluster_scan_closest",
                   "cluster_scan_anyhit")
FWD_KERNELS = CLUSTER_KERNELS + ("shade_pre", "shade_phong")
BVH_FWD_KERNELS = ("bvh_walk_closest", "bvh_walk_anyhit", "shade_pre",
                   "shade_phong")

#: each kernel's entry point, as its mangled name in ptxas's report
#: contains it
SYMBOLS = {"phase1_exact": "phase1_exact_kernel",
           "cluster_scan_closest": "cluster_scan_kernelILb0E",
           "cluster_scan_anyhit": "cluster_scan_kernelILb1E",
           "shade_pre": "shade_pre_kernel",
           "shade_phong": "shade_phong_kernel",
           "seg_fwd": "seg_fwd_kernel",
           "seg_bwd": "seg_bwd_kernel",
           "bvh_walk_closest": "bvh_walk_kernelILb0E",
           "bvh_walk_anyhit": "bvh_walk_kernelILb1E",
           "bvh_walk_list": "walk_list_kernel",
           "analytic_closest": "analytic_kernelILb0E",
           "analytic_anyhit": "analytic_kernelILb1E",
           "seg_ana_fwd": "seg_ana_fwd_kernel",
           "seg_ana_bwd": "seg_ana_bwd_kernel",
           "pack_rowsum": "rowsum_part_kernel"}

#: the training scenes of phase 16 with their texture fetch
TRAIN_GOLDENS = (("o_04_molecule", "nearest"), ("o_10_pokemon", "bilinear"))

#: kernel vs plain version. Shading (K3/K4, built without FMA
#: contraction) and phase-1 (K2): float outputs within rtol 1e-5 / atol
#: 1e-6 and integer outputs equal. The cluster scan (K1/K1', built with
#: contraction): hit ids and occlusion agree on >= 99.5% of rays (the
#: reference's own bar for two forms of one solve) and t within rtol 5e-5
#: where the ids agree (the reference's bar for t).
RTOL, ATOL, ID_AGREE, RTOL_T = 1e-5, 1e-6, 0.995, 5e-5

#: K6's cotangents (atomic sums in a run-dependent order) within
#: REL_COT * max|plain|, and the training step's gradients (index_add_
#: and atomics over many rays) within REL_GRAD * max|a|: the reference's
#: own bars for its hand-derived VJP (tests/test_shade_grad.py)
REL_COT, REL_GRAD = 3e-5, 5e-4


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call of the card's own time: ``reps`` calls
    captured in one CUDA graph, replayed once warm, then three replays
    between CUDA events. No host launch time lies between the kernels,
    so a kernel shorter than its launch is timed, not its host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rows(table, idx) -> int:
    """Bytes of the distinct rows of ``table`` that the indices ``idx``
    read: a gathered table counts what this run's data reads of it."""
    import torch

    n = torch.unique(idx).numel() if idx.numel() else 0
    return n * table[0].numel() * table.element_size()


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the fp32 rate."""
    tb, to = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else
                "operations", library_ms=None)


def cells(img, grid: int = 8):
    """Mean colour of each cell of a grid x grid partition of [H, W, 3]."""
    import numpy as np

    h, w, _ = img.shape
    ys = np.linspace(0, h, grid + 1).astype(int)
    xs = np.linspace(0, w, grid + 1).astype(int)
    out = np.zeros((grid, grid, 3), np.float32)
    for i in range(grid):
        for j in range(grid):
            out[i, j] = img[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean((0, 1))
    return out


def close(name, got, want, rtol=RTOL) -> float:
    """Max abs diff of two float tensors; checks rtol/atol."""
    diff = (got - want).abs()
    bad = diff > ATOL + rtol * want.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} values outside rtol {rtol} atol {ATOL}")
    return float(diff.max()) if diff.numel() else 0.0


def close_scaled(name, got, want, rel) -> float:
    """Max abs diff in units of max|want|; checks it is at most rel."""
    import torch

    check(bool(torch.isfinite(want).all()), f"{name}: reference not finite")
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-3)
    ratio = float((got - want).abs().max()) / scale if want.numel() else 0.0
    check(ratio <= rel, f"{name}: max diff {ratio:.3g} * max|a|, bar {rel}")
    return ratio


def resources(name: str, ptxas: dict, dynamic: int = 0) -> dict:
    """A kernel's registers, shared memory per block (static, from the
    ptxas report, plus ``dynamic``), spill stores and loads and stack
    frame; printed."""
    hits = [v for k, v in ptxas.items() if SYMBOLS[name] in k]
    check(len(hits) == 1, f"{name}: {len(hits)} entries in the ptxas report")
    r = hits[0]
    out = dict(registers=r["registers"],
               smem_bytes=r["smem_static"] + dynamic,
               spill_stores=r["spill_stores"], spill_loads=r["spill_loads"],
               stack_frame=r["stack_frame"])
    print(f"{name}: {out['registers']} registers, {out['smem_bytes']} B "
          f"shared memory per block ({r['smem_static']} static + {dynamic} "
          f"dynamic), {out['spill_stores']} B spill stores, "
          f"{out['spill_loads']} B spill loads, {out['stack_frame']} B "
          f"stack frame")
    return out


def sass_counts(name: str, sass) -> dict:
    """A kernel's static SASS counts (kernels._build.kernel_sass), or {}
    when cuobjdump was not found; printed."""
    if sass is None:
        print(f"{name}: SASS not measured (no cuobjdump)")
        return {}
    hits = [v for k, v in sass.items() if SYMBOLS[name] in k]
    check(len(hits) == 1, f"{name}: {len(hits)} entries in the SASS")
    s = hits[0]
    print(f"{name}: SASS {s['instructions']} instructions, {s['ldl']} LDL, "
          f"{s['stl']} STL, {s['atomics']} atomics, loop bodies {s['loops']}")
    return dict(sass_instructions=s["instructions"], sass_ldl=s["ldl"],
                sass_stl=s["stl"], sass_loops=s["loops"])


def compare_kernels(data, camera, report, ptxas):
    """Phase 4: each kernel vs its plain version at the 1080p shapes, with
    its registers and shared memory per block."""
    import torch

    from myraytracer_tpu_torch.kernels import library
    from myraytracer_tpu_torch.ops import cuda_cluster as cc
    from myraytracer_tpu_torch.ops import cuda_shade as cs
    from myraytracer_tpu_torch.ops import shade, tracer as tr
    from myraytracer_tpu_torch.ops.intersect import INF
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(camera, data.device)
    R, L = o.shape[0], data.n_lights
    live = torch.ones(R, dtype=torch.bool, device=o.device)
    o4, d4, t0, act = cc.pad_rays(o, d, None, live)
    bb = cc.cluster_boxes(data)

    # K2
    key = cc.phase1_exact(o4, d4, t0, act, bb)
    work = {}
    key_p = cc.phase1_exact_plain(o4, d4, t0, act, bb, stats=work)
    touched = key < INF
    check(bool((touched == (key_p < INF)).all()), "phase1_exact: touched sets differ")
    err = close("phase1_exact", key[touched], key_p[touched])
    k2_bytes = nbytes(o4, d4, t0, act, bb, key)
    # the bound counts the work K2's exact warp cull leaves on these rays,
    # as its plain version counts it (a bundle test and a slab test each
    # OPS_SLAB); beside it, every (ray, box) slab test
    all_pairs = bound(k2_bytes, OPS_SLAB * o4.shape[0] * bb.shape[0])
    report["phase1_exact"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: cc.phase1_exact(o4, d4, t0, act, bb)),
        plain_ms=time_ms(lambda: cc.phase1_exact_plain(o4, d4, t0, act, bb), 2),
        **bound(k2_bytes, OPS_SLAB * (work["bundle_tests"] + work["slabs"])),
        all_pairs_bound_ms=all_pairs["bound_ms"],
        all_pairs_bound_by=all_pairs["bound_by"])
    print(f"phase1_exact: S={key.shape[0]} K={key.shape[1]} "
          f"touched/subgroup={float(touched.sum(1).float().mean()):.1f} "
          f"max_abs_err={err}; work: {work['warps']} live warps, "
          f"{work['cull_warps']} culled ({work['mixed_warps']} straddling "
          f"an axis; {work['bundle_tests']} bundle tests), "
          f"{work['slabs']} slab tests "
          f"({work['slabs'] / max(o4.shape[0], 1):.2f} a ray); bound after "
          f"the cull {report['phase1_exact']['bound_ms']:.4f} ms "
          f"({report['phase1_exact']['bound_by']}), every (ray, box) test "
          f"{all_pairs['bound_ms']:.4f} ms")
    lib = library()
    report["phase1_exact"].update(resources(
        "phase1_exact", ptxas, lib.mrt_phase1_exact_smem(bb.shape[0])))
    scan_smem = lib.mrt_cluster_scan_smem(pack.cl_rows.shape[1])

    # K1 closest-hit
    order, lb, n = cc.visit_lists(key)
    scan_args = (o4, d4, t0, act, bb, pack.cl_rows, order, lb, n,
                 data.cl_first, data.cl_count, False)
    tk, ik = cc.cluster_scan(*scan_args)
    work = {}
    tp, ip = cc.cluster_scan_plain(*scan_args, stats=work)
    agree = float((ik == ip).float().mean())
    check(agree >= ID_AGREE, f"cluster_scan_closest: id agreement {agree}")
    same = (ik == ip) & (ik >= 0)
    err = close("cluster_scan_closest", tk[same], tp[same], RTOL_T)
    report["cluster_scan_closest"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: cc.cluster_scan(*scan_args)),
        plain_ms=time_ms(lambda: cc.cluster_scan_plain(*scan_args), 2),
        **scan_bound(scan_args, (tk, ik), work))
    print(f"cluster_scan_closest: hits={float((ik >= 0).float().mean()):.4f} "
          f"id_agreement={agree} max_abs_err(t)={err}; {scan_work(work)}")
    report["cluster_scan_closest"].update(
        resources("cluster_scan_closest", ptxas, scan_smem))

    # K3 on the kernel's hits, as the tracer builds its inputs
    idx = ik[:R]
    t = torch.where(idx >= 0, tk[:R], torch.full_like(tk[:R], INF))
    kind = torch.where(idx >= 0, shade.KIND_TRI, shade.KIND_MISS).to(torch.int32)
    tri_idx = torch.clamp(idx, min=0).contiguous()
    live_i = live.to(torch.int32)
    pre_args = (o, d, t.contiguous(), kind, live_i, tri_idx,
                torch.zeros_like(tri_idx), pack.geom.tri_pack,
                pack.geom.ana16, pack.geom.mat16, data.light_pos,
                data.texels.shape[0])
    pre, report["shade_pre"] = compare_pre("shade_pre", data, pre_args)
    report["shade_pre"].update(resources("shade_pre", ptxas))

    # K1' any-hit on the shadow batch (hull phase-1)
    so, sd, st, sact = pre[4:]
    so4, sd4, st0, sact_p = cc.pad_rays(so, sd, st, sact > 0)
    hkey = cc.phase1_keys(data, so4, sd4, st0, sact_p, True, True)
    horder, hlb, hn = cc.visit_lists(hkey)
    any_args = (so4, sd4, st0, sact_p, bb, pack.cl_rows, horder, hlb, hn,
                data.cl_first, data.cl_count, True)
    t_any, oi = cc.cluster_scan(*any_args)
    work = {}
    _, oi_p = cc.cluster_scan_plain(*any_args, stats=work)
    occ, occ_p = oi >= 0, oi_p >= 0
    agree = float((occ == occ_p).float().mean())
    check(agree >= ID_AGREE, f"cluster_scan_anyhit: occlusion agreement {agree}")
    report["cluster_scan_anyhit"] = dict(
        max_abs_err=float((occ.float() - occ_p.float()).abs().max()),
        ms=graph_ms(lambda: cc.cluster_scan(*any_args)),
        plain_ms=time_ms(lambda: cc.cluster_scan_plain(*any_args), 2),
        **scan_bound(any_args, (t_any, oi), work))
    print(f"cluster_scan_anyhit: occluded={float(occ.float().mean()):.4f} "
          f"agreement={agree}; {scan_work(work)}")
    report["cluster_scan_anyhit"].update(
        resources("cluster_scan_anyhit", ptxas, scan_smem))

    # K4
    shadow = occ[:L * R].to(torch.int32).reshape(L, R).contiguous()
    report["shade_phong"] = compare_phong("shade_phong", data, pack, o, d,
                                          kind, live_i, pre, shadow)
    report["shade_phong"].update(resources("shade_phong", ptxas))


def compare_edge_batches(dev):
    """Phase 4b: K2, K1 and K1' vs their plain versions on the cluster
    scan's edge batches: touched sets equal and keys within the bar, ids
    (closest) and occlusion (any-hit, a finite t_max) on >= 99.5% of rays,
    t within the edge batches' bar (kinds.edge_t_misses: RTOL_T plus
    2^-22 of the solve's rounding scale, and within RTOL_T alone on >=
    99%)."""
    import numpy as np
    import torch

    from myraytracer_tpu_torch.ops import cuda_cluster as cc
    from myraytracer_tpu_torch.ops.intersect import INF
    from myraytracer_tpu_torch.scenes import kinds

    data = kinds.cluster_edge_scene().build(device=dev)
    count = data.cl_count.cpu().numpy()
    bb = cc.cluster_boxes(data)
    rows = cc.pack_cluster_rows(data)
    check(data.cl_first.shape[0] % 32 != 0 and (count == 1).any()
          and (count == data.cl_M).any(), "edge scene: the cut lost its edges")
    rng = np.random.default_rng(0)
    worst = dict(key=0.0, t=0.0, ids=1.0, occ=1.0)
    for case in kinds.EDGE_CASES:
        o, d, t_max, active = (
            None if x is None else torch.from_numpy(x).to(dev)
            for x in kinds.cluster_edge_rays(
                case, data.cl_bbmin.cpu().numpy(),
                data.cl_bbmax.cpu().numpy(), count))
        o4, d4, t0, act = cc.pad_rays(o, d, t_max, active)
        key = cc.phase1_exact(o4, d4, t0, act, bb)
        key_p = cc.phase1_exact_plain(o4, d4, t0, act, bb)
        touched = key_p < INF
        check(bool(((key < INF) == touched).all()),
              f"edge {case}: phase1_exact touched sets differ")
        worst["key"] = max(worst["key"], close(f"edge {case}: phase1_exact",
                                               key[touched], key_p[touched]))
        for any_hit in (False, True):
            tq = t0
            if any_hit and t_max is None:
                tq = torch.from_numpy(rng.uniform(0.5, 40.0, o4.shape[0])
                                      .astype(np.float32)).to(dev)
            k = cc.phase1_keys(data, o4, d4, tq, act, any_hit, any_hit)
            args = (o4, d4, tq, act, bb, rows, *cc.visit_lists(k),
                    data.cl_first, data.cl_count, any_hit)
            tk, ik = cc.cluster_scan(*args)
            tp, ip = cc.cluster_scan_plain(*args)
            if any_hit:
                agree = float(((ik >= 0) == (ip >= 0)).float().mean())
                worst["occ"] = min(worst["occ"], agree)
            else:
                agree = float((ik == ip).float().mean())
                worst["ids"] = min(worst["ids"], agree)
                same = (ik == ip) & (ik >= 0)
                n_bad, frac = kinds.edge_t_misses(
                    rows, data.cl_first, o4[same], d4[same], ik[same],
                    tk[same], tp[same], RTOL_T)
                check(n_bad == 0 and frac >= 0.99, f"edge {case}: "
                      f"cluster_scan_closest t: {n_bad} values outside the "
                      f"bar, {frac} within rtol {RTOL_T}")
                worst["t"] = max(worst["t"],
                                 float((tk[same] - tp[same]).abs().max()))
            check(agree >= ID_AGREE, f"edge {case}: cluster_scan "
                  f"{'anyhit' if any_hit else 'closest'} agreement {agree}")
    print(f"edge batches ({', '.join(kinds.EDGE_CASES)}; {data.n_tris} "
          f"triangles, K={data.cl_first.shape[0]}): phase1_exact touched sets "
          f"equal, max_abs_err {worst['key']}; cluster_scan_closest ids agree "
          f"on >= {worst['ids']}, max_abs_err(t) {worst['t']}; "
          f"cluster_scan_anyhit occlusion agrees on >= {worst['occ']}")


def scan_work(work: dict) -> str:
    """The plain scan's count of the work K1/K1' do on these inputs: the
    share of the warps' slot steps that a lane needs is the kernel's lane
    utilisation in its slot loop."""
    util = work["tris"] / max(32 * work["warp_slots"], 1)
    return (f"work: {work['visits']} visits, {work['slabs']} slab tests, "
            f"{work['tris']} slot solves in {work['warp_slots']} warp slot "
            f"steps (lanes busy {util:.3f})")


def scan_bound(args, outs, work: dict) -> dict:
    """K1/K1''s bound from the work this run's data needs, as the plain
    scan counts it (``work``, its ``stats``): the rays and results once,
    an order and a lb entry per (subgroup, step) visit, the tables of the
    visited clusters; a slab test for each ray still searching in a
    visited subgroup, and one slot solve for each real triangle of a
    touched (ray, cluster) pair (not the M padded slots; K1' stops at a
    pair's first occluding slot)."""
    o4, d4, t0, act, bb, cl_rows, order, lb, n_touched, first, count = \
        args[:11]
    per_cluster = nbytes(bb[0], cl_rows[0], first[:1], count[:1])
    n_bytes = (nbytes(o4, d4, t0, act, n_touched, *outs)
               + work.get("visits", 0) * (order.element_size()
                                          + lb.element_size())
               + len(work.get("clusters", ())) * per_cluster)
    return bound(n_bytes, work.get("slabs", 0) * OPS_SLAB
                 + work.get("tris", 0) * OPS_TRI)


def pre_ops(kind, texid, L: int) -> float:
    """K3's operations on these rays, by hit kind (OPS_PRE)."""
    from myraytracer_tpu_torch.ops import shade

    n = {k: int((kind == v).sum()) for k, v in (
        ("tri", shade.KIND_TRI), ("sphere", shade.KIND_SPHERE),
        ("plane", shade.KIND_PLANE), ("cylinder", shade.KIND_CYL))}
    n["texture"] = int((texid >= 0).sum())
    R = kind.shape[0]
    return (sum(OPS_PRE[k] * v for k, v in n.items())
            + R * (OPS_PRE["ray"] + L * OPS_PRE["light"]))


def pre_bytes(pre_args, pre) -> int:
    """K3's bytes on these rays: the per-ray columns it reads (t of a hit,
    each index of its kind), the table rows they select, its outputs."""
    from myraytracer_tpu_torch.ops import shade

    o, d, t, kind, live, tri_idx, aidx, tri_pack, ana16, mat16, lp = \
        pre_args[:11]
    is_t = kind == shade.KIND_TRI
    is_a = (kind == shade.KIND_SPHERE) | (kind == shade.KIND_PLANE) | (
        kind == shade.KIND_CYL)
    valid = kind != shade.KIND_MISS
    return (nbytes(o, d, kind, live, lp, t[valid], tri_idx[is_t], aidx[is_a],
                   *pre)
            + rows(tri_pack, tri_idx[is_t]) + rows(ana16, aidx[is_a])
            + rows(mat16, pre[2][valid]))


def compare_pre(name, data, pre_args):
    """K3 vs its plain version: ints equal, floats within the bar; times."""
    import torch

    from myraytracer_tpu_torch.ops import cuda_shade as cs

    pre = cs.shade_pre(*pre_args)
    pre_p = cs.shade_pre_plain(*pre_args)
    err = 0.0
    for i, nm in enumerate(("point", "normal", "mid", "texid", "so", "sd",
                            "st", "sact")):
        if pre[i].dtype == torch.int32:
            n_bad = int((pre[i] != pre_p[i]).sum())
            check(n_bad == 0, f"{name}: {nm} differs on {n_bad} rays")
        else:
            err = max(err, close(f"{name}.{nm}", pre[i], pre_p[i]))
    rep = dict(max_abs_err=err, ms=graph_ms(lambda: cs.shade_pre(*pre_args)),
               plain_ms=time_ms(lambda: cs.shade_pre_plain(*pre_args), 5),
               **bound(pre_bytes(pre_args, pre),
                       pre_ops(pre_args[3], pre[3], data.n_lights)))
    print(f"{name}: {pre_args[0].shape[0]} rays, shadow rays active="
          f"{float(pre[7].float().mean()):.4f}, textured="
          f"{float((pre[3] >= 0).float().mean()):.4f}, max_abs_err={err}, "
          f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.3f} ms")
    return pre, rep


def compare_phong(name, data, pack, o, d, kind, live_i, pre, shadow):
    """K4 vs its plain version on K3's outputs and a shadow mask; times."""
    import torch

    from myraytracer_tpu_torch.ops import cuda_shade as cs
    from myraytracer_tpu_torch.ops import shade

    R, L = o.shape[0], data.n_lights
    valid = (kind != shade.KIND_MISS).to(torch.int32)
    weight = torch.ones(R, device=o.device)
    args = (o, d, weight, valid, live_i, pre[2], pre[3], pre[0], pre[1],
            shadow, pack.geom.mat16, data.texels, data.light_pos,
            data.light_color, pack.env)
    ph = cs.shade_phong(*args)
    ph_p = cs.shade_phong_plain(*args)
    err = max(close(f"{name}.{nm}", a, b)
              for nm, a, b in zip(("add", "o2", "d2", "w2"), ph, ph_p))
    rep = dict(max_abs_err=err, ms=graph_ms(lambda: cs.shade_phong(*args)),
               plain_ms=time_ms(lambda: cs.shade_phong_plain(*args), 5),
               **bound(nbytes(*args[:10], *args[12:], *ph)
                       + rows(pack.geom.mat16, pre[2][valid > 0])
                       + rows(data.texels, pre[3][pre[3] >= 0]),
                       R * (OPS_PHONG_RAY + L * OPS_PHONG_LIGHT)))
    print(f"{name}: max_abs_err={err}, {rep['ms']:.4f} ms vs plain "
          f"{rep['plain_ms']:.3f} ms")
    return rep


def compare_segment_kernels(data, camera, report, ptxas, sass):
    """Phase 7: K5 and K6 vs their plain versions on the 1080p first
    segment, with the recorded topology."""
    import torch

    from myraytracer_tpu_torch.kernels import library
    from myraytracer_tpu_torch.ops import shade, shade_grad as sg
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(camera, data.device)
    topo = tr.trace_topology(data, o, d, pack=pack)
    R = o.shape[0]
    ti = torch.clamp(topo.idx[0], 0, data.n_tris - 1).to(torch.int32).contiguous()
    args = (o, d, torch.ones(R, device=o.device), pack.geom.tri_pack, ti,
            data.light_pos, data.light_color, data.ambience, data.background,
            (topo.kind[0] == shade.KIND_TRI).contiguous(),
            topo.hit[0].contiguous(), topo.miss[0].contiguous(),
            (~topo.shadow[0]).float().contiguous())
    gen = torch.Generator(device=o.device)
    gen.manual_seed(0)
    cots = [torch.randn(sh, generator=gen, device=o.device)
            for sh in ((R, 3), (R, 3), (R, 3), (R,))]

    fwd, fwd_p = sg.segment_fwd(*args), sg.segment_plain(*args)
    err = max(close(f"seg_fwd.{nm}", a, b)
              for nm, a, b in zip(("add", "o2", "d2", "w2"), fwd, fwd_p))
    L = data.n_lights
    seg_ops = R * (OPS_SEG_RAY + L * OPS_SEG_LIGHT)
    tri_rows = rows(pack.geom.tri_pack, ti[args[9]])
    report["seg_fwd"] = dict(
        max_abs_err=err, ms=graph_ms(lambda: sg.segment_fwd(*args)),
        plain_ms=time_ms(lambda: sg.segment_plain(*args), 3),
        **bound(nbytes(*args[:3], *args[4:], *fwd) + tri_rows, seg_ops))
    print(f"seg_fwd: {R} rays, hits {float(args[10].float().mean()):.4f}, "
          f"max_abs_err={err}")
    report["seg_fwd"].update(resources("seg_fwd", ptxas),
                             **sass_counts("seg_fwd", sass))

    bwd = sg.segment_bwd(*args, *cots)
    bwd_p = sg.segment_bwd_plain(*args, *cots)
    names = ("g_o", "g_d", "g_w", "g_pack", "g_light_pos", "g_light_color",
             "g_ambience", "g_background")
    # a recorded hit whose re-solve fails keeps its point at t = INF; with
    # a nonzero bounce cotangent its exact reverse is inf (the
    # reference's too): those entries must match, the rest within the bar
    # (g_pack, the row cotangents summed per triangle by atomics, within
    # REL_GRAD)
    err, worst, n_inf = 0.0, {}, 0
    for nm, a, b in zip(names, bwd, bwd_p):
        check(tuple(a.shape) == tuple(b.shape), f"seg_bwd.{nm}: shape")
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a))
              and torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()),
              f"seg_bwd.{nm}: non-finite entries differ")
        n_inf += int((~fin).sum())
        bar = REL_GRAD if nm == "g_pack" else REL_COT
        worst[bar] = max(worst.get(bar, 0.0), close_scaled(
            f"seg_bwd.{nm}", a[fin], b[fin], bar))
        err = max(err, float((a[fin] - b[fin]).abs().max()))
    # g_pack once more without the rays whose re-solve fails: their
    # entries near 3e38 set max|plain| above, and hide every other row
    far = fwd_p[1].abs().amax(1) > 1e30
    cots_n = [torch.where(far.view((-1,) + (1,) * (c.dim() - 1)), 0.0, c)
              for c in cots]
    pack_k = sg.segment_bwd(*args, *cots_n)[3]
    pack_p = sg.segment_bwd_plain(*args, *cots_n)[3]
    worst_n = close_scaled("seg_bwd.g_pack (finite rays)", pack_k, pack_p,
                           REL_GRAD)
    # the same function's second half done without the row sum in the
    # kernel: each ray's row cotangent written out, then index_add_ into
    # tri_pack's columns
    rows_p = sg.segment_bwd_rows_plain(*args, *cots)[3]
    tri_pack, ti_l = args[3], ti.long()

    def row_scatter():
        g_sum = rows_p.new_zeros((tri_pack.shape[0], rows_p.shape[1]))
        g_sum.index_add_(0, ti_l, rows_p)
        g_pack = torch.zeros_like(tri_pack)
        g_pack[:, 0:9] = g_sum[:, 0:9]
        g_pack[:, 16:25] = g_sum[:, 9:18]
        g_pack[:, 32:43] = g_sum[:, 18:29]

    report["seg_bwd"] = dict(
        max_abs_err=err,
        ms=graph_ms(lambda: sg.segment_bwd(*args, *cots)),
        plain_ms=time_ms(lambda: sg.segment_bwd_plain(*args, *cots), 3),
        index_add_ms=graph_ms(row_scatter),
        **bound(nbytes(*args[:3], *args[4:], *cots, *bwd) + tri_rows,
                BWD_OVER_FWD * seg_ops))
    print(f"seg_bwd: max_abs_err={err}, worst diff {worst[REL_COT]:.3g} * "
          f"max|plain| (bar {REL_COT}), g_pack {worst[REL_GRAD]:.3g} and "
          f"without the {int(far.sum())} rays whose re-solve fails "
          f"{worst_n:.3g} (bar {REL_GRAD}); {n_inf} non-finite entries, "
          f"equal in both; "
          f"{report['seg_bwd']['ms']:.4f} ms against a bound of "
          f"{report['seg_bwd']['bound_ms']:.4f} ms; the row scatter "
          f"without it in the kernel (index_add_ of the [R, 29] rows into "
          f"tri_pack) "
          f"{report['seg_bwd']['index_add_ms']:.4f} ms")
    report["seg_bwd"].update(
        resources("seg_bwd", ptxas, library().mrt_seg_bwd_smem(L)),
        **sass_counts("seg_bwd", sass))
    compare_pack_rowsum(data, report, ptxas, sass)


def compare_pack_rowsum(data, report, ptxas, sass):
    """Phase 7, K12: the backward of the pack's material gather against
    its plain version on seeded cotangents of office's shape (columns
    32:48 of a [T, 48] table, as K6 leaves them): equal to the bit, twice
    over and inside a CUDA graph; beside it PyTorch's backward of the
    gather (index_put_ with accumulation), the call it replaces."""
    import torch

    from myraytracer_tpu_torch.ops import row_sum as rs

    ids, M, T = data.tri_mat, data.mat_diffuse.shape[0], data.n_tris
    gen = torch.Generator(device=ids.device)
    gen.manual_seed(12)
    g = torch.randn((T, 48), generator=gen, device=ids.device)[:, 32:]
    got = rs.row_sum(g, ids, M)
    check(torch.equal(got, rs.row_sum_plain(g, ids, M)),
          "pack_rowsum: not equal to its plain version's bits")
    check(torch.equal(rs.row_sum(g, ids, M), got),
          "pack_rowsum: two runs differ")
    ids_l = ids.long()
    want = torch.zeros((M, 16), device=ids.device).index_put_(
        (ids_l,), g, accumulate=True)
    err = close_scaled("pack_rowsum vs index_put_", got, want, REL_COT)
    out = torch.empty_like(got)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(rs.row_sum(g, ids, M))
    graph.replay()
    check(torch.equal(out, got), "pack_rowsum: a graph replay differs")
    del graph
    report["pack_rowsum"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=graph_ms(lambda: rs.row_sum(g, ids, M)),
        plain_ms=time_ms(lambda: rs.row_sum_plain(g, ids, M), 3),
        **bound(T * 16 * 4 + nbytes(ids, got), 0))
    report["pack_rowsum"]["library_ms"] = graph_ms(
        lambda: torch.zeros((M, 16), device=ids.device).index_put_(
            (ids_l,), g, accumulate=True))
    rep = report["pack_rowsum"]
    print(f"pack_rowsum: {T} rows into {M} materials, equal to the plain "
          f"version's bits (twice, and in a graph), {err:.3g} * max|a| "
          f"from index_put_; {rep['ms']:.4f} ms against a bound of "
          f"{rep['bound_ms']:.5f} ms ({rep['bound_by']}); plain "
          f"{rep['plain_ms']:.2f} ms; index_put_ with accumulation "
          f"{rep['library_ms']:.4f} ms")
    report["pack_rowsum"].update(resources("pack_rowsum", ptxas),
                                 **sass_counts("pack_rowsum", sass))


def compare_training_paths(data, cam_small):
    """Phase 8: the 480x270 training step through the kernels, the plain
    versions and the autograd replay: losses and all 23 gradients."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image

    target = 0.9 * render(data, cam_small) + 0.02
    runs = {}
    for name, cfg in (("kernels", tr.TraceConfig()),
                      ("plain", tr.TraceConfig(plain=True)),
                      ("autograd", tr.TraceConfig(fused_shade_grad=False))):
        with disable_graphs():
            runs[name] = render_loss_grad_image(data, cam_small, target,
                                                cfg=cfg)
    loss_k, g_k = runs["kernels"]
    check(len(g_k) == 23, f"{len(g_k)} gradient keys")
    for name in ("plain", "autograd"):
        loss, g = runs[name]
        rel = abs(float(loss_k) - float(loss)) / abs(float(loss))
        check(rel <= RTOL, f"loss kernels vs {name}: rel diff {rel}")
        check(set(g) == set(g_k), f"gradient keys of {name}")
        ratios = {k: round(close_scaled(f"grad {k} vs {name}", g_k[k], g[k],
                                        REL_GRAD), 9)
                  for k in g if g[k].numel()}
        print(f"loss-grad {cam_small.width}x{cam_small.height}: kernels "
              f"{float(loss_k)} vs {name} {float(loss)} (rel {rel:.3g}); "
              f"worst diff per key, in max|a|: {ratios}")


def train_steps(data, camera, steps: int = 3, cfg=None) -> list:
    """Phase 9b (and 16): Adam on mat_diffuse and light_color toward the
    render of the scene with mat_diffuse * 0.8; returns the losses."""
    import dataclasses

    import torch

    from myraytracer_tpu_torch import merge_params, render_loss_grad_image
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render

    cfg = cfg or tr.TraceConfig()
    target = render(dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.8),
                    camera, cfg=cfg)
    p = {k: getattr(data, k).clone().requires_grad_(True)
         for k in ("mat_diffuse", "light_color")}
    opt = torch.optim.Adam(p.values(), lr=0.02)
    losses = []
    for step in range(steps + 1):
        scene = merge_params(data, {k: v.detach() for k, v in p.items()})
        loss, grads = render_loss_grad_image(scene, camera, target, cfg=cfg)
        losses.append(float(loss))
        if step == steps:
            break
        opt.zero_grad()
        for k, v in p.items():
            v.grad = grads[k]
        opt.step()
    return losses


def first_segment(data, camera, dev):
    """The inputs K3 and K4 get on a frame's first Whitted segment, from
    the kernels' own hits: (pack, o, d, kind, live_i, K3's arguments)."""
    import torch

    from myraytracer_tpu_torch.ops import shade, tracer as tr
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    pack = tr.pack_trace(data)
    o, d = primary_rays_blocked(camera, dev)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    kind, pidx, aidx, t = tr.closest_hit(data, pack, o, d, live)
    valid = kind != shade.KIND_MISS
    zero = torch.zeros_like(pidx)
    live_i = live.to(torch.int32)
    pre_args = (o, d, t.contiguous(), kind, live_i,
                torch.where(kind == shade.KIND_TRI, pidx, zero).contiguous(),
                torch.where(valid, aidx, zero).contiguous(),
                pack.geom.tri_pack, pack.geom.ana16, pack.geom.mat16,
                data.light_pos, data.texels.shape[0])
    return pack, o, d, kind, live_i, pre_args


def compare_branch_kernels(scenes, dev, report):
    """Phase 10: K3/K4's analytic and texture branches vs their plain
    versions on the first segment of o_04, o_10 and the mixed 1080p
    scene, with the real shadow mask."""
    from myraytracer_tpu_torch.ops import shade, tracer as tr

    for case, key in (("analytic", "o_04_molecule"),
                      ("texture", "o_10_pokemon"), ("mixed", "mixed_1080p")):
        scene, data = scenes[key]
        pack, o, d, kind, live_i, pre_args = first_segment(
            data, scene.camera, dev)
        hit_kinds = sorted(set(kind[kind != shade.KIND_MISS].tolist()))
        print(f"{key}: first segment, {o.shape[0]} rays, hit kinds "
              f"{hit_kinds}, {data.n_lights} light(s)")
        pre, report[f"shade_pre[{case}]"] = compare_pre(
            f"shade_pre[{case}]", data, pre_args)
        so, sd, st, sact = pre[4:]
        shadow = tr.shadow_mask(data, pack, so, sd, st, sact).reshape(
            data.n_lights, -1).contiguous()
        report[f"shade_phong[{case}]"] = compare_phong(
            f"shade_phong[{case}]", data, pack, o, d, kind, live_i, pre,
            shadow)
        want = {"analytic": {shade.KIND_SPHERE, shade.KIND_PLANE},
                "texture": {shade.KIND_TRI},
                "mixed": {shade.KIND_SPHERE, shade.KIND_PLANE,
                          shade.KIND_TRI, shade.KIND_CYL}}[case]
        check(set(hit_kinds) == want, f"{key}: hit kinds {hit_kinds}")
        if case == "texture":
            check(bool((pre[3] >= 0).any()), f"{key}: no textured hit")


def analytic_pairs(data, o, d, dist=None, cast=None) -> tuple:
    """The ray-primitive pairs of each kind (spheres, planes, cylinders)
    that K8 tests on these rays: every pair of a closest-hit query; for an
    any-hit query (``dist``, ``cast``), each casting ray's rows in ana16
    order up to its first occluder, all of them where none occludes (the
    plain dense tests, a slice of rays at a time)."""
    import torch

    from myraytracer_tpu_torch.ops import shade, tracer as tr

    order = (shade.KIND_SPHERE, shade.KIND_PLANE, shade.KIND_CYL)
    counts = (data.n_spheres, data.n_planes, data.n_cylinders)
    if dist is None:
        return tuple(o.shape[0] * n for n in counts)
    o, d = o[:, :3], d[:, :3]
    looking = cast.clone()
    pairs = [0, 0, 0]
    for k, n, fn in tr._analytic_kinds(data):
        for sl in tr._ray_steps(data, o.shape[0]):
            occ = fn(o[sl], d[sl]) < dist[sl, None]                 # [N, n]
            hit = occ.any(dim=1)
            tested = torch.where(hit, occ.float().argmax(dim=1) + 1, n)
            pairs[order.index(k)] += int(tested[looking[sl]].sum())
            looking[sl] &= ~hit
    return tuple(pairs)


def compare_analytic(scenes, dev, report, ptxas, sass):
    """Phase 10, K8: closest hit on o_04's pass-1 rays and any hit on the
    light-major shadow batch K3 emits for their hits, against the plain
    dense tests (kinds and ids equal, t to the bit, occlusion equal)."""
    import torch

    from myraytracer_tpu_torch.ops import cuda_analytic as ca
    from myraytracer_tpu_torch.ops import cuda_shade as cs
    from myraytracer_tpu_torch.ops import tracer as tr

    scene, data = scenes["o_04_molecule"]
    pack, o, d, _, _, pre_args = first_segment(data, scene.camera, dev)
    so, sd, st, sact = cs.shade_pre(*pre_args)[4:]
    cast = sact > 0
    ana16 = pack.geom.ana16
    counts = (data.n_spheres, data.n_planes, data.n_cylinders)
    queries = (
        ("analytic_closest", (o, d, None, None),
         lambda: tr._closest_analytic(data, o, d, ana16),
         lambda: ca.closest_analytic(o, d, ana16, counts),
         lambda: tr._closest_analytic_plain(data, o, d)),
        ("analytic_anyhit", (so, sd, st, cast),
         lambda: (tr._analytic_occlusion(data, so, sd, st, cast, ana16),),
         lambda: ca.analytic_anyhit(so, sd, st, cast, ana16, counts),
         lambda: (cast & tr._analytic_occlusion_plain(
             data, so[:, :3], sd[:, :3], st),)))
    for name, (qo, qd, dist, cst), route, kernel, plain in queries:
        for a, b in zip(route(), plain()):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            n_bad = int((a != b).sum())
            check(n_bad == 0, f"{name}: differs from the plain version on "
                  f"{n_bad} rays")
        R = qo.shape[0]
        pairs = analytic_pairs(data, qo, qd, dist, cst)
        n_bytes = (R * (24 + (4 + 1 + 1 if dist is not None else 16))
                   + sum(counts) * 32)
        rep = dict(max_abs_err=0.0, ms=graph_ms(kernel),
                   plain_ms=time_ms(plain, 1), pairs=sum(pairs),
                   **bound(n_bytes, sum(p * k for p, k in zip(pairs,
                                                              OPS_ANA))))
        share = (f", casting {float(cst.float().mean()):.4f}"
                 if cst is not None else "")
        print(f"{name}: {R} rays x {sum(counts)} primitives{share}, "
              f"{sum(pairs)} pairs tested, equal to the plain version (t to "
              f"the bit); {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.1f} "
              f"ms; bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")
        rep.update(resources(name, ptxas), **sass_counts(name, sass))
        report[name] = rep


def compare_ana_segment(scenes, dev, report, ptxas, sass):
    """Phase 10, K10/K11: the fused shade segment on o_04's sphere and
    plane hits against its plain versions, on the first two segments of
    the recorded topology at golden resolution."""
    import torch

    from myraytracer_tpu_torch.kernels import library
    from myraytracer_tpu_torch.ops import shade
    from myraytracer_tpu_torch.ops import shade_grad_ana as sga
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    scene, data = scenes["o_04_molecule"]
    o, d = primary_rays_blocked(scene.camera, dev)
    with disable_graphs():
        topo = tr.trace_topology(data, o, d)
    geom = shade.pack_shade_geom(data)
    R, L = o.shape[0], data.n_lights
    counts = (data.n_spheres, data.n_planes)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    carry = (o, d, torch.ones(R, device=dev))
    # the fit cell's cotangents: the weight's, mat16's and the lights'
    cell = (False, False, True, False, True, True, True, True, True)
    for s in (0, 1):
        args = (*carry, geom.ana16, geom.mat16, *(
            getattr(topo, f)[s].contiguous()
            for f in ("kind", "idx", "hit", "miss", "shadow")),
            data.light_pos, data.light_color, data.ambience, data.background)
        fwd = sga.segment_ana_fwd(*args, counts)
        fwd_p = sga.segment_ana_plain(*args, counts)
        err = max(close(f"seg_ana_fwd[{s}].{nm}", a, b) for nm, a, b in
                  zip(("add", "o2", "d2", "w2"), fwd, fwd_p))
        n_bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                     for a, b in zip(fwd, fwd_p))
        cots = [torch.randn(sh, generator=gen, device=dev)
                for sh in ((R, 3), (R, 3), (R, 3), (R,))]
        bwd = sga.segment_ana_bwd(*args, counts, *cots)
        bwd_p = sga.segment_ana_bwd_plain(*args, counts, *cots)
        worst = {}
        for nm, a, b in zip(sga.BWD_OUTPUTS, bwd, bwd_p):
            check(tuple(a.shape) == tuple(b.shape)
                  and bool(torch.isfinite(a).all()),
                  f"seg_ana_bwd[{s}].{nm}: shape or not finite")
            bar = REL_GRAD if nm in ("ana16", "mat16") else REL_COT
            worst[nm] = round(close_scaled(f"seg_ana_bwd[{s}].{nm}", a, b,
                                           bar), 9)
        again = sga.segment_ana_bwd(*args, counts, *cots)
        check(all(torch.equal(a, b) for a, b in zip(bwd, again)),
              f"seg_ana_bwd[{s}]: two runs differ")
        part = sga.segment_ana_bwd(*args, counts, *cots, need=cell)
        check(all((a is None) if not n else torch.equal(a, b)
                  for a, b, n in zip(part, bwd, cell)),
              f"seg_ana_bwd[{s}]: the fit cell's cotangents differ from a "
              f"full run's")
        hits = int(args[7].sum())
        print(f"seg_ana[{s}]: o_04 {R} rays, {hits} hits, {L} lights: "
              f"forward max_abs_err={err}, {n_bits} values not equal to "
              f"the plain version's bits; backward worst diff per "
              f"cotangent in max|plain| {worst}; two runs equal to the "
              f"bit; the fit cell's cotangents equal to a full run's")
        if s == 0:
            arow, mid = sga._rows(args[3], args[5], args[6], counts)
            valid = args[5] != shade.KIND_MISS
            rows_b = (rows(args[3], arow[valid]) + rows(args[4], mid[valid]))
            ins = nbytes(*args[:3], *args[5:])
            ops = R * (OPS_SEG_RAY + L * OPS_SEG_LIGHT)
            report["seg_ana_fwd"] = dict(
                max_abs_err=err,
                ms=graph_ms(lambda: sga.segment_ana_fwd(*args, counts)),
                plain_ms=time_ms(lambda: sga.segment_ana_plain(*args,
                                                               counts), 3),
                **bound(ins + rows_b + nbytes(*fwd), ops))
            report["seg_ana_bwd"] = dict(
                max_abs_err=max(float((a - b).abs().max())
                                for a, b in zip(bwd, bwd_p)),
                ms=graph_ms(lambda: sga.segment_ana_bwd(*args, counts,
                                                        *cots)),
                cell_ms=graph_ms(lambda: sga.segment_ana_bwd(
                    *args, counts, *cots, need=cell)),
                plain_ms=time_ms(lambda: sga.segment_ana_bwd_plain(
                    *args, counts, *cots), 3),
                **bound(ins + rows_b + nbytes(*cots, *bwd),
                        BWD_OVER_FWD * ops))
            for k in ("seg_ana_fwd", "seg_ana_bwd"):
                rep = report[k]
                print(f"{k}: {rep['ms']:.4f} ms against a bound of "
                      f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}); plain "
                      f"{rep['plain_ms']:.2f} ms"
                      + (f"; with only the fit cell's cotangents "
                         f"{rep['cell_ms']:.4f} ms" if "cell_ms" in rep
                         else ""))
            report["seg_ana_fwd"].update(resources("seg_ana_fwd", ptxas),
                                         **sass_counts("seg_ana_fwd", sass))
            report["seg_ana_bwd"].update(
                resources("seg_ana_bwd", ptxas, library().mrt_seg_ana_bwd_smem(
                    L, geom.mat16.shape[0], geom.ana16.shape[0], 1, 1, 1)),
                **sass_counts("seg_ana_bwd", sass))
        carry = fwd[1:]


def timed(fn, reps: int = 3):
    """(result, seconds per call, launches of those calls) after one warm
    call; the counts are set to 0 just before the timed calls. The
    launches of the IF nodes' bodies that ran are added after each call,
    outside its time (graphs.count_bodies)."""
    import torch

    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops.graphs import count_bodies

    fn()
    torch.cuda.synchronize()
    count_bodies()
    reset_launches()
    secs = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        count_bodies()
    return out, secs, dict(LAUNCHES)


def gallery(scenes, dev, report):
    """Phase 11: every golden at its golden resolution through render_aa,
    against its plain-version run and the committed PNG; and the mixed
    scene at 1920x1080."""
    import numpy as np
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render_aa
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES
    from myraytracer_tpu_torch.utils.image import read_png

    for name, (_, budget) in list(GOLDEN_SCENES.items()) + [
            ("mixed_1080p", (None, 0.1))]:
        scene, data = scenes[name]
        cam = scene.camera
        torch.cuda.reset_peak_memory_stats()
        img, secs, launches = timed(
            lambda: render_aa(data, cam, budget_frac=budget))
        peak = torch.cuda.max_memory_allocated() / 2**30
        with disable_graphs():
            plain = render_aa(data, cam, budget_frac=budget,
                              cfg=tr.TraceConfig(plain=True))
        diff = (img - plain).abs().amax(dim=-1)
        agree = float((diff <= 1e-4).float().mean())
        img_np = img.cpu().numpy()
        line = (f"{name} {cam.width}x{cam.height} render_aa (budget "
                f"{budget}): median {statistics.median(secs):.4f} s of "
                f"{secs}, peak memory {peak:.3f} GiB, vs plain {agree:.6f} "
                f"within 1e-4")
        check(tuple(img.shape) == (cam.height, cam.width, 3),
              f"{name}: image shape {tuple(img.shape)}")
        check(bool(np.isfinite(img_np).all()), f"{name}: image not finite")
        check(agree >= GALLERY_AGREE, f"{name}: {agree} of pixels within 1e-4 "
              f"of the plain versions' image")
        png = os.path.join(REPO, "outputs", f"{name}.png")
        if os.path.exists(png):
            ref = read_png(png)
            cell = float(np.abs(cells(img_np) - cells(ref)).mean())
            pix = float((np.abs(img_np - ref).max(axis=-1)
                         <= PNG_PIX + 1e-6).mean())
            line += (f"; vs {os.path.relpath(png, REPO)}: mean 8x8 cell "
                     f"delta {cell:.3g}, {pix:.6f} of pixels within 2/255")
            check(cell < PNG_CELL_MEAN, f"{name}: cell delta {cell}")
            check(pix >= PNG_PIX_FRAC, f"{name}: {pix} of pixels within 2/255")
        else:
            check(name == "mixed_1080p", f"{png} is missing")
        print(line + f"; launches {launches}")
        path = FWD_KERNELS if data.n_tris else ("shade_pre", "shade_phong")
        for k in path:
            check(launches[k] > 0, f"{name}: {k} was not launched")
        analytic = bool(data.n_spheres or data.n_planes or data.n_cylinders)
        for k, _, _ in ANALYTIC_KERNELS:
            check((launches[k] > 0) == analytic,
                  f"{name}: {k} launched {launches[k]} times")
            if name == "o_04_molecule":
                report[k]["launches"] = launches[k]
        for entry, counter, _, _, scn in BRANCHES:
            if scn == name:
                report[entry]["launches"] = launches[counter]
        del img, plain


def office_aa(data, camera):
    """Phase 12: office 1920x1080 through render_aa, with the budget sized
    from the pass-1 image as the bench sizes it."""
    import torch

    from myraytracer_tpu_torch.ops.render import (aa_budget_covered, render,
                                                  render_aa, sized_aa_budget)

    img1 = render(data, camera)
    budget, frac = sized_aa_budget(img1)
    covered = aa_budget_covered(img1, budget)
    img, secs, launches = timed(
        lambda: render_aa(data, camera, budget_frac=budget))
    med = statistics.median(secs)
    print(f"render_aa {camera.width}x{camera.height}: above-threshold "
          f"fraction {frac:.4f} -> budget {budget}, aa_budget_covered "
          f"{covered}; median {med:.4f} s of {secs}, "
          f"{camera.width * camera.height / med:.4g} rays/s, launches "
          f"{launches}")
    check(covered, "the office AA budget does not cover its pixels")
    check(bool(torch.isfinite(img).all()), "office render_aa not finite")
    for k in FWD_KERNELS:
        check(launches[k] > 0, f"office render_aa: {k} was not launched")


def walk_bound(rays, work: dict) -> dict:
    """K7's bound from the work this run's data needs, as the plain walk
    counts it (``work``, its ``stats``): each ray's xyz origin and
    direction, t_max and active flag read once and t and idx written
    once; the distinct node rows (32 B), link rows (8 B) and triangles
    (three corners, 36 B) read; a slab test per node step and a slot
    solve per leaf slot."""
    n_bytes = (rays * (12 + 12 + 4 + 4 + 4 + 4) + work["nodes"] * 32
               + work["links"] * 8 + work["tris"] * 36)
    return bound(n_bytes, work["visits"] * OPS_SLAB + work["slots"] * OPS_TRI)


def issue_slots(ms: float, warp_steps: int) -> float:
    """Issue slots of the whole card per warp step in ``ms``: the SMs'
    four schedulers at the card's maximum SM clock (nvidia-smi), an upper
    bound on the instructions a warp issues per step."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ms * 1e-3 * hz * sms * 4 / max(warp_steps, 1)


def compare_walk(name, data, o, d, kw, ptxas, sass):
    """K7 vs its plain version on one query: ids equal, t equal (both
    without FMA contraction), times, bound, lanes busy and issue slots per
    warp step. Returns the kernel's TriHit and the summary entry."""
    import torch

    from myraytracer_tpu_torch.ops import traverse as trv

    hit = trv.traverse_bvh(data, o, d, **kw)
    work = {}
    hit_p = trv.traverse_bvh_plain(data, o, d, stats=work, **kw)
    n_bad = int((hit.idx != hit_p.idx).sum())
    check(n_bad == 0, f"{name}: ids differ from the plain walk on {n_bad} rays")
    both = hit.idx >= 0
    err = float((hit.t[both] - hit_p.t[both]).abs().max()) if bool(
        both.any()) else 0.0
    check(bool(torch.equal(hit.t, hit_p.t)), f"{name}: t differs, max {err}")
    rep = dict(max_abs_err=err,
               ms=graph_ms(lambda: trv.traverse_bvh(data, o, d, **kw)),
               plain_ms=time_ms(lambda: trv.traverse_bvh_plain(data, o, d,
                                                               **kw), 1),
               **walk_bound(o.shape[0], work))
    # the any-hit launch runs over the active rays packed in call order
    sfx = "_compact" if kw.get("any_hit") else ""
    busy, warp_steps = work["lanes_busy" + sfx], work["warp_steps" + sfx]
    rep.update(lanes_busy=busy, warp_steps=warp_steps,
               issue_slots_per_warp_step=issue_slots(rep["ms"], warp_steps))
    print(f"{name}: {o.shape[0]} rays, hits {float(both.float().mean()):.4f}, "
          f"ids equal, max_abs_err(t)={err}; {rep['ms']:.4f} ms vs plain "
          f"{rep['plain_ms']:.1f} ms; bound {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']}); work: {work['visits'] / o.shape[0]:.1f} "
          f"node steps and {work['slots'] / o.shape[0]:.2f} slot solves a "
          f"ray, {work['nodes']} nodes, {work['links']} links, "
          f"{work['tris']} triangles read; lanes busy {busy:.4f} (call "
          f"order {work['lanes_busy']:.4f}) over {warp_steps} warp steps, "
          f"{rep['issue_slots_per_warp_step']:.1f} issue slots a warp step")
    rep.update(resources(name, ptxas), **sass_counts(name, sass))
    return hit, rep


def compare_bvh_walk(data, camera, report, ptxas, sass):
    """Phase 13: K7 vs its plain version on the office 1080p primary rays
    and their shadow batch; K2 + K1 and K1' on the same rays."""
    import torch

    from myraytracer_tpu_torch.ops import cuda_cluster as cc
    from myraytracer_tpu_torch.ops import cuda_shade as cs
    from myraytracer_tpu_torch.ops import shade, tracer as tr
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    from myraytracer_tpu_torch import kernels
    from myraytracer_tpu_torch.ops import traverse as trv

    threads = kernels.library().mrt_bvh_walk_threads()
    check(threads == trv.WALK_BLOCK, f"K7 runs {threads} threads a block, "
          f"traverse.WALK_BLOCK says {trv.WALK_BLOCK}")
    cfg = tr.TraceConfig(tri_method="bvh")
    pack = tr.pack_trace(data, cfg)
    o, d = primary_rays_blocked(camera, data.device)
    R = o.shape[0]
    kw = dict(tri_flat=pack.tri_flat)
    hit, report["bvh_walk_closest"] = compare_walk(
        "bvh_walk_closest", data, o, d, kw, ptxas, sass)

    # the shadow batch K3 emits for the walk's hits
    live = torch.ones(R, dtype=torch.bool, device=o.device)
    kind, pidx, aidx, t = tr.closest_hit(data, pack, o, d, live, cfg)
    zero = torch.zeros_like(pidx)
    g = pack.geom
    pre = cs.shade_pre(o, d, t.contiguous(), kind, live.to(torch.int32),
                       torch.where(kind == shade.KIND_TRI, pidx,
                                   zero).contiguous(), zero, g.tri_pack,
                       g.ana16, g.mat16, data.light_pos, data.texels.shape[0])
    so, sd, st, sact = pre[4:]
    act = sact > 0
    akw = dict(kw, t_max=st, any_hit=True, active=act)
    occ, report["bvh_walk_anyhit"] = compare_walk(
        "bvh_walk_anyhit", data, so, sd, akw, ptxas, sass)

    # the yardstick: the cluster scan on the same rays
    cl_rows = cc.pack_cluster_rows(data)
    o4, d4, t0, act4 = cc.pad_rays(o, d, None, live)
    bb = cc.cluster_boxes(data)
    key = cc.phase1_exact(o4, d4, t0, act4, bb)
    order, lb, n = cc.visit_lists(key)
    scan = (o4, d4, t0, act4, bb, cl_rows, order, lb, n, data.cl_first,
            data.cl_count, False)
    k2 = graph_ms(lambda: cc.phase1_exact(o4, d4, t0, act4, bb))
    k1 = graph_ms(lambda: cc.cluster_scan(*scan))
    cl = cc.intersect_clusters(data, o, d, cl_rows=cl_rows)
    query = time_ms(lambda: cc.intersect_clusters(data, o, d,
                                                  cl_rows=cl_rows), 5)
    so4, sd4, st0, sact4 = cc.pad_rays(so, sd, st, act)
    hkey = cc.phase1_keys(data, so4, sd4, st0, sact4, True, True)
    hscan = (so4, sd4, st0, sact4, bb, cl_rows, *cc.visit_lists(hkey),
             data.cl_first, data.cl_count, True)
    k1a = graph_ms(lambda: cc.cluster_scan(*hscan))
    cl_occ = cc.intersect_clusters(data, so, sd, t_max=st, any_hit=True,
                                   active=act, cl_rows=cl_rows)
    qa = time_ms(lambda: cc.intersect_clusters(
        data, so, sd, t_max=st, any_hit=True, active=act,
        cl_rows=cl_rows), 5)
    id_agree = float((cl.idx == hit.idx).float().mean())
    occ_agree = float(((cl_occ.idx >= 0) == (occ.idx >= 0)).float().mean())
    check(id_agree >= ID_AGREE, f"K7 vs the cluster scan: ids agree on "
          f"{id_agree} of the primary rays")
    check(occ_agree >= ID_AGREE, f"K7 vs K1': occlusion agrees on {occ_agree}")
    yard = dict(k2_ms=k2, k1_ms=k1, cluster_query_ms=query, k1_anyhit_ms=k1a,
                cluster_anyhit_query_ms=qa, id_agreement=id_agree,
                occlusion_agreement=occ_agree)
    report["bvh_walk_closest"]["vs_cluster"] = yard
    print(f"K7 vs the cluster scan on the same rays: K7 closest "
          f"{report['bvh_walk_closest']['ms']:.4f} ms vs K2 {k2:.4f} + K1 "
          f"{k1:.4f} ms (whole cluster query {query:.4f} ms), ids agree on "
          f"{id_agree:.6f}; K7 any-hit "
          f"{report['bvh_walk_anyhit']['ms']:.4f} ms vs K1' {k1a:.4f} ms "
          f"(whole hull query {qa:.4f} ms), occlusion agrees on "
          f"{occ_agree:.6f}")


def bounce_queries(data, camera, cfg) -> list:
    """The listed triangle queries (segments 1..) of one eager ``render``
    of ``data``: (o, d, keyword arguments) of each, in call order."""
    from myraytracer_tpu_torch.ops import traverse as trv
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render

    got, orig = [], trv.traverse_bvh

    def spy(scene, o, d, **kw):
        if kw.get("listed"):
            got.append((o.clone(), d.clone(), dict(kw)))
        return orig(scene, o, d, **kw)
    trv.traverse_bvh = spy
    try:
        with disable_graphs():
            render(data, camera, cfg=cfg)
    finally:
        trv.traverse_bvh = orig
    return got


def compare_walk_list(scenes, report, ptxas, sass):
    """Phase 13, second part: KL and K7's listed launches on the rings'
    segment-1 queries at 700x500 against their plain versions, timed;
    KL's launches in one graphed render_aa of the rings."""
    import torch

    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops import traverse as trv
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import count_bodies
    from myraytracer_tpu_torch.ops.render import render_aa
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES

    scene, data = scenes["o_09_rings"]
    cam = scene.camera
    check((cam.width, cam.height, data.n_tris) == (700, 500, 8192),
          f"rings: {cam.width}x{cam.height}, {data.n_tris} triangles")
    cfg = tr.TraceConfig(tri_method="bvh")
    queries = bounce_queries(data, cam, cfg)
    check(len(queries) == 6, f"rings render: {len(queries)} listed queries")
    closest = next(q for q in queries if not q[2]["any_hit"])
    shadow = next(q for q in queries if q[2]["any_hit"])

    # KL on segment 1's closest query's mask
    active = closest[2]["active"]
    R = active.shape[0]
    check(R == 360_448, f"rings segment 1: {R} rays")
    ids, t_p, idx_p = trv.walk_list_plain(active)
    n = ids.numel()
    lst, n_list, t, idx = trv.walk_list(active)
    check(int(n_list) == n, f"bvh_walk_list: {int(n_list)} listed, plain {n}")
    check(bool(torch.equal(torch.sort(lst[:n].long()).values, ids)),
          "bvh_walk_list: the listed ids differ from the live rays")
    dead = ~active
    check(bool(torch.equal(t[dead], t_p[dead]))
          and bool(torch.equal(idx[dead], idx_p[dead])),
          "bvh_walk_list: the dead rays' misses differ")
    check(trv.list_workspace(active.device).tolist() == [0, 0],
          "bvh_walk_list: the workspace was not left zero")
    rep = dict(max_abs_err=0.0, rays=R, listed=n,
               ms=graph_ms(lambda: trv.walk_list(active)),
               cast_ms=graph_ms(lambda: active.to(torch.int32)),
               plain_ms=time_ms(lambda: trv.walk_list_plain(active), 3),
               **bound(R + 8 * (R - n) + 4 * n + 4, 0))
    print(f"bvh_walk_list: rings segment 1, {R} rays, {n} live, ids, count "
          f"and misses equal to the plain version; {rep['ms']:.4f} ms (the "
          f"int32 cast it replaces {rep['cast_ms']:.4f} ms) vs plain "
          f"{rep['plain_ms']:.3f} ms; bound {rep['bound_ms']:.4f} ms "
          f"({rep['bound_by']})")
    rep.update(resources("bvh_walk_list", ptxas),
               **sass_counts("bvh_walk_list", sass))

    # K7's listed launches: to the bit against the plain walk and against
    # K7 over the whole batch
    for name, (o, d, kw) in (("bvh_walk_closest", closest),
                             ("bvh_walk_anyhit", shadow)):
        kw = {k: v for k, v in kw.items() if k not in ("listed", "plain")}
        mask = kw["active"]
        got = trv.traverse_bvh(data, o, d, listed=True, **kw)
        whole = trv.traverse_bvh(data, o, d, **kw)
        work = {}
        want = trv.traverse_bvh_plain(data, o, d, stats=work, **kw)
        for what, ref in (("the plain walk", want), ("the whole batch", whole)):
            check(bool(torch.equal(got.idx, ref.idx))
                  and bool(torch.equal(got.t, ref.t)),
                  f"{name} listed: t or idx differ from {what}")
        live = int(mask.sum())
        t0 = (torch.full((o.shape[0],), trv.INF, device=o.device)
              if kw.get("t_max") is None
              else kw["t_max"].to(torch.float32).contiguous())
        walk = (o.contiguous(), d.contiguous(), t0, None,
                data.bvh_nodes_packed.contiguous(),
                data.bvh_links_packed.contiguous(), kw["tri_flat"],
                bool(kw.get("any_hit")))
        held = trv.walk_list(mask.contiguous())
        lrep = dict(rays=o.shape[0], live=live,
                    ms=graph_ms(lambda: trv.bvh_walk(*walk, held)),
                    with_list_ms=graph_ms(lambda: trv.traverse_bvh(
                        data, o, d, listed=True, **kw)),
                    whole_batch_ms=graph_ms(lambda: trv.traverse_bvh(
                        data, o, d, **kw)),
                    lanes_busy=work["lanes_busy_list"],
                    warp_steps=work["warp_steps_list"],
                    **walk_bound(live, work))
        report[name]["listed"] = lrep
        print(f"{name} listed: rings segment 1, {lrep['rays']} rays, {live} "
              f"live, t and idx equal to the plain walk and to K7 over the "
              f"whole batch; the walk {lrep['ms']:.4f} ms, with KL "
              f"{lrep['with_list_ms']:.4f} ms, over the whole batch "
              f"{lrep['whole_batch_ms']:.4f} ms; bound {lrep['bound_ms']:.4f}"
              f" ms ({lrep['bound_by']}); lanes busy "
              f"{lrep['lanes_busy']:.4f} over {lrep['warp_steps']} warp "
              f"steps in list order")

    # KL's launches in one graphed render_aa (IF-node bodies counted)
    budget = GOLDEN_SCENES["o_09_rings"][1]
    for _ in range(3):                    # warm-up, capture, replay
        render_aa(data, cam, budget_frac=budget, cfg=cfg)
    torch.cuda.synchronize()
    count_bodies()
    reset_launches()
    render_aa(data, cam, budget_frac=budget, cfg=cfg)
    torch.cuda.synchronize()
    count_bodies()
    rep["launches"] = LAUNCHES["bvh_walk_list"]
    check(rep["launches"] == 12, f"rings render_aa: {rep['launches']} "
          f"bvh_walk_list launches, not 12")
    print(f"bvh_walk_list: {rep['launches']} launches in one graphed rings "
          f"render_aa (K7 closest {LAUNCHES['bvh_walk_closest']}, any hit "
          f"{LAUNCHES['bvh_walk_anyhit']})")
    report["bvh_walk_list"] = rep


def loss_against_renders(data, camera, target, runs):
    """Each training loss of ``runs`` ((cfg, loss) pairs) against the sum
    of squares of its path's own unclamped render less ``target``, in
    float64: [(relative difference, that sum)], and the pixels where the
    renders of the first two paths differ by more than 1e-4."""
    import torch

    from myraytracer_tpu_torch.ops.render import render

    own, imgs = [], []
    with torch.no_grad():
        for cfg, loss in runs:
            img = render(data, camera, cfg=cfg, clamp=False)
            sse = float(((img.double() - target.double()) ** 2).sum())
            own.append((abs(float(loss) - sse) / sse, sse))
            imgs.append(img)
    diff_px = int(((imgs[0] - imgs[1]).abs().amax(dim=-1) > 1e-4).sum())
    return own, diff_px


def office_bvh(data, camera, report):
    """Phase 14: office 1080p through render, render_aa and the training
    step with tri_method="bvh", against the cluster path. The paths'
    topologies differ on a few rays (ties between triangles, walked in
    other orders), so the training losses are each held to their own
    path's render, and their gap to the gap of those renders."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import (render, render_aa,
                                                  render_loss_grad_image,
                                                  sized_aa_budget)

    cfg = tr.TraceConfig(tri_method="bvh")
    img_c = render(data, camera)
    budget, _ = sized_aa_budget(img_c)
    target = 0.9 * img_c + 0.02
    runs = (("render", lambda c: render(data, camera, cfg=c)),
            ("render_aa", lambda c: render_aa(data, camera,
                                               budget_frac=budget, cfg=c)),
            ("loss-grad", lambda c: render_loss_grad_image(
                data, camera, target, cfg=c)))
    for name, fn in runs:
        got, secs, launches = timed(lambda: fn(cfg))
        want = fn(tr.TraceConfig())
        for k in BVH_FWD_KERNELS:
            check(launches[k] > 0, f"bvh {name}: {k} was not launched")
        for k in CLUSTER_KERNELS:
            check(launches[k] == 0, f"bvh {name}: {k} was launched")
        if name == "render":
            for k, _, _ in BVH_KERNELS:
                report[k]["launches"] = launches[k]
        if name == "loss-grad":
            (loss, grads), (loss_c, grads_c) = got, want
            own, diff_px = loss_against_renders(
                data, camera, target,
                ((cfg, loss), (tr.TraceConfig(), loss_c)))
            for (rel_own, sse), path in zip(own, ("bvh", "cluster")):
                check(rel_own <= RTOL, f"bvh loss-grad: the {path} path's "
                      f"loss {rel_own} off the SSE of its own render")
            # the paths' losses differ by what their renders differ by:
            # the pixels whose topologies differ
            (_, sse), (_, sse_c) = own
            gap = float(loss) - float(loss_c)
            unexplained = abs(gap - (sse - sse_c)) / sse_c
            check(unexplained <= RTOL, f"bvh loss-grad: {unexplained} of "
                  f"the loss gap {gap} not in the renders' gap {sse - sse_c}")
            agree = 1.0 - diff_px / (camera.width * camera.height)
            check(agree >= GALLERY_AGREE, f"bvh loss-grad: {agree} of the "
                  f"unclamped renders' pixels within 1e-4")
            check(set(grads) == set(grads_c) and len(grads) == 23,
                  "bvh loss-grad: gradient keys")
            worst = max(close_scaled(f"bvh grad {k}", grads[k], grads_c[k],
                                     REL_GRAD)
                        for k in grads if grads[k].numel())
            rel = abs(gap) / abs(float(loss_c))
            what = (f"loss {float(loss)} vs cluster {float(loss_c)} (rel "
                    f"{rel:.3g}); each against the SSE of its own render: "
                    f"rel {own[0][0]:.3g}, {own[1][0]:.3g}; gap not in the "
                    f"renders' {unexplained:.3g}; {diff_px} pixels of the "
                    f"renders differ by more than 1e-4; worst gradient diff "
                    f"{worst:.3g} * max|a|")
        else:
            check(bool(torch.isfinite(got).all()), f"bvh {name}: not finite")
            agree = float(((got - want).abs().amax(dim=-1) <= 1e-4)
                          .float().mean())
            check(agree >= GALLERY_AGREE, f"bvh {name}: {agree} of pixels "
                  f"within 1e-4 of the cluster path's image")
            what = f"{agree:.6f} of pixels within 1e-4 of the cluster path's"
        med = statistics.median(secs)
        print(f"bvh {name} {camera.width}x{camera.height}"
              f"{f' (budget {budget})' if name == 'render_aa' else ''}: "
              f"median {med:.4f} s of {secs}, "
              f"{camera.width * camera.height / med:.4g} rays/s; {what}; "
              f"launches {launches}")


def gallery_bvh(scenes):
    """Phase 15: the goldens with triangles through render_aa with
    tri_method="bvh" at golden resolution, against the committed PNGs."""
    import numpy as np

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render_aa
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES
    from myraytracer_tpu_torch.utils.image import read_png

    cfg = tr.TraceConfig(tri_method="bvh")
    names = [n for n in GOLDEN_SCENES if scenes[n][1].n_tris]
    check(len(names) == 7, f"{len(names)} goldens with triangles")
    for name in names:
        scene, data = scenes[name]
        cam = scene.camera
        budget = GOLDEN_SCENES[name][1]
        img, secs, launches = timed(
            lambda: render_aa(data, cam, budget_frac=budget, cfg=cfg))
        img_np = img.cpu().numpy()
        ref = read_png(os.path.join(REPO, "outputs", f"{name}.png"))
        cell = float(np.abs(cells(img_np) - cells(ref)).mean())
        pix = float((np.abs(img_np - ref).max(axis=-1)
                     <= PNG_PIX + 1e-6).mean())
        print(f"bvh {name} {cam.width}x{cam.height} render_aa: median "
              f"{statistics.median(secs):.4f} s of {secs}; vs "
              f"outputs/{name}.png: mean 8x8 cell delta {cell:.3g}, "
              f"{pix:.6f} of pixels within 2/255; launches {launches}")
        check(bool(np.isfinite(img_np).all()), f"bvh {name}: not finite")
        check(cell < PNG_CELL_MEAN, f"bvh {name}: cell delta {cell}")
        check(pix >= PNG_PIX_FRAC, f"bvh {name}: {pix} of pixels within 2/255")
        for k in BVH_FWD_KERNELS:
            check(launches[k] > 0, f"bvh {name}: {k} was not launched")
        for k in CLUSTER_KERNELS:
            check(launches[k] == 0, f"bvh {name}: {k} was launched")


def train_goldens(scenes, report):
    """Phase 16: the training step on o_04 (spheres, planes; the K10/K11
    route) and o_10 (textured, bilinear fetch; the autograd replay) at
    golden resolution with "bvh"."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image

    for name, filt in TRAIN_GOLDENS:
        scene, data = scenes[name]
        cam = scene.camera
        cfg = tr.TraceConfig(tri_method="bvh", texture_filter=filt)
        route = cfg.replay_route(data)
        check(route == ("fused_ana" if name == "o_04_molecule"
                        else "autograd"), f"{name}: takes the {route} route")
        target = 0.9 * render(data, cam, cfg=cfg) + 0.02
        (loss, grads), secs, launches = timed(
            lambda: render_loss_grad_image(data, cam, target, cfg=cfg))
        ana = route == "fused_ana"
        check(all((launches[k] > 0) == ana
                  for k in ("seg_ana_fwd", "seg_ana_bwd"))
              and launches["seg_fwd"] == launches["seg_bwd"] == 0,
              f"{name}: launches {launches} on the {route} route")
        if ana:
            for k in ("seg_ana_fwd", "seg_ana_bwd"):
                report[k]["launches"] = launches[k]
        check(bool(torch.isfinite(loss)), f"{name}: loss {float(loss)}")
        check(len(grads) == 23, f"{name}: {len(grads)} gradient keys")
        for k, g in grads.items():
            check(bool(torch.isfinite(g).all()), f"{name}: gradient {k} "
                  f"is not finite")
        moved = sorted(k for k, g in grads.items()
                       if g.numel() and float(g.abs().max()) > 0)
        losses = train_steps(data, cam, cfg=cfg)
        print(f"train {name} {cam.width}x{cam.height} ({filt}): median "
              f"{statistics.median(secs):.4f} s of {secs}, loss "
              f"{float(loss)}, nonzero gradients {moved}; Adam losses "
              f"{losses}; launches {launches}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall: "
              f"{losses}")


def check_path(what: str, launches: dict, kernels) -> None:
    """The kernels of a "bvh" path were launched, the cluster scan's not."""
    for k in kernels:
        check(launches[k] > 0, f"{what}: {k} was not launched")
    for k in CLUSTER_KERNELS:
        check(launches[k] == 0, f"{what}: {k} was launched")


def cli_render(dev):
    """Phase 17: the CLI's render verb, in process: examples/demo.sce (a
    sphere, a cylinder, a mesh, a mirror floor at depth 3) with and
    without --aa, and --golden o_08_office. Each PNG against render or
    render_aa called directly with "auto"; demo.sce's kernel render
    against its plain-version render."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from myraytracer_tpu_torch import cli
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.models.sceneio import read_scene
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render, render_aa
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES
    from myraytracer_tpu_torch.utils.image import read_png, to_uint8

    demo = os.path.join(REPO, "examples", "demo.sce")
    auto = tr.TraceConfig(tri_method="auto")
    runs = (("demo.sce", ["--scene", demo], lambda: read_scene(demo), render),
            ("demo.sce --aa", ["--scene", demo, "--aa"],
             lambda: read_scene(demo), render_aa),
            ("o_08_office", ["--golden", "o_08_office"],
             GOLDEN_SCENES["o_08_office"][0], render))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.png")
        for name, args, make, fn in runs:
            torch.cuda.synchronize()
            reset_launches()
            said = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = cli.main(["render", *args, "--out", out])
            secs = time.perf_counter() - t
            launches = dict(LAUNCHES)
            check(rc == 0, f"cli render {name}: exit code {rc}")
            build = re.search(r"build ([0-9.]+)s", said.getvalue())
            check(build is not None, f"cli render {name}: no build seconds "
                  f"in {said.getvalue()!r}")
            png = read_png(out)
            sc = make()
            data = sc.build(device=dev)
            direct = fn(data, sc.camera, cfg=auto)
            want = to_uint8(direct.cpu().numpy()) / np.float32(255)
            same = float((np.abs(png - want).max(axis=-1)
                          <= 1 / 255 + 1e-6).mean())
            line = (f"cli render {name} {sc.camera.width}x{sc.camera.height}: "
                    f"{secs:.3f} s (build, render, PNG), its build (native "
                    f"BVH) {build.group(1)} s; {same:.6f} of pixels "
                    f"within 1/255 of {fn.__name__} called directly")
            check(png.shape == (sc.camera.height, sc.camera.width, 3),
                  f"cli render {name}: PNG shape {png.shape}")
            check(same >= GALLERY_AGREE, f"cli render {name}: {same} of "
                  f"pixels within 1/255 of the direct call")
            check_path(f"cli render {name}", launches, BVH_FWD_KERNELS)
            if fn is render and name.startswith("demo"):
                with disable_graphs():
                    plain = render(data, sc.camera,
                                   cfg=auto._replace(plain=True))
                agree = float(((direct - plain).abs().amax(dim=-1) <= 1e-4)
                              .float().mean())
                check(agree >= GALLERY_AGREE, f"cli render {name}: {agree} "
                      f"of pixels within 1e-4 of the plain versions' image")
                line += f"; kernels vs plain {agree:.6f} within 1e-4"
            print(line + f"; launches {launches}")


def fit_office(data, camera):
    """Phase 18: InverseRenderer.fit_pixels on office at 1920x1080 over
    every pixel (raster order, "auto"): five Adam steps on mat_diffuse
    and light_color toward the render with mat_diffuse * 0.8, three on
    cam_eye from a moved eye, and a checkpoint saved, restored into a new
    renderer and stepped once more."""
    import dataclasses
    import tempfile

    import torch

    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render

    auto = tr.TraceConfig(tri_method="auto")
    xs, ys = (g.reshape(-1) for g in camera.pixel_grid(data.device))
    dark = render(dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.8),
                  camera, cfg=auto).reshape(-1, 3)
    names = ("mat_diffuse", "light_color")

    def steps(inv, target, n):
        """n single steps: (losses, seconds of each, launches of all)."""
        torch.cuda.synchronize()
        reset_launches()
        losses, secs = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses += inv.fit_pixels(xs, ys, target, steps=1).losses
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return losses, secs, dict(LAUNCHES)

    def finite(inv):
        return all(bool(torch.isfinite(v).all()) for v in inv.params.values())

    inv = InverseRenderer(data, names, optimizer=adam(0.02), camera=camera)
    losses, secs, launches = steps(inv, dark, 5)
    print(f"fit {','.join(names)} {camera.width}x{camera.height}: losses "
          f"{losses}; median step {statistics.median(secs):.4f} s of {secs}; "
          f"launches {launches}")
    check(all(map(math.isfinite, losses)) and finite(inv),
          "fit: a loss or parameter is not finite")
    check(losses[-1] < losses[0], f"fit: the loss did not fall: {losses}")
    check_path("fit", launches, BVH_FWD_KERNELS + ("seg_fwd", "seg_bwd"))

    with tempfile.TemporaryDirectory() as tmp:
        inv.save_checkpoint(tmp)
        again = InverseRenderer(data, names, optimizer=adam(0.02),
                                camera=camera)
        again.restore_checkpoint(tmp)
    check(again.step_count == 5 and all(
        torch.equal(again.params[k], inv.params[k]) for k in names),
        "fit: the restored checkpoint differs")
    more, _, _ = steps(again, dark, 1)
    check(math.isfinite(more[0]) and more[0] < losses[0],
          f"fit: the step after the restore gave {more}")

    true = render(data, camera, cfg=auto).reshape(-1, 3)
    moved = dataclasses.replace(
        camera, eye=camera.eye + torch.tensor([0.05, -0.03, 0.02]))
    cam_inv = InverseRenderer(data, ("cam_eye",), optimizer=adam(0.01),
                              camera=moved)
    cam_losses, cam_secs, cam_launches = steps(cam_inv, true, 3)
    eye = cam_inv.fitted_camera().eye.cpu()
    print(f"fit cam_eye {camera.width}x{camera.height}: losses {cam_losses}; "
          f"eye {moved.eye.tolist()} -> {eye.tolist()}; median step "
          f"{statistics.median(cam_secs):.4f} s of {cam_secs}; resumed fit "
          f"step loss {more[0]}; launches {cam_launches}")
    check(all(map(math.isfinite, cam_losses)) and finite(cam_inv),
          "fit cam_eye: a loss or the eye is not finite")
    check(not torch.equal(eye, moved.eye.cpu()), "fit cam_eye: eye unmoved")
    check_path("fit cam_eye", cam_launches,
               BVH_FWD_KERNELS + ("seg_fwd", "seg_bwd"))


def bench_office():
    """Phase 19: the port's bench at 1920x1080, office tess 10, in
    process; its JSON lines printed with a "bench: " prefix."""
    import io

    import torch

    from myraytracer_tpu_torch import bench
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.utils.profiling import gpu_line

    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    rc = bench.main(["--res", "1920x1080", "--tess", "10"], out=out)
    secs = time.perf_counter() - t
    launches = dict(LAUNCHES)
    lines = out.getvalue().splitlines()
    for line in lines:
        print("bench: " + line)
    check(rc == 0 and lines, f"bench: exit code {rc}, {len(lines)} lines")
    last = json.loads(lines[-1])
    print(f"bench: {len(lines)} lines in {secs:.2f} s; scene_build_s "
          f"{last['scene_build_s']} (native BVH); launches {launches}")
    missing = set(bench.KEYS) - set(last)
    check(not missing, f"bench: the last line lacks {sorted(missing)}")
    check(last["stage"] == "fwd_bwd", f"bench: stage {last['stage']}")
    check(last["resolution"] == "1920x1080" and last["n_tris"] == 18664,
          f"bench: {last['resolution']}, {last['n_tris']} triangles")
    check(last["aa_budget_covered"] is True and last["loss_finite"] is True,
          "bench: AA budget not covering, or a loss not finite")
    check(last["device"] == gpu_line() and
          torch.cuda.get_device_name(0) in last["device"],
          f"bench: device {last['device']!r}")
    check(all(math.isfinite(v) and v > 0 for k, v in last.items()
              if isinstance(v, float)), "bench: a time or rate is not > 0")
    check_path("bench", launches, BVH_FWD_KERNELS + ("seg_fwd", "seg_bwd"))


def suite_checks(what: str, got: dict, want: dict, bit_equal: bool) -> str:
    """Phase 20: one sharded run_suite result against the single-device
    one; returns its line of agreement."""
    import torch

    agree = {}
    for k in ("img", "img_aa"):
        agree[k] = float(((got[k] - want[k]).abs().amax(dim=-1) <= 1e-4)
                         .float().mean())
        check(agree[k] >= GALLERY_AGREE, f"{what} {k}: {agree[k]} of pixels "
              "within 1e-4 of the single device's")
        if bit_equal:
            check(torch.equal(got[k], want[k]),
                  f"{what} {k}: not equal to the single device's")
    rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    check(rel_loss <= 1e-5, f"{what}: loss {got['loss']} vs {want['loss']}")
    check(got["n_total"] == want["n_total"], f"{what}: n_total")
    worst = 0.0
    for k, g in want["grads"].items():
        if g.numel():
            ratio = float((got["grads"][k] - g).abs().max()) / max(
                float(g.abs().max()), 1e-30)
            worst = max(worst, ratio)
            check(ratio <= REL_GRAD, f"{what}: gradient {k} off by {ratio} "
                  "x max|single|")
    fit_rel = max(abs(a - b) / abs(b) for a, b in
                  zip(got["fit_losses"], want["fit_losses"]))
    check(fit_rel <= 1e-5 and len(got["fit_losses"]) == len(
        want["fit_losses"]), f"{what}: fit losses {got['fit_losses']} vs "
        f"{want['fit_losses']}")
    check(got["fit_losses"][-1] < got["fit_losses"][0],
          f"{what}: the fit's loss did not fall: {got['fit_losses']}")
    return (f"image agreement {agree['img']:.6f}, AA {agree['img_aa']:.6f}"
            f"{' (bit-equal)' if bit_equal else ''}; loss {got['loss']!r} "
            f"(rel {rel_loss:.3g}); gradients within {worst:.3g} x "
            f"max|single|; fit losses {got['fit_losses']} (rel {fit_rel:.3g})")


def launched(launches: dict) -> dict:
    """Phase 20's launch counts per part, without the kernels at 0."""
    return {part: {k: v for k, v in counts.items() if v}
            for part, counts in launches.items()}


def suite_launches(what: str, launches: dict) -> None:
    """Phase 20: the kernels of each part of a sharded run were launched."""
    for part in ("render", "render_aa"):
        for k in FWD_KERNELS:
            check(launches[part][k] > 0, f"{what} {part}: {k} not launched")
    for k in CLUSTER_KERNELS + ("shade_pre", "seg_fwd", "seg_bwd"):
        check(launches["train_step"][k] > 0,
              f"{what} train_step: {k} not launched")
    check_path(f"{what} fit", launches["fit"],
               BVH_FWD_KERNELS + ("seg_fwd", "seg_bwd"))


def same_step(what, grads, n_total: float, lr: float):
    """The sharded SGD step graphed against eager, on (scene' or its
    parameters, loss) pairs: the loss within
    GRAPH_LOSS_RTOL, and every parameter after the step within
    lr / n_total x REL_GRAD x max|g| of the eager step's plus one ulp of
    its value, where g is the eager gradient (``grads``): the gradient
    bar carried through p - lr g / n_total, whose result is rounded to
    fp32. Returns the comparator."""
    import torch

    from myraytracer_tpu_torch.parallel.shard_render import split_params

    def params(x):
        return x if isinstance(x, dict) else split_params(x)

    def compare(got, want):
        (a_new, a_loss), (b_new, b_loss) = got, want
        rel = abs(float(a_loss) - float(b_loss)) / abs(float(b_loss))
        check(rel <= GRAPH_LOSS_RTOL, f"{what}: loss rel diff {rel}")
        a_p, b_p = params(a_new), params(b_new)
        worst = 0.0
        for k, b in b_p.items():
            if not b.numel():
                continue
            a, b, g = a_p[k].cpu(), b.cpu(), grads[k].cpu()
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                  f"{what}: parameter {k} not finite")
            bar = lr / n_total * REL_GRAD * max(float(g.abs().max()), 1e-30)
            ulp = (torch.nextafter(b, torch.full_like(b, math.inf)) - b).abs()
            ratio = float(((a - b).abs() - ulp).clamp(min=0).max()) / bar
            check(ratio <= 1.0, f"{what}: parameter {k} off by {ratio} x its "
                  f"bar (lr / n_total x REL_GRAD x max|g|, plus one ulp)")
            worst = max(worst, ratio)
        return (f"loss {float(a_loss)} vs eager {float(b_loss)} (rel "
                f"{rel:.3g}), parameters after the step within {worst:.3g} x "
                f"the gradient bar")
    return compare


def ws1_graph_calls(fit_steps: int) -> dict:
    """Phase 20: the graph calls (warm-ups, captures, replays) due in the
    third call of each run_suite part at world size 1 over NCCL: a
    replay, of pass 1 and the refine for render_aa; for a fit of
    ``fit_steps`` steps from a new renderer, two warm-ups (without and
    with the optimizer's state), the capture and its replay, then
    replays."""
    return {"render": (0, 0, 1), "render_aa": (0, 0, 2),
            "train_step": (0, 0, 1), "fit": (2, 1, fit_steps - 2)}


def calls_of(moved: dict) -> tuple:
    """(warm-ups, captures, replays) of a graphs.COUNTS difference."""
    return moved["warm_ups"], moved["captures"], moved["replays"]


def sharded_fit_checkpoint(case, mesh, steps: int = 5, save_after: int = 4):
    """Phase 20: InverseRenderer(mesh=...) on the suite's fit, ``steps``
    single steps graphed, with a checkpoint saved (a barrier on the
    group, eagerly, between replays) after step ``save_after``, against
    the same steps eager; the checkpoint restored into a new renderer."""
    import tempfile

    import torch

    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.parallel import dryrun

    def renderer():
        return InverseRenderer(case.fit_start, case.fit_names,
                               optimizer=adam(dryrun.FIT_LR), mesh=mesh)

    def one(inv):
        return inv.fit(case.fit_o, case.fit_d, case.fit_target,
                       steps=1).losses[0]

    with graphs.disable_graphs():
        inv = renderer()
        eager = [one(inv) for _ in range(steps)]
    inv, losses, calls = renderer(), [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(steps):
            before = dict(graphs.COUNTS)
            losses.append(one(inv))
            calls.append(calls_of({k: graphs.COUNTS[k] - before[k]
                                   for k in before}))
            if i + 1 == save_after:
                inv.save_checkpoint(tmp)
                saved = {k: v.detach().clone() for k, v in inv.params.items()}
        again = renderer()
        again.restore_checkpoint(tmp)
    want = [(1, 0, 0), (1, 0, 0), (0, 1, 1)] + [(0, 0, 1)] * (steps - 3)
    check(calls == want, f"sharded fit: graph calls (warm-ups, captures, "
          f"replays) per step {calls}, where {want} were due")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    check(rel <= GRAPH_FIT_RTOL, f"sharded fit: losses graphed {losses}, "
          f"eager {eager}")
    check(losses[-1] < losses[0], f"sharded fit: the loss did not fall")
    check(again.step_count == save_after and all(
        torch.equal(again.params[k], v) for k, v in saved.items()),
        "sharded fit: the checkpoint saved between replays differs")
    print(f"sharded: world size 1 (NCCL) fit, {steps} single steps with a "
          f"checkpoint saved after step {save_after}: graph calls per step "
          f"{calls}; losses graphed {losses}, eager {eager} (rel "
          f"{rel:.3g}); the checkpoint restored equal")


def sharded_graphs(dev, case, mesh, ws1: dict, eager: dict) -> dict:
    """Phase 20 at world size 1 over NCCL: run_suite graphed (third call)
    against eager (disable_graphs), each part in turns, o_04's sharded
    render_aa and step with their IF nodes, and the fit with a
    checkpoint between replayed steps. Returns the timings in turns."""
    import torch

    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render
    from myraytracer_tpu_torch.parallel import dryrun
    from myraytracer_tpu_torch.parallel import shard_render as sr
    from myraytracer_tpu_torch.parallel.distributed import replicate_global
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES

    what = "world size 1 (NCCL)"
    want = ws1_graph_calls(case.fit_steps)
    for part, due in want.items():
        got = calls_of(ws1["graph_calls"][part])
        check(got == due, f"{what} {part}: the third call's graph calls "
              f"(warm-ups, captures, replays) {got}, where {due} were due")
        check(not any(eager["graph_calls"][part].values()),
              f"{what} {part}: an eager call used a graph")
        check(ws1["launches"][part] == eager["launches"][part],
              f"{what} {part}: launches graphed {launched(ws1['launches'])}"
              f", eager {launched(eager['launches'])}")
    for k in ("img", "img_aa"):
        check(torch.equal(ws1[k], eager[k]), f"{what} {k}: graphed differs "
              f"from eager by {float((ws1[k] - eager[k]).abs().max())}")
    n_total, lr = eager["n_total"], dryrun.SUITE_LR
    step_line = same_step(f"{what} train_step", eager["grads"], n_total, lr)(
        (ws1["params"], ws1["loss"]), (eager["params"], eager["loss"]))
    fit_rel = max(abs(a - b) / abs(b) for a, b in
                  zip(ws1["fit_losses"], eager["fit_losses"]))
    check(fit_rel <= GRAPH_FIT_RTOL, f"{what} fit: losses graphed "
          f"{ws1['fit_losses']}, eager {eager['fit_losses']}")
    secs = {p: f"{ws1['seconds'][p]:.4f} (eager {eager['seconds'][p]:.4f})"
            for p in ws1["seconds"]}
    print(f"sharded: {what} graphed against eager, third calls: images "
          f"bit-equal; train_step {step_line}; fit losses rel {fit_rel:.3g};"
          f" launches equal; graph calls {ws1['graph_calls']}; seconds "
          f"{secs}")
    sharded_fit_checkpoint(case, mesh)

    scene, cam = replicate_global(mesh, case.scene), case.camera
    batch = dryrun.step_batch(cam, case.target_img, mesh)
    step = sr.make_train_step(mesh, lr=lr)
    turns = {
        "render": graphed_vs_eager(
            f"{what} office render_sharded",
            lambda: sr.render_sharded(scene, cam, mesh),
            same_image(f"{what} render_sharded"), False),
        "render_aa": graphed_vs_eager(
            f"{what} office render_aa_sharded (budget {case.budget_frac})",
            lambda: sr.render_aa_sharded(scene, cam, mesh,
                                         budget_frac=case.budget_frac),
            same_image(f"{what} render_aa_sharded"), False),
        "train_step": graphed_vs_eager(
            f"{what} office sharded SGD step", lambda: step(scene, *batch),
            same_step(f"{what} sharded SGD step", eager["grads"], n_total,
                      lr), False)}

    builder, budget = GOLDEN_SCENES["o_04_molecule"]
    sc = builder()
    data, ocam = replicate_global(mesh, sc.build(device=dev)), sc.camera
    where = f"{what} o_04_molecule {ocam.width}x{ocam.height}"
    r = turns["o_04_render_aa"] = graphed_vs_eager(
        f"{where} render_aa_sharded (budget {budget})",
        lambda: sr.render_aa_sharded(data, ocam, mesh, budget_frac=budget),
        same_image(f"{where} render_aa_sharded"), True, GOLDEN_PAIRS,
        skips=True)
    check(r["if_nodes"] == 4 and r["bodies_skipped"] == 2,
          f"{where} render_aa_sharded: {r['if_nodes']} IF nodes, "
          f"{r['bodies_skipped']} skipped per replay, where 4 and 2 were due")
    cfg = tr.TraceConfig(tri_method="bvh")
    obatch = dryrun.step_batch(ocam, 0.9 * render(data, ocam, cfg=cfg) + 0.02,
                               mesh)
    with graphs.disable_graphs():
        _, ograds, on = sr.loss_grad_sharded(data, *obatch, mesh, cfg)
    ostep = sr.make_train_step(mesh, cfg, lr=lr)
    r = turns["o_04_step"] = graphed_vs_eager(
        f"{where} sharded SGD step (bvh)", lambda: ostep(data, *obatch),
        same_step(f"{where} sharded SGD step", ograds, float(on), lr), True,
        GOLDEN_PAIRS, skips=True)
    check(r["if_nodes"] == 6 and r["bodies_skipped"] == 3,
          f"{where} sharded step: {r['if_nodes']} IF nodes, "
          f"{r['bodies_skipped']} skipped per replay, where 6 and 3 were due")
    sites = graphs.body_sites("train_step_sharded")
    print(f"sharded: {where} sharded step: bodies skipped per replay "
          f"{[site for site, ran in sites if not ran]}")
    for name, t in turns.items():
        print(f"sharded: {what} {name} in turns: eager median "
              f"{t['eager_ms']:.3f} ms, graphed median {t['graphed_ms']:.3f} "
              f"ms (graphed faster in {t['wins']} of {t['pairs']} pairs, "
              f"graphed/eager at most {t['max_ratio']:.3f})")
    return turns


def sharded_office(dev, tess: int = 10, full=(1920, 1080)):
    """Phase 20: the sharded render, AA, training step and fit on office
    at 1920x1080: on one device, at world size 1 over NCCL in process
    (graphed and eager, sharded_graphs), and at world size 2 over gloo
    on cuda:0 (parallel/dryrun.spawn), each part three times, the third
    timed."""
    import torch
    import torch.distributed as dist

    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops.render import render, sized_aa_budget
    from myraytracer_tpu_torch.parallel import dryrun
    from myraytracer_tpu_torch.parallel.mesh import backend_for, make_mesh

    kind = torch.device(dev).type

    t = time.perf_counter()
    kw = dict(scene="office",
              scene_kw=dict(tess=tess, width=full[0], height=full[1]),
              fit_steps=3)
    case = dryrun.suite_case(device=dev, **kw)
    kw["budget_frac"], _ = sized_aa_budget(render(case.scene, case.camera))
    case.budget_frac = kw["budget_frac"]
    print(f"sharded: office tess {tess} {full[0]}x{full[1]} built in "
          f"{time.perf_counter() - t:.2f} s; AA budget {kw['budget_frac']}")
    one = dryrun.run_suite(case, None, reps=3)

    t = time.perf_counter()
    mesh = make_mesh(1, dev)
    try:
        check(dist.get_backend() == backend_for(kind) == "nccl",
              f"world size 1: backend {dist.get_backend()}")
        ws1 = dryrun.run_suite(case, mesh, reps=3)
        with graphs.disable_graphs():
            ws1_eager = dryrun.run_suite(case, mesh, reps=3)
        ws1_secs = time.perf_counter() - t
        turns = sharded_graphs(dev, case, mesh, ws1, ws1_eager)
    finally:
        # a captured graph holds the group's communicator: drop it first
        graphs.clear()
        dist.destroy_process_group()
    del case
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dryrun.spawn("suite", 2, dict(kw, reps=3), device=kind,
                         backend="gloo", deadline_s=300)
    ws2_secs = time.perf_counter() - t

    secs = {part: f"{one['seconds'][part]:.4f}" for part in one["seconds"]}
    print(f"sharded: single device (third calls, graphed): seconds {secs}; "
          f"loss {one['loss']!r}; fit losses {one['fit_losses']}")
    suite_launches("world size 1 (NCCL)", ws1["launches"])
    line = suite_checks("world size 1 (NCCL)", ws1, one, bit_equal=True)
    secs = {p: f"{ws1['seconds'][p]:.4f} (single {one['seconds'][p]:.4f}, "
               f"x{ws1['seconds'][p] / one['seconds'][p]:.3f})"
            for p in one["seconds"]}
    print(f"sharded: world size 1 (NCCL, {ws1_secs:.2f} s for the graphed "
          f"and eager suites): third calls graphed, seconds {secs}; {line}; "
          f"launches {launched(ws1['launches'])}")
    for r, got in enumerate(ranks):
        what = f"world size 2 (gloo, cuda:0) rank {r}"
        suite_launches(what, got["launches"])
        check(all(not any(c.values()) for c in got["graph_calls"].values()),
              f"{what}: graph calls over gloo {got['graph_calls']}")
        line = suite_checks(what, got, one, bit_equal=False)
        secs = {p: f"{got['seconds'][p]:.4f} (single "
                   f"{one['seconds'][p]:.4f})" for p in one["seconds"]}
        print(f"sharded: {what} ({ws2_secs:.2f} s for both ranks, spawn "
              f"included): eager by rule, no graph warmed up, captured or "
              f"replayed; third calls, seconds {secs}; {line}; launches "
              f"{launched(got['launches'])}")
        check(got["mesh_error"] == "need 3 devices, have 2",
              f"{what}: make_mesh(3) gave {got.get('mesh_error')!r}")
        check((got["replicate_error"] is None) == (r == 0),
              f"{what}: replicate_global of a different tensor on every "
              f"rank gave {got['replicate_error']!r}")
    alone = ranks[0]["img_ws1"]
    agree = float(((alone - one["img"]).abs().amax(dim=-1) <= 1e-4)
                  .float().mean())
    check(agree >= GALLERY_AGREE, f"world size 2: the render on a mesh of "
          f"rank 0 alone: {agree} within 1e-4")
    print(f"sharded: world size 2, rank 0's render on a mesh of itself: "
          f"{agree:.6f} of pixels within 1e-4 of the single device's, "
          f"bit-equal {torch.equal(alone, one['img'])}; dryrun step loss "
          f"{ranks[0]['dryrun_loss']!r}")
    print("sharded summary: " + json.dumps({
        "single": one["seconds"], "ws1_graphed": ws1["seconds"],
        "ws1_eager": ws1_eager["seconds"],
        "ws1_turns": {k: {m: v[m] for m in ("eager_ms", "graphed_ms", "wins",
                                            "pairs", "if_nodes",
                                            "bodies_skipped")}
                      for k, v in turns.items()},
        "ws2": [got["seconds"] for got in ranks]}))


def native_builder(dev, tesses=(10, 28), small=(480, 270)):
    """Phase 21: the native BVH builder against NumPy on office: BVH and
    Scene.build seconds, equal arrays, a render of each build, the
    builder that Scene.build's default takes on this host (native where
    g++ is found); on the tess-28 scene, the cluster scan (K2 + K1)
    against the walk (K7) on the primary rays."""
    import shutil

    import torch

    from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS
    from myraytracer_tpu_torch.ops import bvh
    from myraytracer_tpu_torch.ops.render import render
    from myraytracer_tpu_torch.runtime import native
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    t = time.perf_counter()
    native.build()
    print(f"native: g++ build {time.perf_counter() - t:.2f} s")
    gxx = shutil.which("g++")
    check(native.available() and gxx is not None,
          "native: no g++ on this host: Scene.build's default would build "
          "with NumPy")
    print(f"native: Scene.build's default builder on this host: native "
          f"(g++ at {gxx})")
    real, real_native = bvh.build_bvh, native.build_bvh_native
    bvh_secs, native_calls = [], []

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        bvh_secs.append(time.perf_counter() - t0)
        return out

    def counted(*args, **kw):
        native_calls.append(1)
        return real_native(*args, **kw)

    bvh.build_bvh, native.build_bvh_native = timed_build, counted
    try:
        for tess in tesses:
            sc = scene_08_office(tess=tess, resolution=small)
            built = {}
            for how, flag in (("numpy", False), ("native", True),
                              ("default", None)):
                bvh_secs.clear()
                native_calls.clear()
                t = time.perf_counter()
                data = sc.build(device=dev, native=flag)
                built[how] = (data, time.perf_counter() - t, bvh_secs[0],
                              len(native_calls))
            a, b = built["numpy"][0], built["native"][0]
            check(built["numpy"][3] == 0 and built["native"][3] == 1
                  and built["default"][3] == 1, f"native tess {tess}: the "
                  f"native builder ran {built['numpy'][3]}, "
                  f"{built['native'][3]}, {built['default'][3]} times for "
                  f"NumPy, native, the default")
            check(a.n_tris == b.n_tris and a.n_nodes == b.n_nodes,
                  f"native tess {tess}: {b.n_tris} triangles, {b.n_nodes} "
                  f"nodes vs {a.n_tris}, {a.n_nodes}")
            differ = [f for f in ARRAY_FIELDS
                      if not torch.equal(getattr(a, f), getattr(b, f))]
            default = built["default"][0]
            check(all(torch.equal(getattr(default, f), getattr(b, f))
                      for f in ARRAY_FIELDS), f"native tess {tess}: the "
                  "default build differs from the native build")
            img_a, img_b = render(a, sc.camera), render(b, sc.camera)
            agree = float(((img_a - img_b).abs().amax(dim=-1) <= 1e-4)
                          .float().mean())
            print(f"native: office tess {tess} ({a.n_tris} triangles, "
                  f"{a.n_nodes} nodes, {a.cl_first.shape[0]} clusters): BVH "
                  f"{built['numpy'][2]:.3f} s NumPy, "
                  f"{built['native'][2]:.3f} s native, "
                  f"{built['default'][2]:.3f} s default; Scene.build "
                  f"{built['numpy'][1]:.3f} s NumPy, {built['native'][1]:.3f}"
                  f" s native, {built['default'][1]:.3f} s default (native);"
                  f" arrays that differ: {differ or 'none'}; "
                  f"{small[0]}x{small[1]} render {agree:.6f} of pixels "
                  f"within 1e-4")
            check(agree >= GALLERY_AGREE, f"native tess {tess}: {agree} of "
                  "pixels within 1e-4 of the NumPy build's render")
            if tess == max(tesses):
                scan_vs_walk(default, sc.camera, tess)
    finally:
        bvh.build_bvh, native.build_bvh_native = real, real_native


def scan_vs_walk(data, camera, tess: int) -> None:
    """Phase 21: the cluster scan (K2 + K1) against the walk (K7) on the
    primary rays of a large scene (tests/test_torch_large_scene.py's
    check on the card): hit masks and ids agree on >= ID_AGREE of the
    rays, t within RTOL_T where the ids agree (K1 is built with FMA
    contraction, K7 without)."""
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops import cuda_cluster as cc
    from myraytracer_tpu_torch.ops import traverse as trv
    from myraytracer_tpu_torch.ops.render import primary_rays_blocked

    o, d = primary_rays_blocked(camera, data.device)
    reset_launches()
    cl = cc.intersect_clusters(data, o, d)
    walk = trv.traverse_bvh(data, o, d)
    ran = {k: v for k, v in LAUNCHES.items() if v}
    check(all(ran.get(k, 0) > 0 for k in ("phase1_exact",
                                          "cluster_scan_closest",
                                          "bvh_walk_closest")),
          f"scan vs walk: launches {ran}")
    hit = walk.idx >= 0
    masks = float(((cl.idx >= 0) == hit).float().mean())
    same = cl.idx == walk.idx
    ids = float(same.float().mean())
    t_rel = float(((cl.t - walk.t).abs() / walk.t.abs())[same & hit].max())
    print(f"native: office tess {tess} {camera.width}x{camera.height} "
          f"primary rays ({o.shape[0]} with the block padding): K2 + K1 vs "
          f"K7 hit masks agree on {masks:.6f}, ids on {ids:.6f}, hits "
          f"{float(hit.float().mean()):.4f}, t within {t_rel:.3g} relative "
          f"where the ids agree; launches {ran}")
    check(masks >= ID_AGREE and ids >= ID_AGREE, f"scan vs walk: masks "
          f"{masks}, ids {ids}")
    check(t_rel <= RTOL_T, f"scan vs walk: t off by {t_rel} relative")


def inverse_demo():
    """Phase 22: examples/inverse_demo_torch.py at its defaults on the
    card; each of its fits must lower its loss."""
    import importlib.util
    import tempfile

    spec = importlib.util.spec_from_file_location(
        "inverse_demo_torch",
        os.path.join(REPO, "examples", "inverse_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        out = demo.main(["--out", tmp])
        secs = time.perf_counter() - t
    summary = {k: (out[k][0], out[k][-1], len(out[k]))
               for k in ("materials", "pose", "zoom")}
    print(f"demo: {secs:.2f} s; (first loss, last loss, steps) {summary}")
    for k, (first, last, _) in summary.items():
        check(math.isfinite(last) and last < first,
              f"demo {k}: the loss did not fall: {first} -> {last}")


#: phase 23: (eager, graphed) pairs timed per office entry point and per
#: golden, in turns; steps of each fit compared; profiled calls per
#: device-busy reading
GRAPH_PAIRS, GOLDEN_PAIRS, GRAPH_FIT_STEPS, BUSY_REPS = 10, 5, 5, 3
#: phase 23's bars, graphed against eager: the loss, and the fit's losses
#: (Adam steps on gradients summed by K6's atomics in a run-dependent
#: order); images must be equal bit for bit
GRAPH_LOSS_RTOL, GRAPH_FIT_RTOL = 1e-6, 1e-5


def wall_ms(fn) -> float:
    """Host milliseconds of one call that ends in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def busy_split(runs, reps: int = BUSY_REPS) -> dict:
    """Device-busy milliseconds per call of each run ``(label, fn,
    eager)`` (eager: under disable_graphs), from one torch.profiler
    window: the time of every kernel, copy and fill on the card (one
    stream, so they do not overlap) that starts inside the run's host
    range. Each run's calls end in a synchronise inside its range, and an
    idle gap separates the ranges. ``"unassigned"``: device ms that fell
    in no range."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from myraytracer_tpu_torch.ops.graphs import disable_graphs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn, eager in runs:
            mode = disable_graphs() if eager else contextlib.nullcontext()
            with mode, record_function("busy:" + label):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            time.sleep(0.005)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name[5:])
             for e in events
             if e.device_type != cuda and e.name.startswith("busy:")]
    out = {label: 0.0 for label, _, _ in runs}
    out["unassigned"] = 0.0
    for e in events:
        if e.device_type != cuda or e.name.startswith(("busy:", "mrt.")):
            continue
        t = e.time_range.start
        label = next((n for a, b, n in spans if a <= t < b), "unassigned")
        out[label] += e.time_range.elapsed_us() / 1e3
    return {k: v / (1 if k == "unassigned" else reps) for k, v in out.items()}


def in_turns(eager, graphed, pairs: int = GRAPH_PAIRS) -> dict:
    """Host ms of ``pairs`` eager and graphed calls in turns (eager first
    in even pairs, graphed first in odd ones): medians and the pairs the
    graphed call won."""
    from myraytracer_tpu_torch.ops.graphs import disable_graphs

    def eager_ms():
        with disable_graphs():
            return wall_ms(eager)

    ms = {"eager": [], "graphed": []}
    for i in range(pairs):
        order = (("eager", eager_ms), ("graphed", lambda: wall_ms(graphed)))
        for mode, fn in (order if i % 2 == 0 else order[::-1]):
            ms[mode].append(fn())
    ratios = [g / e for g, e in zip(ms["graphed"], ms["eager"])]
    return {"eager_ms": statistics.median(ms["eager"]),
            "graphed_ms": statistics.median(ms["graphed"]),
            "wins": sum(r < 1.0 for r in ratios), "pairs": pairs,
            "max_ratio": max(ratios)}


def add_busy(what: str, results: dict, fns: dict, shared: bool = True,
             reps: int = BUSY_REPS) -> None:
    """Each entry's device-busy ms, eager and graphed, from busy_split
    (one profiler window for them all, or with ``shared=False`` one for
    each: a window of seconds of work assigned device time to no range),
    and its share of the median wall time; printed."""
    runs = [(f"{name}/{mode}", fn, mode == "eager")
            for name, fn in fns.items() for mode in ("eager", "graphed")]
    if shared:
        busy = busy_split(runs, reps)
    else:
        busy = {"unassigned": 0.0}
        for run in runs:
            one = busy_split([run], reps)
            busy["unassigned"] += one.pop("unassigned")
            busy.update(one)
    for name, r in results.items():
        for mode in ("eager", "graphed"):
            r[f"{mode}_busy_ms"] = busy[f"{name}/{mode}"]
            r[f"{mode}_busy_share"] = busy[f"{name}/{mode}"] / r[f"{mode}_ms"]
        print(f"graphs {what} {name}: {turns_line(r)}")
    print(f"graphs {what}: device ms in no profiled range "
          f"{busy['unassigned']:.3f}")


def turns_line(t: dict) -> str:
    return (f"eager median {t['eager_ms']:.3f} ms, graphed median "
            f"{t['graphed_ms']:.3f} ms (graphed faster in {t['wins']} of "
            f"{t['pairs']} pairs, graphed/eager at most "
            f"{t['max_ratio']:.3f}); device busy eager {t['eager_busy_ms']:.3f}"
            f" ms ({100 * t['eager_busy_share']:.1f}% of its wall), graphed "
            f"{t['graphed_busy_ms']:.3f} ms "
            f"({100 * t['graphed_busy_share']:.1f}%)")


def launches_of(fn) -> tuple:
    """(result, the launches that ran in one call of fn, graph counts it
    moved): the launches of a replay's IF-node bodies that ran are added
    after the call (graphs.count_bodies)."""
    import torch

    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops.graphs import COUNTS, count_bodies

    torch.cuda.synchronize()
    count_bodies()
    reset_launches()
    before = dict(COUNTS)
    out = fn()
    torch.cuda.synchronize()
    count_bodies()
    return (out, {k: v for k, v in LAUNCHES.items() if v},
            {k: COUNTS[k] - before[k] for k in COUNTS})


def graphed_vs_eager(what: str, fn, compare, if_nodes: bool,
                     pairs: int = GRAPH_PAIRS, skips: bool = False) -> dict:
    """One entry point eager (disable_graphs: every segment runs, a
    select keeps or drops it) and graphed: the capture (the second call)
    must make IF nodes exactly when ``if_nodes``, the third call must be
    a replay and agree with the eager call (``compare(graphed, eager)``
    checks and describes). Without IF nodes it launches the same kernels
    as often as the eager call; with them, no kernel more often than the
    eager call, and with ``skips`` a replay must skip a body (a scene with
    a dead segment). Then timed in turns."""
    from myraytracer_tpu_torch.ops.graphs import disable_graphs

    with disable_graphs():
        eager, l_eager, moved = launches_of(fn)
    check(not any(moved.values()), f"{what}: an eager call used a graph")
    fn()
    _, _, captured = launches_of(fn)
    got, l_graph, moved = launches_of(fn)
    check(moved["replays"] > 0 and moved["captures"] == 0
          and moved["warm_ups"] == 0, f"{what}: the third call was not a "
          f"replay of a captured graph: {moved}")
    nodes, ran, skipped = (captured["if_nodes"], moved["bodies_run"],
                           moved["bodies_skipped"])
    check((nodes > 0) == if_nodes, f"{what}: {nodes} IF nodes captured")
    if if_nodes:
        check((skipped > 0 or not skips) and all(l_graph.get(k, 0) <= n
                                                 for k, n in l_eager.items())
              and set(l_graph) <= set(l_eager), f"{what}: launches that "
              f"ran graphed {l_graph} ({skipped} bodies skipped), eager "
              f"{l_eager}")
    else:
        check(l_graph == l_eager, f"{what}: launches graphed {l_graph}, "
              f"eager {l_eager}")
    agree = compare(got, eager)
    print(f"graphs {what}: {agree}; IF nodes captured {nodes}, bodies per "
          f"replay run {ran} and skipped {skipped}; launches that ran per "
          f"call graphed {l_graph}, eager {l_eager}; the third call "
          f"replayed")
    return dict(in_turns(fn, fn, pairs), launches=l_graph,
                eager_launches=l_eager, if_nodes=nodes, bodies_run=ran,
                bodies_skipped=skipped)


def same_image(what):
    import torch

    def compare(got, want):
        check(torch.equal(got, want), f"{what}: graphed image differs from "
              f"eager by {float((got - want).abs().max())}")
        return "image bit-equal to eager"
    return compare


def same_loss_grads(what, nonfinite: bool = False):
    """Graphed against eager: the loss within GRAPH_LOSS_RTOL, every
    gradient within REL_GRAD x max|eager|. With ``nonfinite``, a gradient
    entry that is not finite eagerly (behind a re-solve that fails on a
    mirror, as in phase 7's K6 check) must be the same graphed, and the
    finite entries meet the bar."""
    import torch

    def compare(got, want):
        (loss, grads), (loss_e, grads_e) = got, want
        rel = abs(float(loss) - float(loss_e)) / abs(float(loss_e))
        check(rel <= GRAPH_LOSS_RTOL, f"{what}: loss rel diff {rel}")
        check(set(grads) == set(grads_e) and len(grads) == 23,
              f"{what}: gradient keys")
        worst, n_inf = 0.0, {}
        for k in grads:
            a, b = grads[k], grads_e[k]
            fin = torch.isfinite(b)
            if nonfinite and not bool(fin.all()):
                check(torch.equal(fin, torch.isfinite(a)) and torch.equal(
                    a[~fin].nan_to_num(), b[~fin].nan_to_num()),
                    f"{what}: grad {k}: non-finite entries differ")
                n_inf[k] = int((~fin).sum())
                a, b = a[fin], b[fin]
            if a.numel():
                worst = max(worst, close_scaled(f"{what}: grad {k}", a, b,
                                                REL_GRAD))
        return (f"loss {float(loss)} vs eager {float(loss_e)} (rel "
                f"{rel:.3g}), worst gradient diff {worst:.3g} * max|a|"
                + (f"; non-finite entries, equal in both: {n_inf}"
                   if nonfinite else ""))
    return compare


def graphed_fit(what, data, camera, cfg) -> tuple:
    """GRAPH_FIT_STEPS InverseRenderer steps (mat_diffuse, light_color,
    every pixel) graphed and eager from the same start: losses within
    GRAPH_FIT_RTOL, steps 3 on replays of one captured graph (step 3
    captures) launching as the eager steps do; then single steps of the
    graphed renderer timed in turns. Returns (timings, one step)."""
    import dataclasses

    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render

    xs, ys = (g.reshape(-1) for g in camera.pixel_grid(data.device))
    with disable_graphs():
        dark = render(dataclasses.replace(
            data, mat_diffuse=data.mat_diffuse * 0.8), camera,
            cfg=cfg).reshape(-1, 3)
    names = ("mat_diffuse", "light_color")

    def run():
        inv = InverseRenderer(data, names, optimizer=adam(0.02),
                              camera=camera, cfg=cfg)
        steps = [launches_of(lambda: inv.fit_pixels(
            xs, ys, dark, steps=1).losses[0]) for _ in range(GRAPH_FIT_STEPS)]
        return inv, steps

    with disable_graphs():
        _, eager = run()
    inv, graphed = run()
    want = [{"warm_ups": 1, "captures": 0, "replays": 0}] * 2 + [
        {"warm_ups": 0, "captures": 1, "replays": 1}] + [
        {"warm_ups": 0, "captures": 0, "replays": 1}] * (GRAPH_FIT_STEPS - 3)
    calls = [{k: m[k] for k in want[0]} for _, _, m in graphed]
    check(calls == want, f"{what}: graph calls per step {calls}")
    check(not any(m["if_nodes"] for _, _, m in graphed),
          f"{what}: the fit step captured an IF node")
    le, lg = [x[0] for x in eager], [x[0] for x in graphed]
    for a, b in zip(lg, le):
        check(abs(a - b) <= GRAPH_FIT_RTOL * abs(b),
              f"{what}: losses graphed {lg}, eager {le}")
    check(lg[-1] < lg[0], f"{what}: the loss did not fall: {lg}")
    check(graphed[-1][1] == eager[-1][1], f"{what}: launches of a step "
          f"graphed {graphed[-1][1]}, eager {eager[-1][1]}")

    def step():
        return inv.fit_pixels(xs, ys, dark, steps=1)

    print(f"graphs {what}: losses graphed {lg}, eager {le}; steps 3 to "
          f"{GRAPH_FIT_STEPS} replayed; launches per step {graphed[-1][1]} "
          f"(both)")
    return dict(in_turns(step, step), launches=graphed[-1][1]), step


def step_memory(step) -> dict:
    """max_memory_reserved (GiB) of two eager calls of ``step`` and of
    three graphed ones (warm-up, capture, replay) from an empty cache,
    and what the graphed one keeps reserved after."""
    import torch

    from myraytracer_tpu_torch.ops import graphs

    out = {}
    for mode in ("eager", "graphed"):
        graphs.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if mode == "eager":
            with graphs.disable_graphs():
                step()
                step()
        else:
            for _ in range(3):
                step()
        torch.cuda.synchronize()
        out[f"{mode}_peak_reserved_gib"] = (torch.cuda.max_memory_reserved()
                                            / 2**30)
        out[f"{mode}_reserved_after_gib"] = torch.cuda.memory_reserved() / 2**30
    return out


def graphed_paths(dev: str, tess: int = 10, full=(1920, 1080)) -> None:
    """Phase 23: the entry points replayed as CUDA graphs (ops/graphs.py)
    against disable_graphs() on office 1920x1080, "cluster" and "auto":
    render, render_aa, the training step and the fit step; the 1080p
    step's reserved memory both ways; o_03's and o_04's render_aa both
    ways."""
    import torch

    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import (render, render_aa,
                                                  render_loss_grad_image,
                                                  sized_aa_budget)
    from myraytracer_tpu_torch.scenes.golden import (GOLDEN_SCENES,
                                                     scene_08_office)

    t0 = time.perf_counter()
    scene = scene_08_office(tess=tess, resolution=full)
    data, camera = scene.build(device=dev), scene.camera
    summary = {}
    for method in ("cluster", "auto"):
        cfg = tr.TraceConfig(tri_method=method)
        graphs.clear()
        with graphs.disable_graphs():
            img1 = render(data, camera, cfg=cfg)
        budget, _ = sized_aa_budget(img1)
        target = 0.9 * img1 + 0.02
        where = f"office {full[0]}x{full[1]} {method}"
        fns = {
            "render": lambda: render(data, camera, cfg=cfg),
            "render_aa": lambda: render_aa(data, camera, cfg=cfg,
                                           budget_frac=budget),
            "step": lambda: render_loss_grad_image(data, camera, target,
                                                   cfg=cfg)}
        summary[method] = {
            "render": graphed_vs_eager(f"{where} render", fns["render"],
                                       same_image(f"{where} render"), False),
            "render_aa": graphed_vs_eager(
                f"{where} render_aa (budget {budget})", fns["render_aa"],
                same_image(f"{where} render_aa"), False),
            "step": graphed_vs_eager(
                f"{where} training step", fns["step"],
                same_loss_grads(f"{where} training step"), False)}
        summary[method]["fit"], fns["fit"] = graphed_fit(
            f"{where} fit step", data, camera,
            cfg._replace(texture_filter="bilinear"))
        add_busy(where, summary[method], fns)
        if method == "cluster":
            mem = step_memory(fns["step"])
        del img1, target, fns
    del data
    goldens, fns, built = {}, {}, {}
    for name in ("o_03_mirror", "o_04_molecule"):
        builder, budget = GOLDEN_SCENES[name]
        sc = builder()
        gdata, cam = built[name] = sc.build(device=dev), sc.camera
        fns[name] = (lambda d=gdata, c=cam, b=budget:
                     render_aa(d, c, budget_frac=b))
        torch.cuda.reset_peak_memory_stats()
        goldens[name] = graphed_vs_eager(
            f"{name} {cam.width}x{cam.height} render_aa (budget {budget})",
            fns[name], same_image(f"{name} render_aa"), True, GOLDEN_PAIRS,
            skips=name == "o_04_molecule")
        goldens[name]["peak_reserved_gib"] = (torch.cuda.max_memory_reserved()
                                              / 2**30)
    # phase 16's o_04 training step: segments 1 and 2 of the topology and
    # of trace_shade's forward and backward run under IF nodes, and the
    # third segment (2) is dead in all three; then o_03's step, whose 21
    # segments are all live
    cfg = tr.TraceConfig(tri_method="bvh")
    for name, key, skipped in (("o_04_molecule", "o_04_step", 3),
                               ("o_03_mirror", "o_03_step", 0)):
        (gdata, cam), step_cfg = built[name], (
            cfg if key == "o_04_step" else tr.TraceConfig())
        target = 0.9 * render(gdata, cam, cfg=step_cfg) + 0.02
        fns[key] = (lambda d=gdata, c=cam, t=target, k=step_cfg:
                    render_loss_grad_image(d, c, t, cfg=k))
        what = (f"{name} {cam.width}x{cam.height} training step "
                f"({step_cfg.resolved_method()})")
        goldens[key] = graphed_vs_eager(
            what, fns[key], same_loss_grads(f"{name} training step",
                                            nonfinite=not skipped),
            True, GOLDEN_PAIRS, skips=bool(skipped))
        nodes, r = 3 * (gdata.n_segments - 1), goldens[key]
        check(r["if_nodes"] == nodes == r["bodies_run"] + r["bodies_skipped"]
              and r["bodies_skipped"] == skipped,
              f"{what}: {r['if_nodes']} IF nodes, bodies run "
              f"{r['bodies_run']} and skipped {r['bodies_skipped']} per "
              f"replay, where {nodes} nodes and {skipped} skipped were due")
        if skipped:
            sites = graphs.body_sites("render_loss_grad_image")
            print(f"graphs {what}: bodies skipped per replay "
                  f"{[site for site, ran in sites if not ran]}")
    add_busy("goldens", goldens, fns, shared=False, reps=1)
    goldens["o_04_step"]["memory_gib"] = step_memory(fns["o_04_step"])
    print(f"graphs: memory of the o_04_molecule training step (bvh), GiB: "
          f"{goldens['o_04_step']['memory_gib']}")
    summary.update(goldens)
    del fns, built
    graphs.clear()
    print(f"graphs: memory of the office {full[0]}x{full[1]} training step "
          f"(cluster), GiB: {mem}")
    print("graphs summary: " + json.dumps(summary))
    print(f"graphs: phase 23 took {time.perf_counter() - t0:.2f} s")


#: phase 24: the palette fit's scene, scale and steps, and its learning
#: rates: the tool's default and a tenth of it. The golden palettes are
#: this fit's result, so the cell MSE starts near its minimum, and at
#: the default Adam's first steps (about lr per leaf) overshoot it
#: before they return; the check that the MSE falls is made at a tenth
FIT_SCENE, FIT_SCALE, FIT_STEPS = "o_07_toon_faces", 1.0, 50
FIT_LRS, FIT_LR_FALLS = (2e-2, 2e-3), 2e-3


def unclamped_loss_grads(data, camera, target, cfg) -> tuple:
    """Phase 24: the SSE of render(clamp=False) against ``target`` under
    autograd -> (loss, the gradients of split_params, the image)."""
    import torch

    from myraytracer_tpu_torch import merge_params, split_params
    from myraytracer_tpu_torch.ops.render import render

    params = {k: v.detach().requires_grad_(True)
              for k, v in split_params(data).items()}
    img = render(merge_params(data, params), camera, cfg=cfg, clamp=False)
    loss = torch.sum((img - target) ** 2)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None
                           else g for k, g in zip(params, got)}, img.detach()


def same_loss_grads_as(what, got, want) -> str:
    """The loss within RTOL and every gradient within REL_GRAD x max|want|
    of (loss, grads) ``want``; returns the description."""
    (loss, grads), (loss_w, grads_w) = got, want
    rel = abs(float(loss) - float(loss_w)) / abs(float(loss_w))
    check(rel <= RTOL, f"{what}: loss {float(loss)} vs {float(loss_w)}, "
          f"rel diff {rel}")
    check(set(grads) == set(grads_w) and len(grads) == 23,
          f"{what}: gradient keys")
    worst = max(close_scaled(f"{what}: grad {k}", grads[k], grads_w[k],
                             REL_GRAD) for k in grads if grads[k].numel())
    return (f"loss {float(loss)} vs {float(loss_w)} (rel {rel:.3g}), worst "
            f"gradient diff {worst:.3g} * max|a|")


def render_bar(what, got, want) -> float:
    """>= GALLERY_AGREE of the pixels within 1e-4; returns the share."""
    agree = float(((got - want).abs().amax(dim=-1) <= 1e-4).float().mean())
    check(agree >= GALLERY_AGREE, f"{what}: {agree} of pixels within 1e-4")
    return agree


def graphed_walls(fn) -> tuple:
    """(result, seconds of three replays, launches) of a graphed entry
    point, after its warm-up and capture."""
    fn()
    fn()
    return timed(fn)


def peak_reserved(fn) -> float:
    """GiB of max_memory_reserved over one call of ``fn`` from an empty
    graph cache and allocator."""
    import torch

    from myraytracer_tpu_torch.ops import graphs

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_reserved() / 2**30


def diff_forward(dev: str, tess: int = 10, full=(1920, 1080)) -> None:
    """Phase 24: render(clamp=False) under autograd, eagerly
    (disable_graphs; phase 25 replays it), on office 1080p ("cluster",
    "auto"), o_10 with "bilinear" and o_04; the port's palette fit on
    o_07."""
    import torch

    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image
    from myraytracer_tpu_torch.scenes.golden import (GOLDEN_SCENES,
                                                     scene_08_office)

    t0 = time.perf_counter()
    summary = {}
    scene = scene_08_office(tess=tess, resolution=full)
    data, camera = scene.build(device=dev), scene.camera
    where = f"office {full[0]}x{full[1]}"
    for method in ("cluster", "auto"):
        cfg = tr.TraceConfig(tri_method=method)
        target = 0.9 * render(data, camera, cfg=cfg) + 0.02
        with torch.no_grad():
            img_ng = render(data, camera, cfg=cfg, clamp=False)

        def diff():
            return unclamped_loss_grads(data, camera, target, cfg)
        with graphs.disable_graphs():
            peak = peak_reserved(diff)
            (loss, grads, img), secs, launches = timed(diff)
        check(graphs.cache_size() == 0, f"diff {where} {method}: an eager "
              f"call made a graph")
        (want, secs_w, _) = graphed_walls(
            lambda: render_loss_grad_image(data, camera, target, cfg=cfg))
        what = f"diff {where} {method}"
        agree = same_loss_grads_as(what, (loss, grads), want)
        share = render_bar(f"{what} image vs no-grad", img, img_ng)
        per_call = {k: v // 3 for k, v in launches.items() if v}
        kernels = (FWD_KERNELS if method == "cluster" else BVH_FWD_KERNELS
                   ) + ("seg_fwd", "seg_bwd", "pack_rowsum")
        for k in kernels:
            check(per_call.get(k, 0) > 0, f"{what}: {k} was not launched")
        if method != "cluster":
            for k in CLUSTER_KERNELS:
                check(k not in per_call, f"{what}: {k} was launched")
        med, med_w = statistics.median(secs), statistics.median(secs_w)
        print(f"{what}: render(clamp=False) under autograd, forward+"
              f"backward median {med:.4f} s of {secs}; "
              f"render_loss_grad_image graphed {med_w:.4f} s of {secs_w}; "
              f"{agree}; image {share:.6f} of pixels within 1e-4 of the "
              f"no-grad render(clamp=False); peak reserved {peak:.3f} GiB; "
              f"launches per call {per_call}")
        summary[f"office_{method}"] = dict(
            fwd_bwd_s=secs, step_graphed_s=secs_w, peak_reserved_gib=peak,
            launches=per_call)
        del target, img_ng, img, grads, want

    sc = GOLDEN_SCENES["o_10_pokemon"][0]()
    gdata, cam = sc.build(device=dev), sc.camera
    cfg = tr.TraceConfig(texture_filter="bilinear")
    target = 0.9 * render(gdata, cam) + 0.02
    what = f"diff o_10_pokemon {cam.width}x{cam.height} bilinear"
    with graphs.disable_graphs():
        (loss, grads, img), secs, launches = timed(
            lambda: unclamped_loss_grads(gdata, cam, target, cfg))
    for k in FWD_KERNELS:
        check(launches[k] > 0, f"{what}: {k} was not launched")
    check(launches["seg_fwd"] == 0, f"{what}: a textured scene took K5")
    with graphs.disable_graphs():
        loss_p, grads_p, img_p = unclamped_loss_grads(
            gdata, cam, target, cfg._replace(plain=True))
    agree = same_loss_grads_as(f"{what} vs plain", (loss, grads),
                               (loss_p, grads_p))
    share = render_bar(f"{what} vs plain", img, img_p)
    for k in ("texels", "uv_u", "uv_v"):
        check(float(grads[k].abs().max()) > 0, f"{what}: grad {k} is zero")

    def no_grad_render():
        with torch.no_grad():
            return render(gdata, cam, cfg=cfg, clamp=False)
    no_grad_render()
    no_grad_render()
    img_g, _, moved = launches_of(no_grad_render)
    check(moved["replays"] == 1 and moved["warm_ups"] == 0,
          f"{what}: the no-grad render(clamp=False) did not replay: {moved}")
    share_g = render_bar(f"{what} graphed no-grad vs under grad", img_g, img)
    print(f"{what}: forward+backward median {statistics.median(secs):.4f} s "
          f"of {secs}; vs plain: {agree}, image {share:.6f}; the no-grad "
          f"render(clamp=False) replayed, {share_g:.6f} of pixels within "
          f"1e-4 of the image under grad; launches of 3 calls "
          f"{ {k: v for k, v in launches.items() if v} }")
    summary["o_10_bilinear"] = dict(fwd_bwd_s=secs)
    del gdata, target, img, img_p, img_g, grads, grads_p

    sc = GOLDEN_SCENES["o_04_molecule"][0]()
    gdata, cam = sc.build(device=dev), sc.camera
    cfg = tr.TraceConfig()
    target = 0.9 * render(gdata, cam) + 0.02
    what = f"diff o_04_molecule {cam.width}x{cam.height}"
    with graphs.disable_graphs():
        peak = peak_reserved(
            lambda: unclamped_loss_grads(gdata, cam, target, cfg))
        (loss, grads, _), secs, launches = timed(
            lambda: unclamped_loss_grads(gdata, cam, target, cfg))
    want, secs_w, _ = graphed_walls(
        lambda: render_loss_grad_image(gdata, cam, target, cfg=cfg))
    agree = same_loss_grads_as(what, (loss, grads), want)
    for k in ("shade_pre", "shade_phong"):
        check(launches[k] > 0, f"{what}: {k} was not launched")
    print(f"{what}: forward+backward median {statistics.median(secs):.4f} s "
          f"of {secs}; render_loss_grad_image graphed "
          f"{statistics.median(secs_w):.4f} s of {secs_w}; {agree}; peak "
          f"reserved {peak:.3f} GiB; launches of 3 calls "
          f"{ {k: v for k, v in launches.items() if v} }")
    summary["o_04"] = dict(fwd_bwd_s=secs, step_graphed_s=secs_w,
                           peak_reserved_gib=peak)
    del gdata, target, grads, want
    graphs.clear()

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import fit_palette_torch

    for lr in FIT_LRS:
        what = f"fit_palette {FIT_SCENE} scale {FIT_SCALE} lr {lr}"
        out = fit_palette_torch.fit(
            FIT_SCENE, FIT_STEPS, FIT_SCALE, lr, dev,
            log=lambda line: print(f"{what}: {line}"))
        losses = out["losses"]
        check(all(math.isfinite(x) for x in losses), f"{what}: {losses}")
        if lr == FIT_LR_FALLS:
            check(losses[-1] < losses[0], f"{what}: the cell MSE did not "
                  f"fall: {losses[0]} -> {losses[-1]}")
        step = statistics.median(out["step_s"][1:])
        print(f"{what}: {FIT_STEPS} steps, cell MSE {losses[0]} -> "
              f"{losses[-1]} (least {min(losses)} at step "
              f"{losses.index(min(losses))}), median {step:.4f} s per step "
              f"(first {out['step_s'][0]:.3f} s), final cell delta mean "
              f"{out['cell_delta_mean']:.4f} max {out['cell_delta_max']:.4f}")
        summary[f"fit_palette_lr_{lr}"] = dict(
            step_s=step, first_loss=losses[0], last_loss=losses[-1])
    print("diff summary: " + json.dumps(summary))
    print(f"diff: phase 24 took {time.perf_counter() - t0:.2f} s")


#: phase 25: eager/graphed pairs of render(clamp=False) under autograd, on
#: office and on each golden
DIFF_PAIRS, DIFF_GOLDEN_PAIRS = 10, 5


def graphed_diff_vs_eager(what: str, fn, nodes: int = 0, skipped: int = 0,
                          pairs: int = DIFF_PAIRS) -> tuple:
    """``fn`` (unclamped_loss_grads) eagerly (disable_graphs) and graphed
    from an empty cache: its first call the warm-up, its second the
    capture of the forward and the backward graph with ``nodes`` IF nodes
    in all, its third a replay of both, with ``skipped`` bodies skipped,
    launching what the eager call launches (no kernel more often with IF
    nodes). Its image must equal eager's bit for bit, the loss within
    GRAPH_LOSS_RTOL and every gradient within REL_GRAD x max|eager| (phase
    23's bars). Then timed in turns. Returns (the replay's (loss, grads,
    image), the eager one's, the results with the launches per call)."""
    import torch

    from myraytracer_tpu_torch.ops import graphs

    graphs.clear()
    with graphs.disable_graphs():
        eager, l_eager, moved = launches_of(fn)
    check(not any(moved.values()), f"{what}: an eager call used a graph")
    _, _, warm = launches_of(fn)
    _, _, cap = launches_of(fn)
    got, l_graph, moved = launches_of(fn)
    check(warm["warm_ups"] == 1 and cap["captures"] == 1
          and cap["backward_captures"] == 1 and cap["replays"] == 1
          and cap["backward_replays"] == 1, f"{what}: the first two calls "
          f"were not the warm-up and the capture of both graphs: {warm}, "
          f"{cap}")
    check(moved["replays"] == 1 and moved["backward_replays"] == 1
          and moved["warm_ups"] == moved["captures"] == 0
          and moved["pending_eager"] == 0, f"{what}: the third call did "
          f"not replay the forward and the backward graph: {moved}")
    ran, skip = moved["bodies_run"], moved["bodies_skipped"]
    check(cap["if_nodes"] == nodes == ran + skip and skip == skipped,
          f"{what}: {cap['if_nodes']} IF nodes, bodies run {ran} and "
          f"skipped {skip} per replay, where {nodes} nodes and {skipped} "
          f"skipped were due")
    if nodes:
        check(set(l_graph) <= set(l_eager) and all(
            n <= l_eager[k] for k, n in l_graph.items()),
            f"{what}: launches graphed {l_graph}, eager {l_eager}")
    else:
        check(l_graph == l_eager, f"{what}: launches graphed {l_graph}, "
              f"eager {l_eager}")
    (loss, grads, img), (loss_e, grads_e, img_e) = got, eager
    check(torch.equal(img, img_e), f"{what}: graphed image differs from "
          f"eager by {float((img - img_e).abs().max())}")
    agree = same_loss_grads(what)((loss, grads), (loss_e, grads_e))
    print(f"graphs {what}: image bit-equal to eager; {agree}; IF nodes "
          f"{nodes}, bodies per replay run {ran} and skipped {skip}; "
          f"launches per call graphed {l_graph}, eager {l_eager}")
    return got, eager, dict(in_turns(fn, fn, pairs), launches=l_graph,
                            eager_launches=l_eager, if_nodes=nodes,
                            bodies_run=ran, bodies_skipped=skip)


def pending_rule(what, data, camera, target, cfg) -> dict:
    """Two forwards of one key (two cameras of one size), then one
    backward of a loss over both: the second forward runs eagerly, and
    the loss and gradients meet phase 23's bars against the all-eager
    call. Then an output dropped without its backward frees the key: the
    next forward replays."""
    import dataclasses
    import gc

    import torch

    from myraytracer_tpu_torch import merge_params, split_params
    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops.render import render

    moved_cam = dataclasses.replace(camera, eye=camera.eye + 0.05)
    params = {k: v.detach().requires_grad_(True)
              for k, v in split_params(data).items()}

    def both():
        scene = merge_params(data, params)
        a = render(scene, camera, cfg=cfg, clamp=False)
        b = render(scene, moved_cam, cfg=cfg, clamp=False)
        loss = torch.sum((a - target) ** 2) + 0.5 * torch.sum(
            (b - target) ** 2)
        got = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(params[k]) if g is None
                               else g for k, g in zip(params, got)}

    with graphs.disable_graphs():
        want = both()
    before = dict(graphs.COUNTS)
    got = both()
    moved = {k: graphs.COUNTS[k] - before[k] for k in before}
    check(moved["replays"] == 1 and moved["pending_eager"] == 1
          and moved["backward_replays"] == 1 and moved["captures"] == 0,
          f"{what}: two forwards then one backward made {moved}")
    agree = same_loss_grads(what)(got, want)
    scene = merge_params(data, params)
    img = render(scene, camera, cfg=cfg, clamp=False)
    entry = next(e for e in graphs._CACHE.values() if e.backward is not None)
    check(graphs._pending(entry), f"{what}: a replayed forward is not "
          f"pending")
    del img
    gc.collect()
    before = dict(graphs.COUNTS)
    render(scene, camera, cfg=cfg, clamp=False)
    moved_drop = {k: graphs.COUNTS[k] - before[k] for k in before}
    check(moved_drop["replays"] == 1 and moved_drop["pending_eager"] == 0,
          f"{what}: after a dropped output the forward made {moved_drop}")
    print(f"graphs {what}: two forwards then one backward: the second ran "
          f"eagerly ({moved['pending_eager']}), {agree} against all-eager; "
          f"a dropped output freed the key (the next forward replayed)")
    return {"pending_eager": moved["pending_eager"]}


def graphed_diff(report: dict, dev: str, tess: int = 10,
                 full=(1920, 1080)) -> None:
    """Phase 25: render(clamp=False) under autograd replayed as a forward
    and a backward graph, against eager (disable_graphs) and the graphed
    training step: office 1080p on "cluster" and "auto" (each path
    kernel launched once per replayed call; those counts become each
    kernel's ``diff_launches``; the pending rule; reserved memory;
    device busy), o_04 (IF nodes in both graphs; loss and gradients to
    the bit) and o_10 with "bilinear"."""
    import torch

    from myraytracer_tpu_torch.ops import graphs
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image
    from myraytracer_tpu_torch.scenes.golden import (GOLDEN_SCENES,
                                                     scene_08_office)

    t0 = time.perf_counter()
    summary = {}
    scene = scene_08_office(tess=tess, resolution=full)
    data, camera = scene.build(device=dev), scene.camera
    where = f"office {full[0]}x{full[1]}"
    for method in ("cluster", "auto"):
        cfg = tr.TraceConfig(tri_method=method)
        target = 0.9 * render(data, camera, cfg=cfg) + 0.02
        what = f"diff {where} {method}"

        def fn():
            return unclamped_loss_grads(data, camera, target, cfg)
        (loss, grads, _), _, r = graphed_diff_vs_eager(what, fn)
        kernels = (FWD_KERNELS if method == "cluster" else BVH_FWD_KERNELS
                   ) + ("seg_fwd", "seg_bwd", "pack_rowsum")
        check(r["launches"] == {k: 1 for k in kernels}, f"{what}: launches "
              f"per replayed call {r['launches']}, not one of each of "
              f"{kernels}")
        for k in kernels:
            report[k]["diff_launches"] = r["launches"][k]
        want, secs_w, _ = graphed_walls(
            lambda: render_loss_grad_image(data, camera, target, cfg=cfg))
        vs_step = same_loss_grads_as(f"{what} vs the training step",
                                     (loss, grads), want)
        r["step_graphed_ms"] = 1e3 * statistics.median(secs_w)
        print(f"graphs {what} vs graphed render_loss_grad_image (median "
              f"{r['step_graphed_ms']:.3f} ms of three): {vs_step}")
        if method == "cluster":
            r.update(pending_rule(f"{what} pending", data, camera, target,
                                  cfg))
            r["memory_gib"] = step_memory(fn)
            print(f"graphs {what}: memory, GiB: {r['memory_gib']}")
        add_busy(f"diff {where}", {method: r}, {method: fn})
        summary[f"office_{method}"] = r
        del target, loss, grads, want
    del data
    graphs.clear()

    for name, filt, nodes, skipped in (("o_04_molecule", "nearest", 6, 3),
                                       ("o_10_pokemon", "bilinear", 0, 0)):
        builder, _ = GOLDEN_SCENES[name]
        sc = builder()
        gdata, cam = sc.build(device=dev), sc.camera
        cfg = tr.TraceConfig(texture_filter=filt)
        target = 0.9 * render(gdata, cam) + 0.02
        what = f"diff {name} {cam.width}x{cam.height} {filt}"

        def fn(d=gdata, c=cam, t=target, k=cfg):
            return unclamped_loss_grads(d, c, t, k)
        got, eager, r = graphed_diff_vs_eager(what, fn, nodes, skipped,
                                              DIFF_GOLDEN_PAIRS)
        if nodes:
            sites = graphs.body_sites("render")
            print(f"graphs {what}: bodies skipped per replay "
                  f"{[site for site, ran in sites if not ran]}")
            check(torch.equal(got[0], eager[0]) and all(
                torch.equal(got[1][k], eager[1][k]) for k in eager[1]),
                f"{what}: loss or gradients differ from eager's bits")
            print(f"graphs {what}: loss and 23 gradients equal to eager's "
                  f"to the bit")
            ana = {k: r["launches"].get(k, 0) for k in (
                "seg_ana_fwd", "seg_ana_bwd", "seg_fwd", "seg_bwd")}
            check(ana == {"seg_ana_fwd": 2, "seg_ana_bwd": 2, "seg_fwd": 0,
                          "seg_bwd": 0}, f"{what}: shade segment launches "
                  f"per replayed call {ana}")
            for k in ("seg_ana_fwd", "seg_ana_bwd"):
                report[k]["diff_launches"] = r["launches"][k]
        want, secs_w, _ = graphed_walls(
            lambda: render_loss_grad_image(gdata, cam, target, cfg=cfg))
        vs_step = same_loss_grads_as(f"{what} vs the training step",
                                     got[:2], want)
        r["step_graphed_ms"] = 1e3 * statistics.median(secs_w)
        print(f"graphs {what} vs graphed render_loss_grad_image (median "
              f"{r['step_graphed_ms']:.3f} ms of three): {vs_step}")
        add_busy(f"diff {name}", {filt: r}, {filt: fn}, reps=1)
        summary[name] = r
        del gdata, target, got, eager, want
        graphs.clear()
    print("graphs diff summary: " + json.dumps(summary))
    print(f"graphs: phase 25 took {time.perf_counter() - t0:.2f} s")


def build_gallery(dev):
    """The ten goldens at their golden resolution, and the mixed scene at
    1920x1080, on the card: name -> (Scene, SceneData)."""
    from myraytracer_tpu_torch.scenes.golden import GOLDEN_SCENES
    from myraytracer_tpu_torch.scenes.kinds import mixed_scene

    t = time.perf_counter()
    scenes = {name: builder() for name, (builder, _) in GOLDEN_SCENES.items()}
    scenes["mixed_1080p"] = mixed_scene(mirror=0.3, w=1920, h=1080)
    out = {name: (s, s.build(device=dev)) for name, s in scenes.items()}
    print(f"gallery: {len(out)} scenes built in "
          f"{time.perf_counter() - t:.2f} s")
    return out


def run(ptxas: dict, sass, dev: str = "cuda:0", tess: int = 10,
        full=(1920, 1080), small=(480, 270), n_tris=18664) -> dict:
    """All phases after the build (``ptxas``: the build's per-kernel
    resources; ``sass``: its static SASS counts, None without cuobjdump);
    returns the per-kernel report."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.graphs import disable_graphs
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    t = time.perf_counter()
    scene = scene_08_office(tess=tess, resolution=full)
    data = scene.build(device=dev)
    print(f"scene: office tess {tess}: {data.n_tris} triangles, "
          f"{data.cl_first.shape[0]} clusters of M={data.cl_M}, "
          f"{data.mat_diffuse.shape[0]} materials, {data.n_lights} light(s), "
          f"{data.n_segments} segment(s); built in "
          f"{time.perf_counter() - t:.2f} s")
    check(data.n_tris == n_tris, f"office has {data.n_tris} triangles")

    report = {}
    compare_kernels(data, scene.camera, report, ptxas)
    compare_edge_batches(dev)

    cam_small = scene_08_office(tess=tess, resolution=small).camera
    img_k = render(data, cam_small)
    with disable_graphs():
        img_p = render(data, cam_small, cfg=tr.TraceConfig(plain=True))
    diff = (img_k - img_p).abs().amax(dim=-1)
    frac = float((diff <= 1e-4).float().mean())
    print(f"render {small[0]}x{small[1]}: kernels vs plain: {frac:.6f} of "
          f"pixels within 1e-4, mean abs diff "
          f"{float((img_k - img_p).abs().mean())}")
    check(frac >= 0.995, f"{small[0]}x{small[1]} render: {frac} within 1e-4")

    img, secs, launches = timed(lambda: render(data, scene.camera))
    med = statistics.median(secs)
    mean = float(img.mean())
    print(f"render {full[0]}x{full[1]}: median {med:.4f} s of {secs}, "
          f"{full[0] * full[1] / med:.4g} rays/s, image mean {mean:.4f}, "
          f"launches {launches}")
    check(tuple(img.shape) == (full[1], full[0], 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "image is not finite")
    check(0.05 <= mean <= 0.95, f"image mean {mean}")
    for name in FWD_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the render")
        report[name]["launches"] = launches[name]
    for name, _, _ in ANALYTIC_KERNELS:
        check(launches[name] == 0, f"{name} was launched by the office render")

    compare_segment_kernels(data, scene.camera, report, ptxas, sass)
    compare_training_paths(data, cam_small)

    target = 0.9 * render(data, scene.camera) + 0.02
    (loss, grads), secs, launches = timed(
        lambda: render_loss_grad_image(data, scene.camera, target))
    med = statistics.median(secs)
    print(f"loss-grad {full[0]}x{full[1]}: median {med:.4f} s of {secs}, "
          f"{full[0] * full[1] / med:.4g} rays/s, loss {float(loss)}, "
          f"launches {launches}")
    check(bool(torch.isfinite(loss)), f"loss {float(loss)}")
    check(len(grads) == 23, f"{len(grads)} gradient keys")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"gradient {k} is not finite")
    for name, _, _ in KERNELS:
        check(launches[name] > 0,
              f"{name} was not launched by the training step")
        report[name]["train_launches"] = launches[name]
    check(launches["pack_rowsum"] > 0,
          "pack_rowsum was not launched by the training step")
    for name in ("seg_fwd", "seg_bwd", "pack_rowsum"):
        report[name]["launches"] = launches[name]

    losses = train_steps(data, scene.camera)
    print(f"Adam on mat_diffuse, light_color: losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")

    scenes = build_gallery(dev)
    compare_branch_kernels(scenes, dev, report)
    compare_analytic(scenes, dev, report, ptxas, sass)
    compare_ana_segment(scenes, dev, report, ptxas, sass)
    gallery(scenes, dev, report)
    office_aa(data, scene.camera)
    compare_bvh_walk(data, scene.camera, report, ptxas, sass)
    compare_walk_list(scenes, report, ptxas, sass)
    office_bvh(data, scene.camera, report)
    gallery_bvh(scenes)
    train_goldens(scenes, report)
    del scenes
    cli_render(dev)
    fit_office(data, scene.camera)
    bench_office()
    del data
    torch.cuda.empty_cache()
    sharded_office(dev, tess, full)
    native_builder(dev)
    inverse_demo()
    graphed_paths(dev, tess, full)
    diff_forward(dev, tess, full)
    graphed_diff(report, dev, tess, full)
    return report


class Tee:
    """A text stream that writes to every stream it was given."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", metavar="PATH",
                    help="also write the whole output to PATH")
    log_path = ap.parse_args(argv).log

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from myraytracer_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    from myraytracer_tpu_torch.utils.profiling import gpu_line

    if log_path:
        # a caller that keeps only the end of standard output keeps the
        # whole log here
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
        sys.stdout = Tee(sys.stdout, open(log_path, "w"))
    gpu = gpu_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t:.2f} s -> {os.path.relpath(path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    try:
        sass = kernels._build.kernel_sass(path)
    except RuntimeError as e:
        print(f"SASS not measured: {e}")
        sass = None
    report = run(kernels.kernel_resources(log), sass)
    entries = [(n, src, rep) for n, src, rep in
               KERNELS + BVH_KERNELS + WALK_LIST_KERNELS + ANALYTIC_KERNELS
               + ANA_SEG_KERNELS + PACK_KERNELS] + [
        (entry, src, rep) for entry, _, src, rep, _ in BRANCHES]
    summary = [dict(name=name, route="cuda", source=src, replaces=rep,
                    **report[name]) for name, src, rep in entries]
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for e in summary:
        check(all(k in e for k in keys), f"{e['name']}: summary keys")
    print(json.dumps({"kernels": summary}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
