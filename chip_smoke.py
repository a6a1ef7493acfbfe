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
     counts of K5 and K6;
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
     errors, id agreement, both times;
 11. the golden gallery: each of the ten goldens at its golden
     resolution through render_aa, warm, three times (median seconds,
     launch counts of that run, peak device memory), held against its
     plain-version run (>= 99.5% of pixels within 1e-4) and against the
     committed outputs/<name>.png (mean 8x8 cell delta below 1e-3,
     >= 99% of pixels within 2/255); the mixed scene at 1920x1080
     through render_aa;
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
     times and its ids' agreement with K7's;
 14. office at 1920x1080 with tri_method="bvh": render, render_aa and
     render_loss_grad_image, each warm and three times (median seconds,
     launches of that run: the walk launched, no cluster kernel), held
     against the cluster path's image, loss and gradients;
 15. the seven goldens with triangles through render_aa with "bvh" at
     golden resolution, against the committed PNGs (phase 11's bars);
 16. training on o_04 (spheres and planes) and o_10 (textured, bilinear
     fetch) at golden resolution with "bvh": three warm steps (median
     seconds, finite loss and gradients) and three Adam steps in which
     the loss falls;
 17. the CLI's render verb in process (python -m myraytracer_tpu_torch
     render): examples/demo.sce at 640x480 (sphere, cylinder, mesh,
     mirror floor, depth 3) with and without --aa, and --golden
     o_08_office; each PNG against render / render_aa called directly
     with tri_method="auto", demo.sce's kernel render against its
     plain-version render (>= 99.5% of pixels within 1e-4), seconds and
     launches of each CLI call;
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
     and the card's name and power limit as its device.

Phases 17 to 19 run the "bvh" path (tri_method="auto"): each sets the
launch counts to 0 just before it and checks after it that the walk, K3
and K4 (and, where it trains, K5 and K6) were launched and the cluster
scan's kernels were not.

 20. the sharded path (parallel/) on office at 1920x1080, tess 10:
     render_sharded, render_aa_sharded (the budget sized as phase 12
     sizes it), one sharded SGD step (loss_grad_sharded and
     make_train_step on the screen-block batch) and three Adam steps of
     InverseRenderer(mesh=...) on mat_diffuse (parallel/dryrun.run_suite,
     each part twice, the second timed): first on one device, then at
     world size 1 over NCCL in this process, then at world size 2 over
     gloo, two ranks on cuda:0 spawned by parallel/dryrun.spawn (the
     scene through replicate_global; make_mesh(3) and replicate_global
     of a different tensor on each rank must raise). Each rank's
     launches per part (K2, K1, K1', K3 and K4 for the render and AA;
     the cluster scan, K3, K5 and K6 for the step; the walk, K3, K4, K5
     and K6, and no cluster kernel, for the fit), held against the
     single-device results: images >= 99.5% of pixels within 1e-4 (at
     world size 1 equal bit for bit), the loss within rtol 1e-5, every
     gradient within REL_GRAD * max|single|, the fit's losses within
     rtol 1e-5; wall seconds beside the single device's;
 21. the native BVH builder (runtime/native.py) against NumPy on office
     tess 10 and tess 28: BVH seconds and whole Scene.build seconds of
     each, which arrays are equal, and a 480x270 render of the
     native-built scene against the NumPy-built one (>= 99.5% of pixels
     within 1e-4);
 22. the port's inverse demo (examples/inverse_demo_torch.py) at its
     defaults on the card: each of its three fits lowers its loss, its
     seconds.

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
all_pairs_bound_by), every (ray, box) slab test.

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
           "bvh_walk_anyhit": "bvh_walk_kernelILb1E"}

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
        ms=time_ms(lambda: cc.phase1_exact(o4, d4, t0, act, bb), 10),
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
        ms=time_ms(lambda: cc.cluster_scan(*scan_args), 10),
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
        ms=time_ms(lambda: cc.cluster_scan(*any_args), 10),
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
    rep = dict(max_abs_err=err, ms=time_ms(lambda: cs.shade_pre(*pre_args), 20),
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
    rep = dict(max_abs_err=err, ms=time_ms(lambda: cs.shade_phong(*args), 20),
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
        max_abs_err=err, ms=time_ms(lambda: sg.segment_fwd(*args), 20),
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
        ms=time_ms(lambda: sg.segment_bwd(*args, *cots), 20),
        plain_ms=time_ms(lambda: sg.segment_bwd_plain(*args, *cots), 3),
        index_add_ms=time_ms(row_scatter, 20),
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


def compare_training_paths(data, cam_small):
    """Phase 8: the 480x270 training step through the kernels, the plain
    versions and the autograd replay: losses and all 23 gradients."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image

    target = 0.9 * render(data, cam_small) + 0.02
    runs = {}
    for name, cfg in (("kernels", tr.TraceConfig()),
                      ("plain", tr.TraceConfig(plain=True)),
                      ("autograd", tr.TraceConfig(fused_shade_grad=False))):
        runs[name] = render_loss_grad_image(data, cam_small, target, cfg=cfg)
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


def timed(fn, reps: int = 3):
    """(result, seconds per call, launches of those calls) after one warm
    call; the counts are set to 0 just before the timed calls."""
    import torch

    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches

    fn()
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return out, secs, dict(LAUNCHES)


def gallery(scenes, dev, report):
    """Phase 11: every golden at its golden resolution through render_aa,
    against its plain-version run and the committed PNG; and the mixed
    scene at 1920x1080."""
    import numpy as np
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
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
               ms=time_ms(lambda: trv.traverse_bvh(data, o, d, **kw), 10),
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
    k2 = time_ms(lambda: cc.phase1_exact(o4, d4, t0, act4, bb), 10)
    k1 = time_ms(lambda: cc.cluster_scan(*scan), 10)
    cl = cc.intersect_clusters(data, o, d, cl_rows=cl_rows)
    query = time_ms(lambda: cc.intersect_clusters(data, o, d,
                                                  cl_rows=cl_rows), 5)
    so4, sd4, st0, sact4 = cc.pad_rays(so, sd, st, act)
    hkey = cc.phase1_keys(data, so4, sd4, st0, sact4, True, True)
    hscan = (so4, sd4, st0, sact4, bb, cl_rows, *cc.visit_lists(hkey),
             data.cl_first, data.cl_count, True)
    k1a = time_ms(lambda: cc.cluster_scan(*hscan), 10)
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


def office_bvh(data, camera, report):
    """Phase 14: office 1080p through render, render_aa and the training
    step with tri_method="bvh", against the cluster path."""
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
            rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
            check(rel <= RTOL, f"bvh loss-grad: loss rel diff {rel}")
            check(set(grads) == set(grads_c) and len(grads) == 23,
                  "bvh loss-grad: gradient keys")
            worst = max(close_scaled(f"bvh grad {k}", grads[k], grads_c[k],
                                     REL_GRAD)
                        for k in grads if grads[k].numel())
            what = (f"loss {float(loss)} vs cluster {float(loss_c)} (rel "
                    f"{rel:.3g}), worst gradient diff {worst:.3g} * max|a|")
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


def train_goldens(scenes):
    """Phase 16: the training step on o_04 (spheres, planes) and o_10
    (textured, bilinear fetch) at golden resolution with "bvh"."""
    import torch

    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render, render_loss_grad_image

    for name, filt in TRAIN_GOLDENS:
        scene, data = scenes[name]
        cam = scene.camera
        cfg = tr.TraceConfig(tri_method="bvh", texture_filter=filt)
        check(not cfg.fused_grad(data), f"{name}: takes the fused segment")
        target = 0.9 * render(data, cam, cfg=cfg) + 0.02
        (loss, grads), secs, launches = timed(
            lambda: render_loss_grad_image(data, cam, target, cfg=cfg))
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
    import tempfile

    import numpy as np
    import torch

    from myraytracer_tpu_torch import cli
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.models.sceneio import read_scene
    from myraytracer_tpu_torch.ops import tracer as tr
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
            t = time.perf_counter()
            rc = cli.main(["render", *args, "--out", out])
            secs = time.perf_counter() - t
            launches = dict(LAUNCHES)
            check(rc == 0, f"cli render {name}: exit code {rc}")
            png = read_png(out)
            sc = make()
            data = sc.build(device=dev)
            direct = fn(data, sc.camera, cfg=auto)
            want = to_uint8(direct.cpu().numpy()) / np.float32(255)
            same = float((np.abs(png - want).max(axis=-1)
                          <= 1 / 255 + 1e-6).mean())
            line = (f"cli render {name} {sc.camera.width}x{sc.camera.height}: "
                    f"{secs:.3f} s (build, render, PNG); {same:.6f} of pixels "
                    f"within 1/255 of {fn.__name__} called directly")
            check(png.shape == (sc.camera.height, sc.camera.width, 3),
                  f"cli render {name}: PNG shape {png.shape}")
            check(same >= GALLERY_AGREE, f"cli render {name}: {same} of "
                  f"pixels within 1/255 of the direct call")
            check_path(f"cli render {name}", launches, BVH_FWD_KERNELS)
            if fn is render and name.startswith("demo"):
                plain = render(data, sc.camera, cfg=auto._replace(plain=True))
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
    print(f"bench: {len(lines)} lines in {secs:.2f} s; launches {launches}")
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


def sharded_office(dev, tess: int = 10, full=(1920, 1080)):
    """Phase 20: the sharded render, AA, training step and fit on office
    at 1920x1080: on one device, at world size 1 over NCCL in process,
    and at world size 2 over gloo on cuda:0 (parallel/dryrun.spawn)."""
    import torch
    import torch.distributed as dist

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
    one = dryrun.run_suite(case, None, reps=2)

    t = time.perf_counter()
    mesh = make_mesh(1, dev)
    try:
        check(dist.get_backend() == backend_for(kind),
              f"world size 1: backend {dist.get_backend()}")
        ws1 = dryrun.run_suite(case, mesh, reps=2)
    finally:
        dist.destroy_process_group()
    ws1_secs = time.perf_counter() - t
    del case
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = dryrun.spawn("suite", 2, dict(kw, reps=2), device=kind,
                         backend="gloo", deadline_s=300)
    ws2_secs = time.perf_counter() - t

    secs = {part: f"{one['seconds'][part]:.4f}" for part in one["seconds"]}
    print(f"sharded: single device: seconds {secs}; loss {one['loss']!r}; "
          f"fit losses {one['fit_losses']}")
    suite_launches("world size 1 (NCCL)", ws1["launches"])
    line = suite_checks("world size 1 (NCCL)", ws1, one, bit_equal=True)
    secs = {p: f"{ws1['seconds'][p]:.4f} (single {one['seconds'][p]:.4f})"
            for p in one["seconds"]}
    print(f"sharded: world size 1 (NCCL, {ws1_secs:.2f} s in all): seconds "
          f"{secs}; {line}; launches {launched(ws1['launches'])}")
    for r, got in enumerate(ranks):
        what = f"world size 2 (gloo, cuda:0) rank {r}"
        suite_launches(what, got["launches"])
        line = suite_checks(what, got, one, bit_equal=False)
        secs = {p: f"{got['seconds'][p]:.4f} (single "
                   f"{one['seconds'][p]:.4f})" for p in one["seconds"]}
        print(f"sharded: {what} ({ws2_secs:.2f} s for both ranks, spawn "
              f"included): seconds {secs}; {line}; launches "
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


def native_builder(dev, tesses=(10, 28), small=(480, 270)):
    """Phase 21: the native BVH builder against NumPy on office: BVH and
    Scene.build seconds, equal arrays, and a render of each build."""
    import torch

    from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS
    from myraytracer_tpu_torch.ops import bvh
    from myraytracer_tpu_torch.ops.render import render
    from myraytracer_tpu_torch.runtime import native
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    t = time.perf_counter()
    native.build()
    print(f"native: g++ build {time.perf_counter() - t:.2f} s")
    real = bvh.build_bvh
    bvh_secs = []

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        bvh_secs.append(time.perf_counter() - t0)
        return out

    bvh.build_bvh = timed_build
    try:
        for tess in tesses:
            sc = scene_08_office(tess=tess, resolution=small)
            built = {}
            for how in ("numpy", "native"):
                bvh_secs.clear()
                t = time.perf_counter()
                data = sc.build(device=dev, native=how == "native")
                built[how] = (data, time.perf_counter() - t, bvh_secs[0])
            a, b = built["numpy"][0], built["native"][0]
            check(a.n_tris == b.n_tris and a.n_nodes == b.n_nodes,
                  f"native tess {tess}: {b.n_tris} triangles, {b.n_nodes} "
                  f"nodes vs {a.n_tris}, {a.n_nodes}")
            differ = [f for f in ARRAY_FIELDS
                      if not torch.equal(getattr(a, f), getattr(b, f))]
            img_a, img_b = render(a, sc.camera), render(b, sc.camera)
            agree = float(((img_a - img_b).abs().amax(dim=-1) <= 1e-4)
                          .float().mean())
            print(f"native: office tess {tess} ({a.n_tris} triangles, "
                  f"{a.n_nodes} nodes): BVH {built['numpy'][2]:.3f} s NumPy, "
                  f"{built['native'][2]:.3f} s native; Scene.build "
                  f"{built['numpy'][1]:.3f} s NumPy, {built['native'][1]:.3f}"
                  f" s native; arrays that differ: {differ or 'none'}; "
                  f"{small[0]}x{small[1]} render {agree:.6f} of pixels "
                  f"within 1e-4")
            check(agree >= GALLERY_AGREE, f"native tess {tess}: {agree} of "
                  "pixels within 1e-4 of the NumPy build's render")
    finally:
        bvh.build_bvh = real


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

    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops import tracer as tr
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
    img_p = render(data, cam_small, cfg=tr.TraceConfig(plain=True))
    diff = (img_k - img_p).abs().amax(dim=-1)
    frac = float((diff <= 1e-4).float().mean())
    print(f"render {small[0]}x{small[1]}: kernels vs plain: {frac:.6f} of "
          f"pixels within 1e-4, mean abs diff "
          f"{float((img_k - img_p).abs().mean())}")
    check(frac >= 0.995, f"{small[0]}x{small[1]} render: {frac} within 1e-4")

    render(data, scene.camera)                      # warm
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        img = render(data, scene.camera)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = dict(LAUNCHES)
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

    compare_segment_kernels(data, scene.camera, report, ptxas, sass)
    compare_training_paths(data, cam_small)

    target = 0.9 * render(data, scene.camera) + 0.02
    render_loss_grad_image(data, scene.camera, target)      # warm
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        loss, grads = render_loss_grad_image(data, scene.camera, target)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = dict(LAUNCHES)
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
    for name in ("seg_fwd", "seg_bwd"):
        report[name]["launches"] = launches[name]

    losses = train_steps(data, scene.camera)
    print(f"Adam on mat_diffuse, light_color: losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")

    scenes = build_gallery(dev)
    compare_branch_kernels(scenes, dev, report)
    gallery(scenes, dev, report)
    office_aa(data, scene.camera)
    compare_bvh_walk(data, scene.camera, report, ptxas, sass)
    office_bvh(data, scene.camera, report)
    gallery_bvh(scenes)
    train_goldens(scenes)
    del scenes
    cli_render(dev)
    fit_office(data, scene.camera)
    bench_office()
    del data
    torch.cuda.empty_cache()
    sharded_office(dev, tess, full)
    native_builder(dev)
    inverse_demo()
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
    entries = [(n, src, rep) for n, src, rep in KERNELS + BVH_KERNELS] + [
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
