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
     and both times from CUDA events;
  5. office at 480x270 through the kernels and through the plain versions;
  6. office at 1920x1080 through the kernels, warm, three times: launch
     counts of that run, median seconds, rays/s, image checks;
  7. the shade-segment kernels K5 (forward) and K6 (backward) against
     their plain versions on the 1080p frame's first segment, with the
     topology from trace_topology and seeded random cotangents;
  8. the training step render_loss_grad_image at 480x270 three ways
     (kernels, plain versions, the autograd replay): losses and all 23
     gradients;
  9. the training step at 1920x1080 through the kernels, warm, three
     times (launch counts of that run, median seconds, rays/s, finite
     loss and gradients), then three Adam steps on mat_diffuse and
     light_color toward a darker render: the loss must fall.

Prints one JSON line with the per-kernel summary, then a final JSON status
line. Any failed check raises and the exit code is non-zero; without a
CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
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

#: kernels each path must launch: the forward render, the training step
FWD_KERNELS = ("phase1_exact", "cluster_scan_closest", "cluster_scan_anyhit",
               "shade_pre", "shade_phong")

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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def compare_kernels(data, camera, report):
    """Phase 4: each kernel vs its plain version at the 1080p shapes."""
    import torch

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
    key_p = cc.phase1_exact_plain(o4, d4, t0, act, bb)
    touched = key < INF
    check(bool((touched == (key_p < INF)).all()), "phase1_exact: touched sets differ")
    err = close("phase1_exact", key[touched], key_p[touched])
    report["phase1_exact"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: cc.phase1_exact(o4, d4, t0, act, bb), 10),
        plain_ms=time_ms(lambda: cc.phase1_exact_plain(o4, d4, t0, act, bb), 2))
    print(f"phase1_exact: S={key.shape[0]} K={key.shape[1]} "
          f"touched/subgroup={float(touched.sum(1).float().mean()):.1f} "
          f"max_abs_err={err}")

    # K1 closest-hit
    order, lb, n = cc.visit_lists(key)
    scan_args = (o4, d4, t0, act, bb, pack.cl_const, order, lb, n,
                 data.cl_first, data.cl_count, False)
    tk, ik = cc.cluster_scan(*scan_args)
    tp, ip = cc.cluster_scan_plain(*scan_args)
    agree = float((ik == ip).float().mean())
    check(agree >= ID_AGREE, f"cluster_scan_closest: id agreement {agree}")
    same = (ik == ip) & (ik >= 0)
    err = close("cluster_scan_closest", tk[same], tp[same], RTOL_T)
    report["cluster_scan_closest"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: cc.cluster_scan(*scan_args), 10),
        plain_ms=time_ms(lambda: cc.cluster_scan_plain(*scan_args), 2))
    print(f"cluster_scan_closest: hits={float((ik >= 0).float().mean()):.4f} "
          f"id_agreement={agree} max_abs_err(t)={err}")

    # K3 on the kernel's hits, as the tracer builds its inputs
    idx = ik[:R]
    t = torch.where(idx >= 0, tk[:R], torch.full_like(tk[:R], INF))
    kind = torch.where(idx >= 0, shade.KIND_TRI, shade.KIND_MISS).to(torch.int32)
    tri_idx = torch.clamp(idx, min=0).contiguous()
    live_i = live.to(torch.int32)
    pre_args = (o, d, t.contiguous(), kind, live_i, tri_idx,
                pack.geom.tri_pack, pack.geom.mat16, data.light_pos)
    pre = cs.shade_pre(*pre_args)
    pre_p = cs.shade_pre_plain(*pre_args)
    err = 0.0
    for i, name in enumerate(("point", "normal", "mid", "so", "sd", "st", "sact")):
        if pre[i].dtype == torch.int32:
            n_bad = int((pre[i] != pre_p[i]).sum())
            check(n_bad == 0, f"shade_pre: {name} differs on {n_bad} rays")
        else:
            err = max(err, close(f"shade_pre.{name}", pre[i], pre_p[i]))
    report["shade_pre"] = dict(
        max_abs_err=err, ms=time_ms(lambda: cs.shade_pre(*pre_args), 20),
        plain_ms=time_ms(lambda: cs.shade_pre_plain(*pre_args), 5))
    print(f"shade_pre: shadow rays active={float(pre[6].float().mean()):.4f} "
          f"max_abs_err={err}")

    # K1' any-hit on the shadow batch (hull phase-1)
    _, _, _, so, sd, st, sact = pre
    so4, sd4, st0, sact_p = cc.pad_rays(so, sd, st, sact > 0)
    hkey = cc.phase1_keys(data, so4, sd4, st0, sact_p, True, True)
    horder, hlb, hn = cc.visit_lists(hkey)
    any_args = (so4, sd4, st0, sact_p, bb, pack.cl_const, horder, hlb, hn,
                data.cl_first, data.cl_count, True)
    _, oi = cc.cluster_scan(*any_args)
    _, oi_p = cc.cluster_scan_plain(*any_args)
    occ, occ_p = oi >= 0, oi_p >= 0
    agree = float((occ == occ_p).float().mean())
    check(agree >= ID_AGREE, f"cluster_scan_anyhit: occlusion agreement {agree}")
    report["cluster_scan_anyhit"] = dict(
        max_abs_err=float((occ.float() - occ_p.float()).abs().max()),
        ms=time_ms(lambda: cc.cluster_scan(*any_args), 10),
        plain_ms=time_ms(lambda: cc.cluster_scan_plain(*any_args), 2))
    print(f"cluster_scan_anyhit: occluded={float(occ.float().mean()):.4f} "
          f"agreement={agree}")

    # K4
    shadow = occ[:L * R].to(torch.int32).reshape(L, R).contiguous()
    valid = (kind != shade.KIND_MISS).to(torch.int32)
    weight = torch.ones(R, device=o.device)
    phong_args = (o, d, weight, valid, live_i, pre[2], pre[0], pre[1], shadow,
                  pack.geom.mat16, data.light_pos, data.light_color, pack.env)
    ph = cs.shade_phong(*phong_args)
    ph_p = cs.shade_phong_plain(*phong_args)
    err = max(close(f"shade_phong.{nm}", a, b)
              for nm, a, b in zip(("add", "o2", "d2", "w2"), ph, ph_p))
    report["shade_phong"] = dict(
        max_abs_err=err, ms=time_ms(lambda: cs.shade_phong(*phong_args), 20),
        plain_ms=time_ms(lambda: cs.shade_phong_plain(*phong_args), 5))
    print(f"shade_phong: max_abs_err={err}")


def compare_segment_kernels(data, camera, report):
    """Phase 7: K5 and K6 vs their plain versions on the 1080p first
    segment, with the recorded topology."""
    import torch

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
    report["seg_fwd"] = dict(
        max_abs_err=err, ms=time_ms(lambda: sg.segment_fwd(*args), 20),
        plain_ms=time_ms(lambda: sg.segment_plain(*args), 3))
    print(f"seg_fwd: {R} rays, hits {float(args[10].float().mean()):.4f}, "
          f"max_abs_err={err}")

    bwd = sg.segment_bwd(*args, *cots)
    bwd_p = sg.segment_bwd_plain(*args, *cots)
    names = ("g_o", "g_d", "g_w", "g_rows", "g_light_pos", "g_light_color",
             "g_ambience", "g_background")
    # a recorded hit whose re-solve fails keeps its point at t = INF; with
    # a nonzero bounce cotangent its exact reverse is inf (the
    # reference's too): those entries must match, the rest within the bar
    err, worst, n_inf = 0.0, 0.0, 0
    for nm, a, b in zip(names, bwd, bwd_p):
        check(tuple(a.shape) == tuple(b.shape), f"seg_bwd.{nm}: shape")
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a))
              and torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num()),
              f"seg_bwd.{nm}: non-finite entries differ")
        n_inf += int((~fin).sum())
        worst = max(worst, close_scaled(f"seg_bwd.{nm}", a[fin], b[fin],
                                        REL_COT))
        err = max(err, float((a[fin] - b[fin]).abs().max()))
    report["seg_bwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: sg.segment_bwd(*args, *cots), 20),
        plain_ms=time_ms(lambda: sg.segment_bwd_plain(*args, *cots), 3))
    print(f"seg_bwd: max_abs_err={err}, worst diff {worst:.3g} * max|plain| "
          f"(bar {REL_COT}); {n_inf} non-finite entries, equal in both")


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


def train_steps(data, camera, steps: int = 3) -> list:
    """Phase 9b: Adam on mat_diffuse and light_color toward the render of
    the scene with mat_diffuse * 0.8; returns the losses."""
    import dataclasses

    import torch

    from myraytracer_tpu_torch import merge_params, render_loss_grad_image
    from myraytracer_tpu_torch.ops.render import render

    target = render(dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.8),
                    camera)
    p = {k: getattr(data, k).clone().requires_grad_(True)
         for k in ("mat_diffuse", "light_color")}
    opt = torch.optim.Adam(p.values(), lr=0.02)
    losses = []
    for step in range(steps + 1):
        scene = merge_params(data, {k: v.detach() for k, v in p.items()})
        loss, grads = render_loss_grad_image(scene, camera, target)
        losses.append(float(loss))
        if step == steps:
            break
        opt.zero_grad()
        for k, v in p.items():
            v.grad = grads[k]
        opt.step()
    return losses


def run(dev: str = "cuda:0", tess: int = 10, full=(1920, 1080),
        small=(480, 270), n_tris=18664) -> dict:
    """All phases after the build; returns the per-kernel report."""
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
    compare_kernels(data, scene.camera, report)

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

    compare_segment_kernels(data, scene.camera, report)
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
    return report


def main() -> int:
    import torch

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

    report = run()
    summary = [dict(name=name, route="cuda", source=src, replaces=rep,
                    **report[name]) for name, src, rep in KERNELS]
    print(json.dumps({"kernels": summary}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
