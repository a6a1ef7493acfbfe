"""Traffic ``aa_orbit``: frames of ``render_aa`` from a camera that orbits
the look-at point, one frame in flight.

The cell's file gives the entry's settings (``budget``, ``subp``,
``threshold``; the triangle method is the configuration's) and the orbit: ``n_yaw`` x ``n_pitch`` poses on
an even lattice within +-``yaw_deg`` of yaw about the up axis and
+-``pitch_deg`` of pitch, the same set for every seed. The seed orders
them; frame i takes pose i of that order, cyclically. A frame is one
call of ``render_aa`` and a synchronise; it is timed from the call to
the synchronise's return (a closed loop of one client).

Checked: one frame drawn from the seed below ``check_frame``
(``sampled``) and the last frame of the window (``last``), each against
the reference's ``render_aa`` at its pose.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from rtbench import compare
from rtbench.port_scene import port_camera
from rtbench.reference import whitted as W


def poses(run) -> List[dict]:
    """The orbit's poses in the seed's order."""
    wl, cam = run.cell.workload, run.arrays["camera"]
    yaws = np.linspace(-wl["yaw_deg"], wl["yaw_deg"], wl["n_yaw"])
    pitches = np.linspace(-wl["pitch_deg"], wl["pitch_deg"], wl["n_pitch"])
    lattice = [W.rotate_pose(cam, float(y), float(p))
               for y in yaws for p in pitches]
    order = np.random.default_rng(run.seed).permutation(len(lattice))
    return [lattice[i] for i in order]


def _frame(run, st, i):
    from myraytracer_tpu_torch.ops.render import render_aa

    wl = run.cell.workload
    return render_aa(run.scene, st["cams"][i % len(st["cams"])], st["cfg"],
                     subp=wl["subp"], threshold=wl["threshold"],
                     budget_frac=wl["budget"])


def setup(run) -> Dict[str, object]:
    """The poses as the program's cameras on the device, and every graph
    the window replays: a key's first call runs eagerly, its second
    captures."""
    from myraytracer_tpu_torch.ops.tracer import TraceConfig

    ps = poses(run)
    st = {"poses": ps,
          "cfg": TraceConfig(tri_method=run.cell.config["tri_method"]),
          "cams": [port_camera(p, run.device) for p in ps]}
    st["check_frame"] = int(np.random.default_rng(run.seed + 1).integers(
        0, run.cell.workload["check_frame"]))
    for i in range(3):
        _frame(run, st, i)
        run.sync()
    return st


def window(run, st, seconds: float):
    """Frames until ``seconds`` have passed -> (metrics, frames)."""
    lat: List[float] = []
    keep = {}
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        img = _frame(run, st, i)
        run.sync()
        t1 = time.perf_counter()
        lat.append(t1 - t)
        if i == st["check_frame"]:
            keep["sampled"] = (i, img)
        i += 1
        if t1 - t0 >= seconds:
            break
    keep["last"] = (i - 1, img)
    st["answers"] = keep
    elapsed = t1 - t0
    return {"frames_per_s": i / elapsed,
            "frame_p95_ms": float(np.percentile(lat, 95)) * 1e3}, i


def traced(run, st, n: int) -> int:
    """``n`` frames, each call and synchronise a span; the host's time in
    ``render_aa`` (its call to its return) goes to ``run.spans``."""
    from torch.profiler import record_function

    enq = []
    keep = {}
    for i in range(n):
        with record_function("rtbench.render_aa"):
            t = time.perf_counter()
            img = _frame(run, st, i)
            enq.append(time.perf_counter() - t)
        with record_function("rtbench.synchronize"):
            run.sync()
        if i == st["check_frame"]:
            keep["sampled"] = (i, img)
    keep["last"] = (n - 1, img)
    st["answers"] = keep
    st["traced_poses"] = [st["poses"][i % len(st["poses"])] for i in range(n)]
    run.spans["enqueue_ms"] = 1e3 * sum(enq) / len(enq)
    return n


def check(run, st):
    """Each kept frame against the reference's ``render_aa`` at its pose."""
    wl = run.cell.workload
    answers = {role: (i, img.detach().cpu())
               for role, (i, img) in st.pop("answers").items()}
    st.pop("cams")
    run.free_program()
    scene = W.RefScene(run.arrays, run.device)
    out = []
    for role, (i, img) in sorted(answers.items()):
        ref, unsure = W.render_aa(scene, st["poses"][i % len(st["poses"])],
                                  wl["budget"], wl["subp"], wl["threshold"],
                                  ties=True)
        out += compare.checks(
            compare.image_numbers(img, ref.cpu(), unsure.cpu()),
            wl["limits"], prefix=f"{role}.")
    return out
