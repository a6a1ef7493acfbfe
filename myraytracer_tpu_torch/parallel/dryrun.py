"""Multi-process dryrun of the sharded paths, and the rank spawner.

    python -m myraytracer_tpu_torch.parallel.dryrun [--ranks 2]
        [--cpu] [--backend gloo|nccl]

The port's counterpart of tools/multihost_dryrun.py: the parent spawns
``--ranks`` processes wired by a process group (gloo unless
``--backend`` says otherwise), every rank builds the same toy scene
(:func:`toy_scene`) and runs one sharded training step
(parallel/shard_render.train_step_sharded), and rank 0's loss must
equal the single-process loss within rtol 1e-5. The ranks run on
``cuda:{rank % device_count}``, or on the CPU with ``--cpu``; several
ranks may share one card over gloo (NCCL refuses two ranks on one
GPU).

:func:`spawn` is the spawner the tests and chip_smoke.py use. It builds
the CUDA kernels in the parent before it spawns (for ``device="cuda"``),
starts each rank as ``python -m myraytracer_tpu_torch.parallel.dryrun
--child DIR RANK`` with the MRT_* launch variables of
parallel/distributed.py, joins them against a deadline (and kills them
past it, or as soon as one rank fails), and returns each rank's result,
which the rank writes with ``torch.save`` into the temporary directory
DIR. A rank's process group times out after ``mesh.TIMEOUT`` (60 s).

A task is a function of this module (:data:`TASKS`), so a child imports
the port and nothing else: ``"train_step"`` is the dryrun's step,
``"suite"`` runs :func:`run_suite`'s sharded render, AA, training step
and fit on a scene named in :data:`SCENES`, ``"fit"`` the fit alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from myraytracer_tpu_torch.ops import tracer as tr

PKG_ROOT = Path(__file__).resolve().parent.parent.parent

#: what a spawned rank runs with ``python -m``
CHILD_MODULE = "myraytracer_tpu_torch.parallel.dryrun"

#: the rtol of the dryrun's loss against the single-process loss
LOSS_RTOL = 1e-5

#: run_suite's SGD learning rate; its fit's start (mat_diffuse times
#: FIT_SCALE) and Adam learning rate
SUITE_LR, FIT_SCALE, FIT_LR = 0.5, 0.4, 3e-2


def toy_scene(w: int = 16, h: int = 16):
    """The dryrun scene: a mirror sphere, a sphere mesh and a floor plane,
    two mirror bounces (tools/multihost_dryrun.py's toy_scene)."""
    from myraytracer_tpu_torch.models.material import Material
    from myraytracer_tpu_torch.models.mesh import PHONG, TriangleMesh
    from myraytracer_tpu_torch.models.scene import Scene
    from myraytracer_tpu_torch.scenes.shapes import uv_sphere

    s = Scene()
    s.set_camera(eye=(0, 1, 5), center=(0, 0, 0), up=(0, 1, 0), fovy=45,
                 width=w, height=h)
    s.add_light((2, 4, 4), (0.8, 0.8, 0.8))
    s.ambience = (0.2, 0.2, 0.2)
    s.add_sphere((0.8, 0, 0), 0.7, Material(diffuse=(0.7, 0, 0), mirror=0.2))
    v, f = uv_sphere(0.5, 6, 8, center=(-0.9, 0, 0))
    s.add_mesh(TriangleMesh(v, f, material=Material(diffuse=(0, 0.5, 0.5)),
                            draw_mode=PHONG))
    s.add_plane((0, -0.8, 0), (0, 1, 0), Material(diffuse=(0.5, 0.5, 0.5)))
    s.max_depth = 2
    return s


def _office(tess: int = 10, width: int = 1920, height: int = 1080):
    from myraytracer_tpu_torch.scenes.golden import scene_08_office

    return scene_08_office(tess=tess, resolution=(width, height))


#: scenes a task can name: builder keyword arguments are JSON values
SCENES = {"toy": toy_scene, "office": _office}


def step_inputs(device="cuda"):
    """(scene, o, d, target) of the dryrun's step: the toy scene's pixel
    grid in raster order, a black target."""
    s = toy_scene()
    scene = s.build(device=device)
    xs, ys = s.camera.pixel_grid(scene.device)
    o, d = s.camera.primary_rays(xs.reshape(-1), ys.reshape(-1))
    return scene, o.contiguous(), d.contiguous(), torch.zeros_like(o)


def single_process_loss(device="cuda") -> float:
    """The dryrun step's loss without a process group: the mean squared
    error of :func:`step_inputs`."""
    from myraytracer_tpu_torch.ops.render import render_loss_grad

    scene, o, d, target = step_inputs(device)
    loss, _ = render_loss_grad(scene, o, d, target)
    return float(loss) / (3 * o.shape[0])


def _train_step_task(rank: int, mesh, lr: float = 0.5) -> dict:
    from myraytracer_tpu_torch.parallel.shard_render import train_step_sharded

    scene, o, d, target = step_inputs(mesh.device_type)
    _, loss = train_step_sharded(scene, o, d, target, mesh, lr=lr)
    return {"loss": float(loss)}


@dataclasses.dataclass
class SuiteCase:
    """The inputs :func:`run_suite` traces, trains and fits on."""

    camera: object
    scene: object            # SceneData
    budget_frac: float       # render_aa's budget
    target_img: torch.Tensor  # [H, W, 3] the training step's target
    fit_names: tuple         # parameters the fit optimises
    fit_start: object        # SceneData the fit starts from
    fit_o: torch.Tensor      # [R, 3] the fit's rays (raster order)
    fit_d: torch.Tensor
    fit_target: torch.Tensor  # [R, 3] the true scene's colours
    fit_steps: int


def suite_case(scene: str = "toy", scene_kw: Optional[dict] = None,
               device="cuda", budget_frac: float = 0.2,
               fit_steps: int = 3) -> SuiteCase:
    """Build :func:`run_suite`'s inputs for the scene ``SCENES[scene]``:
    the training step's target is 0.9 x the render plus 0.02; the fit
    starts from mat_diffuse x FIT_SCALE and fits mat_diffuse to the true
    scene's colours over every pixel. Every rank builds the same."""
    from myraytracer_tpu_torch.ops.render import render

    s = SCENES[scene](**(scene_kw or {}))
    data = s.build(device=device)
    cam = s.camera
    xs, ys = cam.pixel_grid(data.device)
    o, d = cam.primary_rays(xs.reshape(-1), ys.reshape(-1))
    o, d = o.contiguous(), d.contiguous()
    auto = tr.TraceConfig(tri_method="auto")
    return SuiteCase(
        camera=cam, scene=data, budget_frac=budget_frac,
        target_img=0.9 * render(data, cam) + 0.02,
        fit_names=("mat_diffuse",),
        fit_start=dataclasses.replace(
            data, mat_diffuse=data.mat_diffuse * FIT_SCALE),
        fit_o=o, fit_d=d,
        fit_target=tr.trace(data, o, d, auto._replace(
            texture_filter="bilinear")),
        fit_steps=fit_steps)


def run_suite(case: SuiteCase, mesh=None, reps: int = 1) -> dict:
    """The render, render_aa, one SGD training step and a fit of
    ``case``, sharded over ``mesh``, or on one device when it is None.

    Each part runs ``reps`` times; the result and the wall seconds and
    kernel launches are those of the last run. Returns CPU tensors:
    ``img``, ``img_aa`` [H, W, 3]; ``loss`` (the step's mean squared
    error), ``params`` (the parameters after the step); ``grads`` (the
    summed SSE gradients of the step's batch, from one more untimed
    call), ``n_total`` (3 x the summed weights); ``fit_losses`` and
    ``fit_params``; ``seconds`` and ``launches`` per part.
    """
    from myraytracer_tpu_torch.kernels import LAUNCHES, reset_launches
    from myraytracer_tpu_torch.ops.render import (BLOCK, _loss_grad_tiled,
                                                  _to_blocks,
                                                  primary_rays_blocked,
                                                  render, render_aa,
                                                  restore_mirror_chain)
    from myraytracer_tpu_torch.parallel import shard_render as sr
    from myraytracer_tpu_torch.parallel.distributed import (replicate_global,
                                                            shard_rays_global)

    scene, cam = case.scene, case.camera
    if mesh is not None:
        scene = replicate_global(mesh, scene)
    H, W = cam.height, cam.width
    # the training step's batch: every pixel in screen-block order, the
    # padded pixels weighted 0 (render_loss_grad_image's batch)
    o, d = primary_rays_blocked(cam, scene.device, BLOCK)
    Hp, Wp = -(-H // BLOCK) * BLOCK, -(-W // BLOCK) * BLOCK
    F = torch.nn.functional
    tgt = _to_blocks(F.pad(case.target_img, (0, 0, 0, Wp - W, 0, Hp - H)),
                     BLOCK)
    w = _to_blocks(F.pad(torch.ones((H, W), device=o.device),
                         (0, Wp - W, 0, Hp - H)), BLOCK)
    if mesh is not None:
        # padded to the mesh with copies of the last ray, weighted 0
        o_p, d_p, _ = sr._pad_rays(o, d, mesh.size())
        pad = o_p.shape[0] - o.shape[0]
        o_s, d_s, t_s, w_s = shard_rays_global(
            mesh, o_p, d_p, F.pad(tgt, (0, 0, 0, pad)), F.pad(w, (0, pad)))

    def loss_grad(sc):
        """(summed SSE loss, its gradients, 3 x summed weights)."""
        if mesh is not None:
            return sr.loss_grad_sharded(sc, o_s, d_s, t_s, w_s, mesh)
        loss, grads = _loss_grad_tiled(sc, o, d, tgt, w, tr.TraceConfig(),
                                       o.shape[0])
        return loss, grads, 3.0 * w.sum()

    def step():
        """One SGD step: (mean squared error, the parameters after it)."""
        sc = restore_mirror_chain(scene)
        if mesh is not None:
            new, mse = sr.make_train_step(mesh, lr=SUITE_LR)(sc, o_s, d_s,
                                                              t_s, w_s)
            return float(mse), sr.split_params(new)
        loss, grads, n = loss_grad(sc)
        return float(loss / n), {k: p - SUITE_LR * grads[k] / n
                                 for k, p in sr.split_params(sc).items()}

    parts = {
        "render": lambda: (sr.render_sharded(scene, cam, mesh) if mesh
                           else render(scene, cam)),
        "render_aa": lambda: (
            sr.render_aa_sharded(scene, cam, mesh,
                                 budget_frac=case.budget_frac) if mesh
            else render_aa(scene, cam, budget_frac=case.budget_frac)),
        "train_step": step,
        "fit": lambda: fit(case, mesh),
    }
    out: Dict[str, object] = {"seconds": {}, "launches": {}}
    sync = (torch.cuda.synchronize if scene.device.type == "cuda"
            else lambda: None)
    for name, fn in parts.items():
        for _ in range(reps):
            sync()
            reset_launches()
            t = time.perf_counter()
            res = fn()
            sync()
            out["seconds"][name] = time.perf_counter() - t
            out["launches"][name] = dict(LAUNCHES)
        out[name] = res
    cpu = _to_cpu
    loss, params = out.pop("train_step")
    _, grads, n_total = loss_grad(restore_mirror_chain(scene))
    fit_losses, fit_params = out.pop("fit")
    out.update(img=cpu(out.pop("render")), img_aa=cpu(out.pop("render_aa")),
               loss=loss, grads=cpu(grads), n_total=float(n_total),
               params=cpu(params), fit_losses=fit_losses,
               fit_params=cpu(fit_params))
    return out


def fit(case: SuiteCase, mesh=None, checkpoint: Optional[str] = None):
    """The fit of ``case`` (InverseRenderer, Adam), sharded over ``mesh``
    or on one device, then its checkpoint in the directory
    ``checkpoint`` when one is given: (losses, fitted parameters)."""
    from myraytracer_tpu_torch.inverse import InverseRenderer, adam

    inv = InverseRenderer(case.fit_start, case.fit_names,
                          optimizer=adam(FIT_LR), mesh=mesh)
    res = inv.fit(case.fit_o, case.fit_d, case.fit_target,
                  steps=case.fit_steps)
    if checkpoint:
        inv.save_checkpoint(checkpoint)
    return res.losses, res.params


def _fit_task(rank: int, mesh, checkpoint: Optional[str] = None,
              **case_kw) -> dict:
    """The fit alone, checkpointed into ``checkpoint`` by mesh rank 0;
    ``checkpoint_seen``: the file was there when this rank's save
    returned."""
    from myraytracer_tpu_torch.inverse import CHECKPOINT_FILE

    losses, params = fit(suite_case(device=mesh.device_type, **case_kw),
                         mesh, checkpoint)
    return {"fit_losses": losses, "fit_params": _to_cpu(params),
            "checkpoint_seen": bool(checkpoint) and
            Path(checkpoint, CHECKPOINT_FILE).exists()}


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x.detach().cpu()


def _suite_task(rank: int, mesh, reps: int = 1, **case_kw) -> dict:
    """The suite on the whole world's mesh and the dryrun's step
    (``dryrun_loss``), then the render on a mesh of rank 0 alone
    (``img_ws1``, on rank 0), and the ValueErrors of a mesh larger than
    the world (``mesh_error``) and of replicate_global given a different
    tensor on every rank (``replicate_error``, None on rank 0)."""
    from myraytracer_tpu_torch.parallel.distributed import replicate_global
    from myraytracer_tpu_torch.parallel.mesh import make_mesh
    from myraytracer_tpu_torch.parallel.shard_render import render_sharded

    case = suite_case(device=mesh.device_type, **case_kw)
    out = run_suite(case, mesh, reps)
    out["dryrun_loss"] = _train_step_task(rank, mesh)["loss"]
    alone = make_mesh(1, mesh.device_type)
    if rank == 0:
        out["img_ws1"] = render_sharded(case.scene, case.camera,
                                        alone).cpu()
    try:
        make_mesh(dist.get_world_size() + 1, mesh.device_type)
    except ValueError as e:
        out["mesh_error"] = str(e)
    out["replicate_error"] = None
    try:
        replicate_global(mesh, torch.tensor([float(rank)]))
    except ValueError as e:
        out["replicate_error"] = str(e)
    return out


#: tasks a spawned rank can run: name -> fn(rank, mesh, **args)
TASKS = {"train_step": _train_step_task, "suite": _suite_task,
         "fit": _fit_task}


def spawn(task: str, n_ranks: int, args: Optional[dict] = None,
          device: str = "cuda", backend: Optional[str] = None,
          deadline_s: float = 180.0) -> List[dict]:
    """Run ``TASKS[task](rank, mesh, **args)`` on ``n_ranks`` spawned
    processes, one process group and one ray mesh over all of them on
    ``device``; returns each rank's result, in rank order.

    ``backend`` None is gloo (the one backend that takes several ranks
    on one card). Raises RuntimeError when a rank fails (with its
    output), TimeoutError when the ranks are not done within
    ``deadline_s`` seconds; either way every rank is stopped first.
    """
    if torch.device(device).type == "cuda":
        from myraytracer_tpu_torch import kernels

        kernels.build()
    from myraytracer_tpu_torch.parallel.mesh import free_port

    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "spec.json").write_text(json.dumps(dict(
            task=task, args=args or {}, device=device,
            backend=backend or "gloo")))
        base = {k: v for k, v in os.environ.items()
                if not k.startswith("MRT_") and k != "LOCAL_RANK"}
        base["PYTHONPATH"] = os.pathsep.join(
            [str(PKG_ROOT)] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH")
                               else []))
        port = free_port()
        procs, logs = [], []
        try:
            for r in range(n_ranks):
                env = dict(base, MRT_COORDINATOR=f"localhost:{port}",
                           MRT_NUM_PROCESSES=str(n_ranks),
                           MRT_PROCESS_ID=str(r), LOCAL_RANK=str(r))
                log = open(Path(tmp, f"rank{r}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", CHILD_MODULE, "--child", tmp,
                     str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
            _join(procs, deadline_s, tmp)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(n_ranks)]


def _join(procs, deadline_s: float, tmp: str) -> None:
    """Wait for every rank; raise as soon as one fails or the deadline
    passes."""
    end = time.monotonic() + deadline_s
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad or time.monotonic() > end:
            logs = "\n".join(f"--- rank {r} ---\n"
                             + Path(tmp, f"rank{r}.log").read_text()
                             for r in range(len(procs)))
            if bad:
                raise RuntimeError(f"rank {bad[0]} failed (exit code "
                                   f"{codes[bad[0]]}):\n{logs}")
            raise TimeoutError(f"the ranks did not finish in {deadline_s} "
                               f"s:\n{logs}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.05)


def _child(tmp: str, rank: int) -> None:
    from myraytracer_tpu_torch.parallel.distributed import (
        global_ray_mesh, initialize_from_env)

    spec = json.loads(Path(tmp, "spec.json").read_text())
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    if not initialize_from_env(backend=spec["backend"]):
        raise RuntimeError("a child rank needs MRT_COORDINATOR")
    try:
        mesh = global_ray_mesh(spec["device"])
        out = TASKS[spec["task"]](rank, mesh, **spec["args"])
        torch.save(out, Path(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(n_ranks: int = 2, device: str = "cuda",
        backend: Optional[str] = None) -> float:
    """The dryrun: one sharded step on ``n_ranks`` ranks; returns rank
    0's loss after checking it against :func:`single_process_loss`."""
    loss = spawn("train_step", n_ranks, device=device,
                 backend=backend)[0]["loss"]
    want = single_process_loss(device)
    if abs(loss - want) > LOSS_RTOL * abs(want):
        raise RuntimeError(f"multi-process loss {loss!r} != single-process "
                           f"loss {want!r}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (default: the GPU)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--child", nargs=2, metavar=("DIR", "RANK"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        try:
            _child(args.child[0], int(args.child[1]))
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    device = "cpu" if args.cpu else "cuda"
    loss = run(args.ranks, device, args.backend)
    print(f"{args.ranks} ranks ({device}, {args.backend or 'gloo'}): "
          f"loss {loss!r} equals the single-process loss "
          f"{single_process_loss(device)!r}")
    print("dryrun OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
