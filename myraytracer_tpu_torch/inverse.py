"""Inverse rendering: fit scene parameters to target images.

Counterpart of ``myraytracer_tpu/inverse.py``. :class:`InverseRenderer`
runs a ``torch.optim`` optimizer (Adam by default) over a chosen subset
of the scene's float leaves (``split_params``), plus the camera leaves
``cam_eye``/``cam_center``/``cam_up``/``cam_fovy`` when a camera is
attached, with checkpoint and resume through ``torch.save``.

One step: merge the parameters into the scene; refit the acceleration
boxes (no gradients) when ``vertex_pos`` is fitted; form the rays (from
the current camera in pixel mode); record the hit topology without
gradients (``trace_topology``); replay the shading with gradients
(``trace_shade``); take the mean squared error against the target; one
backward and one optimizer step. The camera leaves reach the loss through
the rays' origins and directions.

With ``mesh=`` (a ray mesh, parallel/mesh.make_mesh) every rank of the
mesh runs the same fit on its share of the rays: the batch is padded to
the mesh with copies of its last row, weighted 0; each rank's loss is
``sum(w (c - target)^2)``; after the backward one ``all_reduce`` sums the
loss, every parameter's gradient and ``sum(w)``, and both are divided by
``3 * sum(w)`` before the optimizer step (Adam is not scale-free at its
epsilon). The optimizer state stays replicated, so every rank takes the
same step; a checkpoint is written by mesh rank 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops.refit import refit_accel
from myraytracer_tpu_torch.parallel.mesh import mesh_rank
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)

#: camera leaves exposed as parameters when a camera is attached: the
#: pose (eye, center, up) and the vertical field of view in degrees
CAMERA_PARAMS = ("cam_eye", "cam_center", "cam_up", "cam_fovy")

_CAM_FIELD = {"cam_eye": "eye", "cam_center": "center", "cam_up": "up",
              "cam_fovy": "fovy"}

#: the checkpoint file inside a checkpoint directory
CHECKPOINT_FILE = "state.pt"


def camera_with(camera, params: Dict[str, torch.Tensor]):
    """Camera with any ``cam_*`` leaves of ``params`` substituted."""
    kw = {f: params[n] for n, f in _CAM_FIELD.items() if n in params}
    return dataclasses.replace(camera, **kw) if kw else camera


def _scene_leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in params.items() if k not in _CAM_FIELD}


@dataclasses.dataclass
class FitResult:
    scene: object
    losses: List[float]
    params: Dict[str, torch.Tensor]
    camera: object = None


def adam(lr: float = 1e-2) -> Callable[[List[torch.Tensor]],
                                       torch.optim.Optimizer]:
    """An optimizer factory for :class:`InverseRenderer`: Adam, whose update
    ``lr * m_hat / (sqrt(v_hat) + 1e-8)`` is ``optax.adam``'s."""
    return lambda params: torch.optim.Adam(params, lr=lr)


class InverseRenderer:
    """Optimize selected scene parameters against target pixel colors.

    Args:
        scene: a built SceneData (topology fixed during optimization).
        param_names: which float leaves to optimize (default: every scene
            float leaf, plus the camera leaves when ``camera`` is given).
        optimizer: a callable from the list of parameter tensors to a
            ``torch.optim.Optimizer`` (default ``adam(1e-2)``).
        cfg: TraceConfig; the default walks the BVH ("auto") and fetches
            texels bilinearly, so texels and UVs get gradients.
        mesh: a ray mesh (parallel/mesh.make_mesh): each step splits the
            rays over its ranks and sums the gradients across them,
            which is the single-device fit up to fp32 rounding. Every
            rank of the mesh makes the same calls with the same data.
        camera: a models.camera.Camera. Attaching one exposes the
            ``cam_*`` leaves; use :meth:`fit_pixels` so the rays follow
            the current pose every step.
    """

    def __init__(
        self,
        scene,
        param_names: Optional[Sequence[str]] = None,
        optimizer: Optional[Callable] = None,
        cfg: tr.TraceConfig = tr.TraceConfig(tri_method="auto",
                                             texture_filter="bilinear"),
        mesh=None,
        camera=None,
    ) -> None:
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh), "
                            f"got {type(mesh).__name__}")
        all_params = split_params(scene)
        if camera is not None:
            camera = camera.to(scene.device)
            for n in CAMERA_PARAMS:
                all_params[n] = getattr(camera, _CAM_FIELD[n])
        if param_names is None:
            param_names = tuple(all_params)
        unknown = set(param_names) - set(all_params)
        if unknown:
            raise ValueError(f"not differentiable leaves: {sorted(unknown)}")
        if "mat_mirror" in param_names and scene.n_segments < scene.max_depth + 1:
            # Scene.build trims a mirror-free scene to one segment, which
            # would leave d(image)/d(mirror) one-sided: a fitted mirror
            # could never grow from 0. The fit traces the full chain,
            # whatever the mirrors' values now.
            scene = dataclasses.replace(scene, live_depth=scene.max_depth + 1)
        self.base_scene = scene
        self.camera = camera
        self.mesh = mesh
        self.param_names = tuple(param_names)
        self._use_camera = any(n in _CAM_FIELD for n in self.param_names)
        if self._use_camera and camera is None:
            raise ValueError("camera params selected but no camera attached")
        self.params = {n: all_params[n].detach().clone().requires_grad_(True)
                       for n in self.param_names}
        self.optimizer = (optimizer or adam(1e-2))(list(self.params.values()))
        self.cfg = cfg
        self.step_count = 0

    def scene_with(self, params) -> object:
        """The base scene with ``params``' scene leaves merged in."""
        return merge_params(self.base_scene,
                            {k: v.detach() for k, v in
                             _scene_leaves(dict(params)).items()})

    def fitted_camera(self):
        """Camera at the current parameter values (pose-recovery output)."""
        if self.camera is None:
            return None
        return camera_with(self.camera, {k: v.detach()
                                         for k, v in self.params.items()})

    def _step(self, a, b, target, w, pixel_mode: bool) -> torch.Tensor:
        """One optimizer step on rays (a, b) = (o, d), or pixel
        coordinates (xs, ys) in pixel mode, and with a mesh this rank's
        share of them with its weights ``w``; returns the loss."""
        p = self.params
        scene = merge_params(self.base_scene, _scene_leaves(p))
        if "vertex_pos" in self.param_names:
            # moved vertices outgrow the build's boxes: refit them so the
            # culling stays conservative
            with torch.no_grad():
                scene = refit_accel(scene)
        if pixel_mode:
            o, d = camera_with(self.camera, p).primary_rays(a, b)
        else:
            o, d = a, b
        topo = tr.trace_topology(scene, o.detach(), d.detach(), self.cfg)
        c = tr.trace_shade(scene, o, d, topo, self.cfg)
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            loss = torch.mean((c - target) ** 2)
            loss.backward()
        else:
            loss = torch.sum(w[:, None] * (c - target) ** 2)
            loss.backward()
            loss = self._all_reduce(loss.detach(), w)
        self.optimizer.step()
        return loss.detach()

    def _all_reduce(self, loss, w) -> torch.Tensor:
        """Sum the loss, every gradient and ``sum(w)`` over the mesh in one
        ``all_reduce``; set each gradient to its sum over ``3 * sum(w)``
        and return the loss over the same."""
        params = list(self.params.values())
        flat = torch.cat([loss.reshape(1), w.sum().reshape(1)] + [
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in params])
        dist.all_reduce(flat, group=self.mesh.get_group())
        flat = flat / (3.0 * flat[1])
        off = 2
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p).clone()
            off += p.numel()
        return flat[0]

    def _shard(self, a, b, target):
        """This rank's share of (a, b, target) and its weights: the batch
        padded to the mesh with copies of its last row, weighted 0."""
        size, rank = self.mesh.size(), mesh_rank(self.mesh)
        R = a.shape[0]
        pad = -R % size
        w = torch.ones(R + pad, dtype=torch.float32, device=a.device)
        if pad:
            w[R:] = 0.0
        n = (R + pad) // size

        def part(x):
            x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
            return x[rank * n:(rank + 1) * n].contiguous()

        return part(a), part(b), part(target), part(w)

    def _run(self, a, b, target, steps: int, log_every: int,
             pixel_mode: bool = False) -> FitResult:
        dev = self.base_scene.device
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        w = None
        if self.mesh is not None:
            a, b, target, w = self._shard(a, b, target)
        losses = []
        for i in range(steps):
            losses.append(float(self._step(a, b, target, w, pixel_mode)))
            self.step_count += 1
            if log_every and i % log_every == 0:
                print(f"step {self.step_count}: loss={losses[-1]:.6f}")
        return FitResult(self.scene_with(self.params), losses,
                         {k: v.detach().clone() for k, v in self.params.items()},
                         camera=self.fitted_camera())

    def fit(self, o, d, target, steps: int = 100,
            log_every: int = 0) -> FitResult:
        """Run the optimizer for ``steps`` iterations against target colors
        [R, 3] for fixed rays (o, d) [R, 3]."""
        if self._use_camera:
            raise ValueError(
                "camera params are being optimized: rays must be "
                "regenerated from the current pose each step; use "
                "fit_pixels(xs, ys, target) instead of fit(o, d, target)")
        dev = self.base_scene.device
        o = torch.as_tensor(o, dtype=torch.float32, device=dev).contiguous()
        d = torch.as_tensor(d, dtype=torch.float32, device=dev).contiguous()
        return self._run(o, d, target, steps, log_every)

    def fit_pixels(self, xs, ys, target, steps: int = 100,
                   log_every: int = 0) -> FitResult:
        """Like :meth:`fit`, but for pixel coordinates xs, ys [R] (in any
        order; the CLI passes raster order): the rays are formed from the
        current camera every step, so gradients reach the ``cam_*``
        leaves."""
        if self.camera is None:
            raise ValueError("fit_pixels requires a camera")
        dev = self.base_scene.device
        xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
        ys = torch.as_tensor(ys, dtype=torch.float32, device=dev)
        return self._run(xs, ys, target, steps, log_every, pixel_mode=True)

    # --- checkpoint / resume --------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Write the parameters, the optimizer state and the step count to
        ``path/state.pt`` (the directory is created). With a mesh, rank 0
        of the mesh writes and every rank returns once it has."""
        if self.mesh is not None:
            if mesh_rank(self.mesh) == 0:
                self._save(path)
            dist.barrier(group=self.mesh.get_group())
        else:
            self._save(path)

    def _save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        torch.save({"params": {k: v.detach().cpu()
                               for k, v in self.params.items()},
                    "optimizer": self.optimizer.state_dict(),
                    "step_count": self.step_count},
                   os.path.join(path, CHECKPOINT_FILE))

    def restore_checkpoint(self, path: str) -> None:
        """Load what :meth:`save_checkpoint` wrote into this renderer,
        whose parameter names must be the checkpoint's."""
        state = torch.load(os.path.join(path, CHECKPOINT_FILE),
                           map_location="cpu", weights_only=True)
        if list(state["params"]) != list(self.params):
            raise ValueError(
                f"checkpoint holds {sorted(state['params'])}, this renderer "
                f"fits {sorted(self.params)}")
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(state["params"][k])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step_count"])
