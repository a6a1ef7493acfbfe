"""Inverse-rendering demo on the PyTorch/CUDA port: recover scene
parameters from a target image.

The port's counterpart of examples/inverse_demo.py, on
myraytracer_tpu_torch: the same scene, the same perturbations and the
same outputs. It renders a target with the true parameters, perturbs the
sphere's diffuse colour and the light position and fits them back with
the differentiable renderer (fixed-hit-topology gradients), then
recovers a moved camera eye and a 10% zoom from the same target.

Run on the GPU:   python examples/inverse_demo_torch.py
Run on the CPU:   python examples/inverse_demo_torch.py --cpu
Outputs: inverse_target.png, inverse_init.png and inverse_fit.png in
``--out`` (default: the temporary directory), and the printed loss
curves.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene(res: int):
    from myraytracer_tpu_torch import Material, Scene

    s = Scene()
    s.set_camera(eye=(0, 1.2, 5.2), center=(0, 0.2, 0), up=(0, 1, 0),
                 fovy=42, width=res, height=res)
    s.add_light((2.5, 4.5, 4.0), (0.8, 0.8, 0.78))
    s.ambience = (0.25, 0.25, 0.25)
    s.background = (0.02, 0.02, 0.05)
    s.add_sphere((-0.2, 0.1, 0.3), 0.85, Material(
        diffuse=(0.7, 0.12, 0.08), specular=(0.4, 0.4, 0.4),
        shininess=40, mirror=0.15))
    s.add_plane((0, -0.75, 0), (0, 1, 0), Material(
        diffuse=(0.45, 0.45, 0.5), specular=(0.1, 0.1, 0.1), shininess=5))
    return s


def main(argv=None) -> dict:
    """Run the three fits; returns their losses (``materials``, ``pose``,
    ``zoom``) and the PNG paths (``pngs``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    ap.add_argument("--out", default=tempfile.gettempdir(),
                    help="directory of the PNGs")
    args = ap.parse_args(argv)

    import torch

    from myraytracer_tpu_torch.inverse import InverseRenderer, adam
    from myraytracer_tpu_torch.ops import tracer as tr
    from myraytracer_tpu_torch.ops.render import render
    from myraytracer_tpu_torch.utils.image import write_png

    device = "cpu" if args.cpu else "cuda"
    sc = build_scene(args.res)
    true_scene = sc.build(device=device)
    pngs = {name: os.path.join(args.out, f"inverse_{name}.png")
            for name in ("target", "init", "fit")}
    os.makedirs(args.out, exist_ok=True)
    target_img = render(true_scene, sc.camera, clamp=False)
    write_png(pngs["target"], np.clip(target_img.cpu().numpy(), 0, 1))

    # perturb: wrong material colours and a displaced light, the classic
    # inverse-rendering setting where fixed-hit-topology gradients are
    # exact (large geometric displacements need silhouette gradients,
    # which this estimator does not model)
    diffuse = true_scene.mat_diffuse.clone()
    diffuse[0] = torch.tensor([0.1, 0.5, 0.6], device=true_scene.device)
    start = dataclasses.replace(
        true_scene, mat_diffuse=diffuse,
        light_pos=true_scene.light_pos + torch.tensor(
            [[-1.0, 0.5, 0.0]], device=true_scene.device))
    write_png(pngs["init"], render(start, sc.camera).cpu().numpy())

    xs, ys = (g.reshape(-1) for g in sc.camera.pixel_grid(true_scene.device))
    o, d = sc.camera.primary_rays(xs, ys)
    target = target_img.reshape(-1, 3)

    inv = InverseRenderer(start, param_names=("mat_diffuse", "light_pos"),
                          cfg=tr.TraceConfig())
    res = inv.fit(o, d, target, steps=args.steps, log_every=20)
    fit_img = render(res.scene, sc.camera).cpu().numpy()
    write_png(pngs["fit"], fit_img)

    true_c = true_scene.mat_diffuse[0].cpu().numpy()
    fit_c = res.params["mat_diffuse"][0].cpu().numpy()
    true_p = true_scene.light_pos[0].cpu().numpy()
    fit_p = res.params["light_pos"][0].cpu().numpy()
    print(f"loss: {res.losses[0]:.5f} -> {res.losses[-1]:.6f}")
    print(f"sphere diffuse: true {true_c.round(3)} fit {fit_c.round(3)}")
    print(f"light position: true {true_p.round(3)} fit {fit_p.round(3)}")
    err = float(np.abs(np.clip(fit_img, 0, 1)
                       - np.clip(target_img.cpu().numpy(), 0, 1)).mean())
    print(f"mean image error after fit: {err:.4f}")
    if res.losses[-1] > res.losses[0] * 0.05:
        print("WARNING: fit did not converge to <5% of the initial loss",
              file=sys.stderr)

    # stage 2: camera pose recovery from the same target; the camera's
    # eye, center, up and fovy are parameters, and the primary rays carry
    # their gradients
    wrong_cam = dataclasses.replace(
        sc.camera, eye=sc.camera.eye + torch.tensor([0.25, -0.2, 0.1]))
    inv_cam = InverseRenderer(true_scene, param_names=("cam_eye",),
                              optimizer=adam(2e-2), camera=wrong_cam,
                              cfg=tr.TraceConfig())
    res_cam = inv_cam.fit_pixels(xs, ys, target,
                                 steps=max(60, args.steps // 2),
                                 log_every=20)
    true_eye = sc.camera.eye.cpu().numpy()
    fit_eye = res_cam.params["cam_eye"].cpu().numpy()
    print(f"pose loss: {res_cam.losses[0]:.5f} -> {res_cam.losses[-1]:.6f}")
    print(f"camera eye: true {true_eye.round(3)} "
          f"start {wrong_cam.eye.cpu().numpy().round(3)} "
          f"fit {fit_eye.round(3)}")
    if float(np.abs(fit_eye - true_eye).max()) > 0.05:
        print("WARNING: camera pose did not recover to within 0.05",
              file=sys.stderr)

    # stage 3: zoom (fovy) recovery through the same pixel loss
    wrong_fovy_cam = dataclasses.replace(sc.camera,
                                         fovy=sc.camera.fovy * 1.10)
    inv_fovy = InverseRenderer(true_scene, param_names=("cam_fovy",),
                               optimizer=adam(1e-1), camera=wrong_fovy_cam,
                               cfg=tr.TraceConfig())
    res_fovy = inv_fovy.fit_pixels(xs, ys, target,
                                   steps=max(120, args.steps), log_every=40)
    true_fovy = float(sc.camera.fovy)
    fit_fovy = float(res_fovy.params["cam_fovy"])
    print(f"zoom loss: {res_fovy.losses[0]:.5f} -> "
          f"{res_fovy.losses[-1]:.6f}")
    print(f"fovy: true {true_fovy:.2f} start {float(wrong_fovy_cam.fovy):.2f}"
          f" fit {fit_fovy:.2f}")
    if abs(fit_fovy - true_fovy) > 0.3:
        print("WARNING: fovy did not recover to within 0.3 deg",
              file=sys.stderr)
    return {"materials": res.losses, "pose": res_cam.losses,
            "zoom": res_fovy.losses, "pngs": pngs}


if __name__ == "__main__":
    main()
