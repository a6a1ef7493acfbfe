"""Hand a generator's arrays to the program: its public scene builders.

The arrays (``rtbench/scenes/common.py``) become the program's
``models.scene.Scene`` through ``set_camera``, ``add_light``,
``add_sphere``, ``add_plane`` and ``add_mesh``, and the program packs
and uploads them itself in ``Scene.build``. Nothing here computes what
the reference compares.
"""

from __future__ import annotations

import numpy as np


def _material(arrays: dict, i: int):
    from myraytracer_tpu_torch.models.material import Material

    return Material(ambient=tuple(float(x) for x in arrays["mat_ambient"][i]),
                    diffuse=tuple(float(x) for x in arrays["mat_diffuse"][i]),
                    specular=tuple(float(x) for x in arrays["mat_specular"][i]),
                    mirror=float(arrays["mat_mirror"][i]),
                    shininess=float(arrays["mat_shininess"][i]),
                    shadowable=bool(arrays["mat_shadowable"][i] > 0.5))


def port_scene(arrays: dict):
    """The program's host-side ``Scene`` holding these arrays."""
    from myraytracer_tpu_torch.models.mesh import TriangleMesh
    from myraytracer_tpu_torch.models.scene import Scene

    cam = arrays["camera"]
    s = Scene()
    s.set_camera(cam["eye"], cam["center"], cam["up"], cam["fovy"],
                 cam["width"], cam["height"])
    for p, c in zip(arrays["light_pos"], arrays["light_color"]):
        s.add_light(tuple(float(x) for x in p), tuple(float(x) for x in c))
    s.ambience = tuple(float(x) for x in arrays["ambience"])
    s.background = tuple(float(x) for x in arrays["background"])
    s.max_depth = int(arrays["max_depth"])
    for c, r, m in zip(arrays["sphere_center"], arrays["sphere_radius"],
                       arrays["sphere_mat"]):
        s.add_sphere(np.asarray(c, np.float32), float(r), _material(arrays, m))
    for c, n, m in zip(arrays["plane_center"], arrays["plane_normal"],
                       arrays["plane_mat"]):
        s.add_plane(np.asarray(c, np.float32), np.asarray(n, np.float64),
                    _material(arrays, m))
    for mesh in arrays["meshes"]:
        s.add_mesh(TriangleMesh(mesh["vertices"], mesh["faces"],
                                material=_material(arrays, mesh["mat"]),
                                draw_mode=int(mesh["mode"])))
    return s


def port_camera(cam: dict, device):
    """The program's ``Camera`` for a pose dict on ``device``."""
    from myraytracer_tpu_torch.models.camera import Camera

    return Camera.make(cam["eye"], cam["center"], cam["up"], cam["fovy"],
                       cam["width"], cam["height"], device=device)
