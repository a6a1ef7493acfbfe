"""The mirror corridor (golden o_03): a frozen copy of the port's scene
builder.

``scene_03_mirror`` is copied from the port's ``scenes/golden.py``; it
authors through :class:`common.Builder` instead of the port's ``Scene``,
and nothing else changed: one mirror sphere between two facing mirror
walls (not shadowable) at x = +-2.4, a 40-triangle FLAT fan floor, one
light, ``max_depth`` 20 (21 Whitted segments). :func:`generate` returns
the scene as plain arrays (common.py).
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes.common import FLAT, Builder, Material


def generate(width: int, height: int) -> dict:
    """The corridor at ``width`` x ``height``."""
    s = scene_03_mirror()
    s.camera.update(width=int(width), height=int(height))
    return s.arrays()


def scene_03_mirror(scale: float = 1.0) -> Builder:
    """Infinite mirror corridor: one red sphere between two facing mirror
    walls over a flat-shaded fan floor — deep mirror-chain stress test."""
    s = Builder()
    s.set_camera(eye=(-2.2, 0.5, 1.4), center=(2.4, 0.05, -0.35), up=(0, 1, 0),
                 fovy=55, width=int(1000 * scale), height=int(400 * scale))
    # round-5 cell fit (lights/ambience/ambient/diffuse; the corridor's
    # wall mirror is KEPT high — the fit's 0.39 would fade the golden's
    # signature receding reflections: fit-m 0.0177 vs kept 0.0256 vs
    # unfitted 0.0341 mean; the fold keeps the corridor)
    s.add_light((0, 6, 2), (0.456, 0.48, 0.48))
    s.ambience = (0.226, 0.124, 0.124)
    s.background = (0, 0, 0)
    s.add_sphere((0.5, -0.17, -0.2), 0.28, Material(
        ambient=(0.40, 0.22, 0.22), diffuse=(0.701, 0, 0),
        specular=(0.5, 0.5, 0.5), shininess=60, mirror=0.2))
    # two facing mirror walls perpendicular to x: the camera looks down the
    # corridor, so reflections repeat the sphere in a receding row
    # faint wall diffuse: the golden's 'black' upper half reads ~0.03-0.06
    # gray (mirror-bounced floor light), not true black (round-4 cell fit)
    wall = Material(ambient=(0.19, 0.176, 0.176), diffuse=(0.079, 0.146, 0.146),
                    specular=(0, 0, 0), shininess=1, mirror=0.75, shadowable=False)
    s.add_plane((2.4, 0, 0), (-1, 0, 0), wall)
    s.add_plane((-2.4, 0, 0), (1, 0, 0), wall)
    # flat-shaded fan disc floor (faceted look of the golden)
    n_seg, rad = 40, 60.0
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    rim = np.stack([np.cos(ang) * rad, np.full(n_seg, -0.55), np.sin(ang) * rad], 1)
    verts = np.concatenate([[[0, -0.55, 0]], rim]).astype(np.float32)
    faces = np.asarray([[0, 1 + (i + 1) % n_seg, 1 + i] for i in range(n_seg)], np.int32)
    # the golden's floor is specular-dominated: bright under the camera,
    # fading toward the horizon (no distance attenuation in this Phong
    # model, so the radial gradient must come from the broad lobe)
    s.add_mesh(verts, faces, Material(
        ambient=(0.313, 0.079, 0.079), diffuse=(0.506, 0.61, 0.61),
        specular=(0.55, 0.55, 0.55), shininess=2), FLAT)
    s.max_depth = 20
    return s
