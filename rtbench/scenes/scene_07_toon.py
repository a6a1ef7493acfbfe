"""The toon heads (golden o_07): a frozen copy of the port's scene builder.

``scene_07_toon_faces`` is copied from the port's ``scenes/golden.py``,
with its helpers ``_toon_heads``, ``_ell``, ``_rot_xyz`` and ``_Parts``
(the port's ``scenes/golden.py``); it authors through
:class:`common.Builder` instead of the port's ``Scene``, with this
package's frozen ``shapes.py``, and nothing else changed: six PHONG
heads, each one mesh of ellipsoid parts (19,680 triangles), over a green
mirror plane (mirror 0.08), two lights, ``max_depth`` 3 (4 Whitted
segments). :func:`generate` returns the scene as plain arrays
(common.py).
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import shapes
from rtbench.scenes.common import PHONG, Builder, Material


def generate(width: int, height: int) -> dict:
    """The toon heads at ``width`` x ``height``."""
    s = scene_07_toon_faces()
    s.camera.update(width=int(width), height=int(height))
    return s.arrays()


def _rot_xyz(v, rx=0.0, ry=0.0, rz=0.0):
    """Rotate [N,3] verts by Rx then Ry then Rz (radians)."""
    if rx:
        c, s = np.cos(rx), np.sin(rx)
        v = v @ np.float32([[1, 0, 0], [0, c, -s], [0, s, c]]).T
    if ry:
        c, s = np.cos(ry), np.sin(ry)
        v = v @ np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]]).T
    if rz:
        c, s = np.cos(rz), np.sin(rz)
        v = v @ np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    return v.astype(np.float32)


def _ell(center, radii, n=16, rx=0.0, ry=0.0, rz=0.0, taper=0.0):
    """Ellipsoid part; taper>0 narrows the +y end (cones, ears, horns)."""
    v, f = shapes.uv_sphere(1.0, n, n)
    if taper:
        tfac = 1.0 - taper * np.clip(v[:, 1], 0, 1)
        v = v * np.stack([tfac, np.ones_like(tfac), tfac], 1)
    v = v * np.float32(radii)
    v = _rot_xyz(v, rx, ry, rz) + np.float32(center)
    return v.astype(np.float32), f


class _Parts:
    """Accumulates mesh parts per material, merging on emit."""

    def __init__(self, scene: Builder):
        self.scene = scene
        self.groups: dict = {}

    def add(self, mat_key, mat, vf):
        self.groups.setdefault(mat_key, (mat, []))[1].append(vf)

    def emit(self, translate=(0, 0, 0), ry=0.0, scale=1.0):
        for mat, parts in self.groups.values():
            v, f = shapes.merge(*parts)
            v = (v * np.float32(scale)).astype(np.float32)
            v = shapes.transformed(v, rotate_y=ry, translate=translate)
            self.scene.add_mesh(v, f, mat, PHONG)
        self.groups.clear()


def _toon_heads():
    """Six sculpted toon heads (the o_07 golden is six character heads
    with ears/muzzles/paws, outputs/o_07_toon_faces.png —
    not featureless blobs). Each is a single-material compound of
    ellipsoid parts; features are geometric so Phong shading and the
    silhouette carry them. Returns a list of (parts, color) where parts
    is a list of _ell(...) tuples in a head-local frame (facing +z,
    resting near y=0)."""
    heads = []

    # 1. teal: cat curled on the ground — squashed body ball, head ball
    # resting on it, two pointy ears, tail ridge curling around the base
    cat = [
        _ell((0, 0.02, 0), (0.62, 0.5, 0.55)),                       # body
        _ell((0.18, 0.28, 0.28), (0.36, 0.32, 0.3)),                 # head
        _ell((0.0, 0.56, 0.22), (0.1, 0.2, 0.07), rz=0.35, taper=0.6),   # ear
        _ell((0.38, 0.54, 0.2), (0.1, 0.2, 0.07), rz=-0.35, taper=0.6),  # ear
        _ell((-0.45, -0.28, 0.3), (0.34, 0.12, 0.12), ry=0.5),       # tail
        _ell((0.14, 0.26, 0.56), (0.14, 0.1, 0.1)),                  # muzzle
    ]
    heads.append((cat, (0.15, 0.6, 0.7)))

    # 2. cream: tall rounded skull, two small round ears on top, a big
    # forward muzzle with nostril bumps and a heavy brow (Scooby-ish)
    scooby = [
        _ell((0, 0.3, 0), (0.46, 0.62, 0.46)),                       # skull
        _ell((-0.3, 0.92, -0.05), (0.14, 0.18, 0.12)),               # ear
        _ell((0.3, 0.92, -0.05), (0.14, 0.18, 0.12)),                # ear
        _ell((0, 0.02, 0.34), (0.34, 0.28, 0.3)),                    # muzzle
        _ell((-0.08, 0.1, 0.62), (0.09, 0.07, 0.07)),                # nostril
        _ell((0.08, 0.1, 0.62), (0.09, 0.07, 0.07)),                 # nostril
        _ell((0, 0.52, 0.36), (0.3, 0.1, 0.14)),                     # brow
    ]
    heads.append((scooby, (0.8, 0.75, 0.45)))

    # 3. orange: droopy dog — round skull, LONG ears hanging down both
    # sides, big nose on a sagging muzzle
    droopy = [
        _ell((0, 0.32, 0), (0.45, 0.5, 0.45)),                       # skull
        _ell((-0.48, 0.22, 0), (0.13, 0.42, 0.2), rz=0.12),          # ear L
        _ell((0.48, 0.22, 0), (0.13, 0.42, 0.2), rz=-0.12),          # ear R
        _ell((0, 0.02, 0.3), (0.3, 0.32, 0.32)),                     # jowls
        _ell((0, 0.18, 0.6), (0.13, 0.11, 0.11)),                    # nose
        _ell((-0.16, 0.5, 0.34), (0.11, 0.09, 0.1)),                 # eye bump
        _ell((0.16, 0.5, 0.34), (0.11, 0.09, 0.1)),                  # eye bump
    ]
    heads.append((droopy, (0.85, 0.45, 0.1)))

    # 4. red: rabbity — round head with cheeks, two upright splayed
    # ears, little paws held together in front
    rabbit = [
        _ell((0, 0.26, 0), (0.42, 0.44, 0.4)),                       # head
        _ell((-0.2, 0.82, -0.02), (0.12, 0.34, 0.1), rz=0.28, taper=0.4),  # ear
        _ell((0.2, 0.82, -0.02), (0.12, 0.34, 0.1), rz=-0.28, taper=0.4), # ear
        _ell((-0.18, 0.1, 0.3), (0.16, 0.14, 0.14)),                 # cheek
        _ell((0.18, 0.1, 0.3), (0.16, 0.14, 0.14)),                  # cheek
        _ell((-0.1, -0.24, 0.34), (0.1, 0.12, 0.1)),                 # paw
        _ell((0.1, -0.24, 0.34), (0.1, 0.12, 0.1)),                  # paw
        _ell((0, -0.1, 0), (0.38, 0.3, 0.34)),                       # body
    ]
    heads.append((rabbit, (0.8, 0.12, 0.12)))

    # 5. purple: big-nose face turned aside — heavy brow, one pointed
    # ear up, a large nose pointing forward-down
    bignose = [
        _ell((0, 0.3, 0), (0.46, 0.52, 0.44), ry=-0.3),              # skull
        _ell((0.22, 0.8, -0.05), (0.12, 0.26, 0.09), rz=-0.4, taper=0.55),  # ear
        _ell((-0.1, 0.25, 0.46), (0.22, 0.18, 0.26), rx=0.35),       # nose
        _ell((-0.02, 0.52, 0.3), (0.3, 0.11, 0.15), ry=-0.2),        # brow
        _ell((0.05, -0.05, 0.25), (0.3, 0.22, 0.22)),                # jaw
    ]
    heads.append((bignose, (0.6, 0.2, 0.65)))

    # 6. blue: laughing head thrown back — tilted skull, wide-open jaw
    # notched away from it, pointy crest spikes on top
    laugher = [
        _ell((0, 0.34, -0.06), (0.42, 0.46, 0.4), rx=-0.5),          # skull (back)
        _ell((0, 0.02, 0.3), (0.3, 0.2, 0.28), rx=0.5),              # open jaw
        _ell((-0.05, 0.7, 0.18), (0.26, 0.12, 0.2), rx=-0.5),        # upper lip
        _ell((-0.22, 0.78, -0.18), (0.09, 0.22, 0.07), rz=0.55, taper=0.6),  # spike
        _ell((0.0, 0.84, -0.22), (0.09, 0.24, 0.07), rz=0.0, taper=0.6),     # spike
        _ell((0.24, 0.78, -0.18), (0.09, 0.22, 0.07), rz=-0.55, taper=0.6),  # spike
        _ell((-0.14, 0.52, 0.26), (0.1, 0.09, 0.09), rx=-0.4),       # eye bump
        _ell((0.14, 0.52, 0.26), (0.1, 0.09, 0.09), rx=-0.4),        # eye bump
    ]
    heads.append((laugher, (0.25, 0.2, 0.75)))
    return heads


def scene_07_toon_faces(scale: float = 1.0) -> Builder:
    """Six sculpted toon heads on a green mirror floor under a blue sky
    (outputs/o_07_toon_faces.png)."""
    s = Builder()
    # center y fits the golden's horizon line (round-4 pitch sweep:
    # 0.2 -> rows 2-3 carried a uniform +-0.1 horizon offset; 0.35 zeroes
    # it, mean cell delta 0.0588 -> 0.0456)
    s.set_camera(eye=(0, 1.1, 7.2), center=(0, 0.35, 0), up=(0, 1, 0),
                 fovy=38, width=int(600 * scale), height=int(300 * scale))
    # key light BEHIND the heads: the golden's shadows fall toward the
    # camera and its floor shows a broad specular patch behind the row.
    # Height 6 (not 9) puts the specular glow band at the golden's lower
    # position (round-4 sweep: mean cell delta 0.0722 -> 0.0588)
    s.add_light((0, 6, -6), (0.282, 0.58, 0.163))
    s.add_light((0, 8, 10), (0.31, 1.226, 0.621))   # front-top fill
    s.ambience = (0.536, 0.424, 0.433)
    s.background = (0.504, 0.712, 1.177)
    parts = _Parts(s)
    xs = np.linspace(-3.45, 3.45, 6)
    yaws = (0.5, 0.05, -0.05, 0.1, -0.45, -0.25)
    # per-head ambient/diffuse from the round-5 differentiable cell fit
    # (lights/ambience fitted jointly; specular+shininess frozen, floor
    # mirror kept at 0.12 so the golden's creature reflections survive:
    # fit-mirror 0.0294 vs kept 0.0371 vs unfitted 0.0454 mean delta)
    head_fit = [
        ((0.176, 0.28, 0.559), (0.0, 0.251, 0.0)),
        ((0.583, 0.962, 0.526), (0.0, 0.0, 0.0)),
        ((0.712, 0.755, 0.114), (0.0, 0.055, 0.258)),
        ((0.691, 0.0, 0.13), (0.0, 0.24, 0.24)),
        ((0.61, 0.0, 0.852), (0.0, 0.209, 0.0)),
        ((0.0, 0.0, 0.0), (0.412, 0.248, 0.698)),
    ]
    for (head, c), x, ry, (fa, fd) in zip(_toon_heads(), xs, yaws, head_fit):
        mat = Material(ambient=fa, diffuse=fd,
                       specular=(0.5, 0.5, 0.5), shininess=60)
        for vf in head:
            parts.add("head", mat, vf)
        parts.emit(translate=(x, -0.04, 0), ry=ry)
    # bright-center green mirror floor: low ambient darkens the frame
    # edges, a broad specular lobe lifts the band behind the heads like
    # the golden
    s.add_plane((0, -0.5, 0), (0, 1, 0), Material(
        ambient=(0.0, 0.0, 0.107), diffuse=(0.475, 0.486, 0.288),
        specular=(0.25, 0.9, 0.25), shininess=8, mirror=0.08))
    s.max_depth = 3
    return s
