"""Two small scenes that put every hit kind and textures on screen (NumPy).

``mixed_scene``: a sphere, a plane, a cylinder and a triangle mesh, two
lights, optional mirrors. ``textured_scene``: two textured quads with odd
texture sizes (the rounding and clamping of the nearest-texel fetch) and
an untextured mesh. Both are the reference's shading test scenes
(``tests/test_pallas_shade.py``). They check the analytic and texture
branches of the kernels, which the office does not reach.

``api`` is the authoring API, (Scene, Material, TriangleMesh, PHONG,
FLAT, uv_sphere), the port's by default: a comparison can author the same
scene with another package's classes.
"""

from __future__ import annotations

import numpy as np

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, PHONG, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

PORT_API = (Scene, Material, TriangleMesh, PHONG, FLAT, uv_sphere)


def mixed_scene(mirror: float = 0.0, cyl: bool = True, tris: bool = True,
                w: int = 40, h: int = 40, api=PORT_API):
    """Triangles + sphere + plane (+ cylinder): every hit kind on screen."""
    S, Mat, Mesh, phong, _, sphere = api
    s = S()
    s.set_camera(eye=(0, 1.2, 5.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=55, width=w, height=h)
    s.add_light((3, 5, 4), (0.8, 0.75, 0.7))
    s.add_light((-2, 3, 2), (0.25, 0.25, 0.35))
    s.ambience = (0.15, 0.15, 0.18)
    s.background = (0.04, 0.07, 0.12)
    s.max_depth = 2
    s.add_sphere((-1.1, 0.1, 0.4), 0.6, Mat(
        diffuse=(0.2, 0.3, 0.7), specular=(0.6, 0.6, 0.6), shininess=40,
        mirror=mirror))
    s.add_plane((0, -0.9, 0), (0, 1, 0), Mat(
        diffuse=(0.5, 0.5, 0.45), mirror=mirror * 0.5))
    if cyl:
        s.add_cylinder((1.6, -0.3, -0.5), (0.1, 1, 0.15), 0.35, 1.4,
                       Mat(diffuse=(0.6, 0.5, 0.2), specular=(0.3,) * 3,
                           shininess=12))
    if tris:
        v, f = sphere(0.55, 7, 11, center=(0.4, 0.0, 0.8))
        s.add_mesh(Mesh(v, f, material=Mat(
            diffuse=(0.6, 0.2, 0.2), specular=(0.4,) * 3, shininess=25,
            mirror=mirror), draw_mode=phong))
    return s


def textured_scene(w: int = 40, h: int = 40, api=PORT_API):
    """Two textured quads (13x9 and 6x17 texels) + an untextured mesh."""
    S, Mat, Mesh, phong, flat, sphere = api
    s = S()
    s.set_camera(eye=(0, 0.4, 4.0), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=50, width=w, height=h)
    s.add_light((2, 3, 4), (0.9, 0.85, 0.8))
    s.ambience = (0.25, 0.25, 0.25)
    s.background = (0.1, 0.05, 0.15)

    def quad(cx, cy, size, tex):
        fv = np.asarray([[cx - size, cy - size, 0], [cx + size, cy - size, 0],
                         [cx + size, cy + size, 0], [cx - size, cy + size, 0]],
                        np.float32)
        ff = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        return Mesh(fv, ff, material=Mat(
            diffuse=(1, 0, 1), specular=(0.2,) * 3, shininess=10),
            uv_indices=ff, u_coords=np.float32([0, 1, 1, 0]),
            v_coords=np.float32([0, 0, 1, 1]), texture=tex, draw_mode=flat)

    rng = np.random.RandomState(7)
    s.add_mesh(quad(-0.8, 0.0, 0.7, rng.rand(13, 9, 3).astype(np.float32)))
    s.add_mesh(quad(0.9, 0.2, 0.6, rng.rand(6, 17, 3).astype(np.float32)))
    v, f = sphere(0.35, 6, 9, center=(0.0, -0.5, 1.2))
    s.add_mesh(Mesh(v, f, material=Mat(
        diffuse=(0.3, 0.6, 0.3), specular=(0.3,) * 3, shininess=20),
        draw_mode=phong))
    return s
