"""The authoring surface of the frozen scene generators, as plain arrays.

The generators under ``rtbench/scenes/`` are frozen copies of the port's
golden builders. They author through :class:`Builder`, which mirrors the
calls of the port's ``Scene`` (``set_camera``, ``add_light``,
``add_sphere``, ``add_plane``, ``add_mesh``) but only records them.
:meth:`Builder.arrays` returns the scene as a dict of NumPy arrays and
numbers, which the harness hands to the port (``rtbench/port_scene.py``)
and to the plain reference (``rtbench/reference/``) alike.

The material table is deduplicated as the authoring model defines it:
identical materials share one row, numbered in the order spheres, then
planes, then meshes first use them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

#: mesh shading modes: one face normal, or interpolated vertex normals
FLAT = 0
PHONG = 1


@dataclasses.dataclass
class Material:
    """Phong material: colours, mirror share, shininess, shadow flag."""

    ambient: tuple = (0.1, 0.1, 0.1)
    diffuse: tuple = (0.7, 0.7, 0.7)
    specular: tuple = (0.0, 0.0, 0.0)
    mirror: float = 0.0
    shininess: float = 1.0
    shadowable: bool = True

    def key(self) -> tuple:
        return (tuple(float(x) for x in self.ambient),
                tuple(float(x) for x in self.diffuse),
                tuple(float(x) for x in self.specular), float(self.mirror),
                float(self.shininess), bool(self.shadowable))


@dataclasses.dataclass
class Mesh:
    """One triangle mesh as authored: vertices, faces, material, mode."""

    vertices: np.ndarray
    faces: np.ndarray
    material: Material
    mode: int


class Builder:
    """Records what a golden builder authors (the port's Scene's calls)."""

    def __init__(self) -> None:
        self.camera = None
        self.lights: List[tuple] = []
        self.background = (0.0, 0.0, 0.0)
        self.ambience = (0.2, 0.2, 0.2)
        self.max_depth = 3
        self.spheres: List[tuple] = []
        self.planes: List[tuple] = []
        self.meshes: List[Mesh] = []

    def set_camera(self, eye, center, up, fovy, width, height) -> "Builder":
        self.camera = dict(eye=tuple(float(x) for x in eye),
                           center=tuple(float(x) for x in center),
                           up=tuple(float(x) for x in up), fovy=float(fovy),
                           width=int(width), height=int(height))
        return self

    def add_light(self, position, color) -> "Builder":
        self.lights.append((tuple(position), tuple(color)))
        return self

    def add_sphere(self, center, radius: float, material: Material
                   ) -> "Builder":
        self.spheres.append((np.asarray(center, np.float32), float(radius),
                             material))
        return self

    def add_plane(self, center, normal, material: Material) -> "Builder":
        self.planes.append((np.asarray(center, np.float32),
                            np.asarray(normal, np.float64), material))
        return self

    def add_mesh(self, vertices, faces, material: Material, mode: int
                 ) -> "Builder":
        self.meshes.append(Mesh(np.asarray(vertices, np.float32).reshape(-1, 3),
                                np.asarray(faces, np.int32).reshape(-1, 3),
                                material, int(mode)))
        return self

    def arrays(self) -> Dict[str, object]:
        """The scene as plain arrays (layout in the module doc)."""
        mats: List[Material] = []
        index: Dict[tuple, int] = {}

        def mat_id(m: Material) -> int:
            k = m.key()
            if k not in index:
                index[k] = len(mats)
                mats.append(m)
            return index[k]

        sphere_mat = [mat_id(m) for _, _, m in self.spheres]
        plane_mat = [mat_id(m) for _, _, m in self.planes]
        mesh_mat = [mat_id(m.material) for m in self.meshes]
        f32 = np.float32
        return dict(
            camera=dict(self.camera),
            light_pos=np.asarray([p for p, _ in self.lights], f32).reshape(-1, 3),
            light_color=np.asarray([c for _, c in self.lights], f32).reshape(-1, 3),
            ambience=np.asarray(self.ambience, f32),
            background=np.asarray(self.background, f32),
            max_depth=int(self.max_depth),
            mat_ambient=np.asarray([m.ambient for m in mats], f32).reshape(-1, 3),
            mat_diffuse=np.asarray([m.diffuse for m in mats], f32).reshape(-1, 3),
            mat_specular=np.asarray([m.specular for m in mats], f32).reshape(-1, 3),
            mat_mirror=np.asarray([m.mirror for m in mats], f32),
            mat_shininess=np.asarray([m.shininess for m in mats], f32),
            mat_shadowable=np.asarray([1.0 if m.shadowable else 0.0
                                       for m in mats], f32),
            sphere_center=np.asarray([c for c, _, _ in self.spheres],
                                     f32).reshape(-1, 3),
            sphere_radius=np.asarray([r for _, r, _ in self.spheres], f32),
            sphere_mat=np.asarray(sphere_mat, np.int32),
            plane_center=np.asarray([c for c, _, _ in self.planes],
                                    f32).reshape(-1, 3),
            plane_normal=np.asarray([n for _, n, _ in self.planes],
                                    np.float64).reshape(-1, 3),
            plane_mat=np.asarray(plane_mat, np.int32),
            meshes=[dict(vertices=m.vertices, faces=m.faces, mat=mid,
                         mode=m.mode) for m, mid in zip(self.meshes, mesh_mat)],
        )
