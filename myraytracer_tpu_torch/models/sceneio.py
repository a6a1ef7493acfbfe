"""Text scene files: reader and writer.

Counterpart of ``myraytracer_tpu/models/sceneio.py``, building the port's
``Scene``. The grammar:

    # comment
    camera  ex ey ez  cx cy cz  ux uy uz  fovy  width height
    light   px py pz  r g b                      (repeatable)
    background r g b
    ambience   r g b
    depth      n
    plane    cx cy cz  nx ny nz  <material>
    sphere   cx cy cz  radius    <material>
    cylinder cx cy cz  ax ay az  radius height  <material>
    mesh     <relpath.obj|.off>  FLAT|PHONG  [texture.png]

    <material> = ar ag ab  dr dg db  sr sg sb  shininess mirror [shadow01]

Values are whitespace-separated and a directive may span lines. Mesh and
texture paths resolve relative to the scene file.
"""

from __future__ import annotations

import os
from typing import List

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, PHONG
from myraytracer_tpu_torch.models.objio import read_mesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.utils.image import read_png

#: the directive words of the grammar
DIRECTIVES = frozenset({"camera", "light", "background", "ambience", "depth",
                        "plane", "sphere", "cylinder", "mesh"})


class SceneParseError(ValueError):
    pass


def read_scene(path: str) -> Scene:
    """Parse a scene file into a host Scene (meshes loaded from disk)."""
    base = os.path.dirname(os.path.abspath(path))
    tokens: List[str] = []
    with open(path) as f:
        for line in f:
            tokens.extend(line.split("#", 1)[0].split())

    scene = Scene()
    i = 0

    def take(n: int) -> List[str]:
        nonlocal i
        if i + n > len(tokens):
            raise SceneParseError(f"{path}: unexpected end of file")
        out = tokens[i:i + n]
        i += n
        return out

    def floats(n: int):
        try:
            return [float(t) for t in take(n)]
        except ValueError as e:
            raise SceneParseError(f"{path}: {e}") from None

    def material() -> Material:
        nonlocal i
        vals = floats(11)
        shadow = True
        # an optional trailing shadow flag: 0 or 1 before the next
        # directive (or the end of the file)
        if (i < len(tokens) and tokens[i] in ("0", "1")
                and (i + 1 >= len(tokens) or tokens[i + 1] in DIRECTIVES)):
            shadow = tokens[i] == "1"
            i += 1
        return Material(
            ambient=tuple(vals[0:3]), diffuse=tuple(vals[3:6]),
            specular=tuple(vals[6:9]), shininess=vals[9], mirror=vals[10],
            shadowable=shadow,
        )

    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok == "camera":
            v = floats(12)
            scene.set_camera(eye=v[0:3], center=v[3:6], up=v[6:9],
                             fovy=v[9], width=int(v[10]), height=int(v[11]))
        elif tok == "light":
            v = floats(6)
            scene.add_light(v[0:3], v[3:6])
        elif tok == "background":
            scene.background = tuple(floats(3))
        elif tok == "ambience":
            scene.ambience = tuple(floats(3))
        elif tok == "depth":
            scene.max_depth = int(floats(1)[0])
        elif tok == "plane":
            v = floats(6)
            scene.add_plane(v[0:3], v[3:6], material())
        elif tok == "sphere":
            v = floats(4)
            scene.add_sphere(v[0:3], v[3], material())
        elif tok == "cylinder":
            v = floats(8)
            scene.add_cylinder(v[0:3], v[3:6], v[6], v[7], material())
        elif tok == "mesh":
            fn, mode = take(2)
            mode_i = {"FLAT": FLAT, "PHONG": PHONG}.get(mode)
            if mode_i is None:
                raise SceneParseError(f"{path}: bad draw mode {mode!r}")
            texture = None
            if i < len(tokens) and tokens[i] not in DIRECTIVES:
                texture = read_png(os.path.join(base, take(1)[0]))
            scene.add_mesh(read_mesh(os.path.join(base, fn),
                                     draw_mode=mode_i, texture=texture))
        else:
            raise SceneParseError(f"{path}: unknown directive {tok!r}")
    return scene


def write_scene(path: str, scene: Scene, mesh_files=None) -> None:
    """Write a Scene's camera, globals, lights and analytic primitives to a
    scene file. Meshes go by reference: ``mesh_files`` lists (relpath,
    "FLAT" or "PHONG") of mesh files already on disk."""

    def nums(*xs) -> str:
        return " ".join(f"{float(x):g}" for x in xs)

    def mat(m: Material) -> str:
        return (nums(*m.ambient, *m.diffuse, *m.specular, m.shininess,
                     m.mirror) + f" {1 if m.shadowable else 0}")

    cam = scene.camera
    with open(path, "w") as f:
        f.write("# myraytracer scene\n")
        pose = (*cam.eye.tolist(), *cam.center.tolist(), *cam.up.tolist())
        f.write(f"camera {nums(*pose, float(cam.fovy))} {cam.width} "
                f"{cam.height}\n")
        f.write(f"background {nums(*scene.background)}\n")
        f.write(f"ambience {nums(*scene.ambience)}\n")
        f.write(f"depth {scene.max_depth}\n")
        for light in scene.lights:
            f.write(f"light {nums(*light.position, *light.color)}\n")
        for c, r, m in scene._spheres:
            f.write(f"sphere {nums(*c, r)} {mat(m)}\n")
        for c, n, m in scene._planes:
            f.write(f"plane {nums(*c, *n)} {mat(m)}\n")
        for c, a, r, h, m in scene._cylinders:
            f.write(f"cylinder {nums(*c, *a, r, h)} {mat(m)}\n")
        for fn, mode in (mesh_files or []):
            f.write(f"mesh {fn} {mode}\n")
