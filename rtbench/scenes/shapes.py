"""Procedural triangle-mesh primitives (NumPy): a frozen copy.

Copied from the port's ``scenes/shapes.py`` (the functions the office
and molecule generators call), so that the benchmark's scenes stay as
they are measured whatever later changes the program's copy. Every
generator returns (vertices [V, 3] float32, faces [T, 3] int32).
"""

from __future__ import annotations

import numpy as np


def uv_sphere(radius: float, n_lat: int, n_lon: int, center=(0, 0, 0)):
    """Latitude/longitude sphere mesh."""
    cx, cy, cz = center
    verts = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append([
                cx + radius * np.sin(theta) * np.cos(phi),
                cy + radius * np.cos(theta),
                cz + radius * np.sin(theta) * np.sin(phi),
            ])
    verts = np.asarray(verts, np.float32)

    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    return verts, np.asarray(faces, np.int32)


def box(size=(1, 1, 1), center=(0, 0, 0)):
    """Axis-aligned box, 12 triangles, outward normals."""
    sx, sy, sz = (s / 2 for s in size)
    cx, cy, cz = center
    v = np.asarray(
        [
            [-sx, -sy, -sz], [sx, -sy, -sz], [sx, sy, -sz], [-sx, sy, -sz],
            [-sx, -sy, sz], [sx, -sy, sz], [sx, sy, sz], [-sx, sy, sz],
        ],
        np.float32,
    ) + np.float32([cx, cy, cz])
    f = np.asarray(
        [
            [0, 2, 1], [0, 3, 2],      # -z
            [4, 5, 6], [4, 6, 7],      # +z
            [0, 1, 5], [0, 5, 4],      # -y
            [3, 7, 6], [3, 6, 2],      # +y
            [0, 4, 7], [0, 7, 3],      # -x
            [1, 2, 6], [1, 6, 5],      # +x
        ],
        np.int32,
    )
    return v, f


def cylinder(radius: float, height: float, n_seg: int, center=(0, 0, 0), capped=True):
    """Y-axis cylinder with optional caps."""
    cx, cy, cz = center
    verts = []
    for sign in (-0.5, 0.5):
        y = cy + sign * height
        for j in range(n_seg):
            a = 2 * np.pi * j / n_seg
            verts.append([cx + radius * np.cos(a), y, cz + radius * np.sin(a)])
    bot_c = len(verts)
    verts.append([cx, cy - height / 2, cz])
    top_c = len(verts)
    verts.append([cx, cy + height / 2, cz])
    verts = np.asarray(verts, np.float32)

    faces = []
    for j in range(n_seg):
        a = j
        b = (j + 1) % n_seg
        c = n_seg + j
        d = n_seg + (j + 1) % n_seg
        faces.append([a, c, b])
        faces.append([b, c, d])
        if capped:
            faces.append([a, b, bot_c])
            faces.append([c, d, top_c][::-1])
    return verts, np.asarray(faces, np.int32)


def merge(*meshes):
    """Concatenate (verts, faces) pairs with index rebasing."""
    vs, fs = [], []
    base = 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + base)
        base += v.shape[0]
    return np.concatenate(vs), np.concatenate(fs)


def transformed(v, scale=1.0, rotate_y: float = 0.0, translate=(0, 0, 0)):
    """Uniform scale -> y-rotation (radians) -> translate."""
    out = np.asarray(v, np.float32) * scale
    if rotate_y:
        c, s = np.cos(rotate_y), np.sin(rotate_y)
        rot = np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        out = out @ rot.T
    return out + np.float32(translate)
