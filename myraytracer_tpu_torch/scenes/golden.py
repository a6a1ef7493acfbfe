"""Procedural authoring of the ten golden scenes (NumPy) and the gallery.

The builders and their helpers are copied unchanged from
``myraytracer_tpu/scenes/golden.py``, so both packages build the same
packed arrays bit for bit. Resolutions match the committed goldens
(``outputs/o_*.png``):

  01 spheres 500x500   02 shadow 600x400    03 mirror 1000x400
  04 molecule 500x500  05 cube 500x500      06 mask 500x500
  07 toon_faces 600x300 08 office 500x500   09 rings 700x500
  10 pokemon 600x300

The office also renders at 1920x1080 (``resolution=``).

Gallery (renders each golden to a PNG, on the GPU unless ``--cpu``):

    python -m myraytracer_tpu_torch.scenes.golden --out DIR [--scale S]
        [--scene NAME] [--no-aa] [--cpu]
"""

from __future__ import annotations

import numpy as np

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import TriangleMesh, FLAT, PHONG
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.scenes import shapes


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _blob(radius, n_lat, n_lon, seed, bump=0.25, center=(0, 0, 0), squash=(1, 1, 1)):
    """Organic blob: a uv-sphere with smooth sinusoidal radial displacement."""
    v, f = shapes.uv_sphere(radius, n_lat, n_lon)
    rng = np.random.default_rng(seed)
    amps = rng.uniform(0.3, 1.0, 4) * bump * radius
    freqs = rng.uniform(1.0, 3.0, (4, 3))
    phases = rng.uniform(0, 2 * np.pi, 4)
    r = np.linalg.norm(v, axis=1, keepdims=True)
    disp = np.zeros(v.shape[0], np.float32)
    for a, fr, ph in zip(amps, freqs, phases):
        disp += a * np.sin(v @ fr.astype(np.float32) + ph)
    v = v * (1 + disp[:, None] / np.maximum(r, 1e-6))
    v = v * np.float32(squash) + np.float32(center)
    return v.astype(np.float32), f


def _tess_quad(p0, p1, p3, res_u, res_v):
    """Grid-tessellated parallelogram patch p0 + u*(p1-p0) + v*(p3-p0)."""
    p0 = np.float32(p0)
    du = (np.float32(p1) - p0)
    dv = (np.float32(p3) - p0)
    us, vs = np.meshgrid(np.linspace(0, 1, res_u + 1), np.linspace(0, 1, res_v + 1), indexing="ij")
    verts = p0 + us[..., None] * du + vs[..., None] * dv
    verts = verts.reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(res_u):
        for j in range(res_v):
            a = i * (res_v + 1) + j
            b = a + 1
            c = a + (res_v + 1)
            d = c + 1
            faces.append([a, c, b])
            faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)


def _sand_texture(w=768, h=384, seed=3):
    """Fine-grained sandy ground: multi-octave value noise + speckle."""
    rng = np.random.default_rng(seed)
    base = np.float32([0.62, 0.50, 0.35])
    acc = np.zeros((h, w), np.float32)
    for cells, amp in [(12, 0.05), (48, 0.04), (192, 0.03)]:
        coarse = rng.normal(0, 1, (cells + 1, cells * 2 + 1)).astype(np.float32)
        ys = np.linspace(0, cells, h)
        xs = np.linspace(0, cells * 2, w)
        yi = np.clip(ys.astype(int), 0, cells - 1)
        xi = np.clip(xs.astype(int), 0, cells * 2 - 1)
        fy = (ys - yi)[:, None]
        fx = (xs - xi)[None, :]
        c00 = coarse[yi][:, xi]
        c01 = coarse[yi][:, xi + 1]
        c10 = coarse[yi + 1][:, xi]
        c11 = coarse[yi + 1][:, xi + 1]
        acc += amp * ((1 - fy) * ((1 - fx) * c00 + fx * c01)
                      + fy * ((1 - fx) * c10 + fx * c11))
    grain = rng.normal(0, 0.035, (h, w, 3)).astype(np.float32)
    tex = base + acc[..., None] + grain
    # scattered darker pebbles
    n_peb = 900
    py = rng.integers(0, h, n_peb)
    px = rng.integers(0, w, n_peb)
    tex[py, px] *= rng.uniform(0.55, 0.85, (n_peb, 1)).astype(np.float32)
    # the golden's sand brightens toward the camera (bottom-center cells
    # read ~0.6 vs ~0.45 mid-ground); bake the falloff along v (quad v
    # increases toward the near edge) — round-4 cell-mean fit
    tex *= (1.0 + 0.4 * np.linspace(0, 1, h, dtype=np.float32))[:, None, None]
    # horizontal vignette: the golden's sand reads darker at both frame
    # edges (round-5 column-mean fit: ours +0.05..+0.10 at the edge
    # cells); u maps left-right in image
    u = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    tex *= 0.84 + 0.16 * np.exp(-(((u - 0.5) / 0.26) ** 2))
    return np.clip(tex, 0, 1)


def _starfield_texture(w=1024, h=512, seed=5):
    """Night sky: blue gradient + dense stars + a milky-way band."""
    rng = np.random.default_rng(seed)
    sky = np.zeros((h, w, 3), np.float32)
    grad = np.linspace(0.42, 0.10, h, dtype=np.float32)[:, None]
    sky[..., 2] = grad * 1.5 + 0.10
    sky[..., 1] = grad * 0.75 + 0.02
    sky[..., 0] = grad * 0.40
    # milky-way: a compact cyan-tinted glow at the golden's position.
    # The backdrop quad magnifies the texture ~3.4x (visible u range is
    # only [0.35, 0.65] of the 32-wide quad) and flips v, so the band
    # lives at texture (0.66h, 0.47w) with texture-space sigmas ~3x
    # smaller than the rendered ones — calibrated against the reference
    # PNG's top-row cell means (round 4: band deficit -0.18 at the top
    # band cell -> +-0.06 residual)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    band = (np.exp(-(((ys - 0.66 * h) / (0.09 * h)) ** 2))
            * np.exp(-(((xs - 0.47 * w) / (0.07 * w)) ** 2)))
    sky += (0.22 * band)[..., None] * np.float32([0.55, 0.95, 1.0])
    # horizontal vignette on the base gradient: the golden's sky falls
    # to ~0.15 at the frame edges while ours stayed ~0.25 (round-5
    # column-mean fit); the band itself is unaffected
    sky *= 0.70 + 0.30 * np.exp(-(((xs / w - 0.47) / 0.20) ** 2))[..., None]
    # stars: many faint, few bright, denser inside the band (bright
    # enough to survive the backdrop quad's n.l lighting attenuation)
    for n_stars, lo, hi in [(6500, 0.25, 0.6), (1400, 0.6, 1.0)]:
        xsr = rng.integers(0, w, n_stars)
        ysr = rng.integers(0, h, n_stars)
        keep = rng.uniform(0, 1, n_stars) < (0.45 + 0.55 * band[ysr, xsr])
        xsr, ysr = xsr[keep], ysr[keep]
        mag = rng.uniform(lo, hi, xsr.size).astype(np.float32)
        tint = np.stack([mag * rng.uniform(0.85, 1.0, xsr.size),
                         mag * rng.uniform(0.9, 1.0, xsr.size),
                         mag], 1).astype(np.float32)
        sky[ysr, xsr] = np.clip(sky[ysr, xsr] + tint, 0, 1)
    return np.clip(sky, 0, 1)


# --- compound-creature modeling helpers (o_10) ------------------------------

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

    def __init__(self, scene: Scene):
        self.scene = scene
        self.groups: dict = {}

    def add(self, mat_key, mat, vf):
        self.groups.setdefault(mat_key, (mat, []))[1].append(vf)

    def emit(self, translate=(0, 0, 0), ry=0.0, scale=1.0):
        for mat, parts in self.groups.values():
            v, f = shapes.merge(*parts)
            v = (v * np.float32(scale)).astype(np.float32)
            v = shapes.transformed(v, rotate_y=ry, translate=translate)
            self.scene.add_mesh(TriangleMesh(v, f, material=mat,
                                             draw_mode=PHONG))
        self.groups.clear()


def _creature_mat(col, spec=0.25, shin=30):
    return Material(ambient=tuple(0.4 * k for k in col),
                    diffuse=tuple(0.65 * k for k in col),
                    specular=(spec,) * 3, shininess=shin)


# ---------------------------------------------------------------------------
# the ten scenes
# ---------------------------------------------------------------------------

def scene_01_spheres(scale: float = 1.0) -> Scene:
    """Three mirror spheres (G/R/B, increasing size) on a dark mirror floor."""
    s = Scene()
    s.set_camera(eye=(0.0, 2.0, 7.6), center=(0.3, 0.45, 0), up=(0, 1, 0),
                 fovy=45, width=int(500 * scale), height=int(500 * scale))
    # distant high key: the golden's floor reads near-FLAT gray out to
    # the horizon, which a nearby point light cannot do (its n.l falls
    # off with distance) — round-4 cell-mean fit, mean delta
    # 0.0697 -> 0.0517
    # round-5 cell fit, re-run after the geometric solve below (mirrors
    # land at moderate 0.04-0.19 on their own; reflections survive);
    # mean cell delta 0.0328 -> 0.0225
    s.add_light((-30, 60, 50), (0.394, 0.23, 0.373))
    s.add_light((5, 6, 7), (0.015, 0.27, 0.409))
    s.ambience = (0.323, 0.434, 0.429)
    s.background = (0.016, 0.016, 0.011)
    # round-5 geometric solve: the three spheres' projected blob
    # centroids/radii measured in the golden vs ours, inverted under the
    # camera with a floor-contact constraint (depth-scaled so every
    # sphere still rests on the plane); mean cell delta 0.0398 -> 0.0328
    s.add_sphere((-1.78, -0.27, 1.61), 0.584, Material(
        ambient=(0.137, 0.023, 0.097), diffuse=(0, 1.8, 0),
        specular=(0.6, 0.6, 0.6), shininess=90, mirror=0.187))
    s.add_sphere((-0.67, 0.24, -0.63), 1.089, Material(
        ambient=(0, 0.058, 0.038), diffuse=(1.518, 0, 0),
        specular=(0.6, 0.6, 0.6), shininess=90, mirror=0.156))
    # the golden's blue is bright even on its unlit side: ambient-heavy
    s.add_sphere((2.42, 1.34, -0.14), 2.194, Material(
        ambient=(0, 0, 0.603), diffuse=(0.057, 0.053, 0.754),
        specular=(0.6, 0.6, 0.6), shininess=90, mirror=0.04))
    s.add_plane((0, -0.85, 0), (0, 1, 0),
                Material(ambient=(0.4, 0.323, 0.374), diffuse=(0.112, 0.056, 0),
                         specular=(0.45, 0.45, 0.45), shininess=5, mirror=0.092))
    s.max_depth = 3
    return s


def scene_02_shadow(scale: float = 1.0) -> Scene:
    """Dim three-sphere arrangement; single strong light, hard shadows."""
    s = Scene()
    s.set_camera(eye=(0, 0, 7), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=40, width=int(600 * scale), height=int(400 * scale))
    # the golden's light sits just beside the small red sphere: grazing
    # illumination on both big spheres and the red sphere's shadow cast
    # onto the blue limb
    # round-5 cell fit, adopted in full: the golden's "shadow" features
    # on the sphere limbs are really mirror REFLECTIONS of the other
    # spheres (dark ellipse on the blue limb, blue patch on the green),
    # which the fit recovers; mean cell delta 0.0224 -> 0.0127
    s.add_light((0.35, 0.05, 1.9), (1.645, 1.409, 0.888))
    s.ambience = (0.007, 0.277, 0.413)
    s.background = (0.0, 0.008, 0.0)
    # brightness fit against the reference cells (round 4, mean delta
    # 0.0345 -> 0.0222, max 0.179 -> 0.065): the golden's spheres are
    # DIM — near-black away from the grazing key light, with localized
    # specular pools — not broadly lit
    s.add_sphere((-4.6, 0, -0.6), 4.0, Material(
        ambient=(0, 0, 0.475), diffuse=(0.007, 0.008, 0.292),
        specular=(0.7, 0.7, 0.7), shininess=120))
    s.add_sphere((-0.3, -0.1, 1.2), 0.25, Material(
        ambient=(0.149, 0, 0), diffuse=(0.341, 0, 0),
        specular=(0.3, 0.3, 0.3), shininess=40, mirror=0.669))
    s.add_sphere((2.3, -0.3, -0.5), 1.6, Material(
        ambient=(0, 0.366, 0), diffuse=(0, 0.502, 0.051),
        specular=(0.4, 0.4, 0.4), shininess=60, mirror=0.73))
    s.max_depth = 2
    return s


def scene_03_mirror(scale: float = 1.0) -> Scene:
    """Infinite mirror corridor: one red sphere between two facing mirror
    walls over a flat-shaded fan floor — deep mirror-chain stress test."""
    s = Scene()
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
    s.add_mesh(TriangleMesh(verts, faces, material=Material(
        ambient=(0.313, 0.079, 0.079), diffuse=(0.506, 0.61, 0.61),
        specular=(0.55, 0.55, 0.55), shininess=2),
        draw_mode=FLAT))
    s.max_depth = 20
    return s


def scene_04_molecule(scale: float = 1.0, n_atoms: int = 800) -> Scene:
    """Space-filling 'protein': hundreds of CPK-colored spheres in a corner
    room with a glossy dark floor.

    Shape/palette parameters were fit against the reference PNG's 8x8
    cell means (round-4 sweep: mean cell delta 0.0719 -> 0.0333, max
    0.1908 -> 0.1256): the golden's blob is a *dense* space-filling
    cluster, which needs a short-step strongly-pulled walk (step 0.30,
    pull 0.96, 800 atoms, radius x1.15) rather than a loose chain."""
    s = Scene()
    s.set_camera(eye=(8.5, 2.3, 12.0), center=(0.6, 0.4, 0), up=(0, 1, 0),
                 fovy=40, width=int(500 * scale), height=int(500 * scale))
    # round-5 cell fit, ENVIRONMENT only (walls/floor/lights/ambience/
    # background): the full fit scored 0.0164 but turned the atoms into
    # translucent metallic bubbles (mirror 0.6-0.8) — perceptually wrong
    # vs the golden's solid CPK spheres, so atom materials stay authored
    # (env-only fold measured 0.0316 vs 0.0337)
    s.add_light((6, 7, 7), (0.567, 0.572, 0.465))
    s.add_light((-2, 5, 8), (0.0, 0.003, 0.0))
    s.ambience = (0.612, 0.618, 0.656)
    s.background = (1.009, 0.561, 0.525)

    # seed swept against the golden's cells in round 5 (42 best of 10:
    # 0.0279 vs seed-7's 0.0316 at the proxy scale)
    rng = np.random.default_rng(42)
    # random-walk backbone with side atoms, like a space-filling protein
    pos = [np.zeros(3)]
    for _ in range(n_atoms - 1):
        step = rng.normal(size=3)
        step[1] *= 0.55
        cand = pos[-1] + step * 0.30
        cand *= 0.96  # keep the blob compact
        pos.append(cand)
    pos = np.asarray(pos)
    pos -= pos.mean(0)
    pos *= np.float32([1.35, 1.05, 1.0])
    pos[:, 1] += 0.5

    cpk = [((0.85, 0.85, 0.85), 0.30, 0.55),   # C-ish gray
           ((0.95, 0.1, 0.1), 0.28, 0.18),     # O red
           ((0.2, 0.3, 0.9), 0.28, 0.12),      # N blue
           ((0.98, 0.98, 0.98), 0.22, 0.15)]   # H white
    probs = np.cumsum([c[2] for c in cpk])
    u = rng.uniform(0, 1, n_atoms)
    for i in range(n_atoms):
        k = int(np.searchsorted(probs, u[i] * probs[-1]))
        k = min(k, len(cpk) - 1)
        col, rad, _ = cpk[k]
        s.add_sphere(pos[i], rad * 1.15 * rng.uniform(0.85, 1.15), Material(
            ambient=tuple(0.38 * c for c in col), diffuse=tuple(0.82 * c for c in col),
            specular=(0.35, 0.35, 0.35), shininess=50))
    # corner walls + glossy floor; the left wall sits far out (x=-8) as a
    # dark strip, the back wall carries most of the gray — both measured
    # from the reference cell means (walls unshadowed: the golden keeps
    # its floor glow under the blob)
    s.add_plane((-8.0, 0, 0), (1, 0, 0), Material(
        ambient=(0.0, 0.0, 0.0), diffuse=(0.241, 0.235, 0.29), shadowable=False))
    s.add_plane((0, 0, -4.5), (0, 0, 1), Material(
        ambient=(0.438, 0.353, 0.342), diffuse=(0.127, 0.212, 0.246),
        shadowable=False))
    s.add_plane((0, -2.2, 0), (0, 1, 0), Material(
        ambient=(0.141, 0.114, 0.119), diffuse=(0.065, 0.123, 0.12),
        specular=(0.12, 0.12, 0.12), shininess=5, mirror=0.34))
    s.max_depth = 2
    return s


def scene_05_cube(scale: float = 1.0) -> Scene:
    """Single flat-shaded cube, blue sides / red top, white background."""
    s = Scene()
    s.set_camera(eye=(4.3, 2.6, 6.1), center=(0, -0.05, 0), up=(0, 1, 0),
                 fovy=36, width=int(500 * scale), height=int(500 * scale))
    # round-5 cell fit (mean 0.0185 -> 0.0158; mirrors dropped ~0.09 -> 0)
    s.add_light((6.5, 3.5, 3.0), (0.935, 0.847, 0.928))
    s.ambience = (0.463, 0.3, 0.228)
    s.background = (1.087, 1.081, 1.098)
    v, f = shapes.box((1.6, 1.6, 1.6))
    # split: top two faces red, rest blue (two meshes, one per material)
    top = np.asarray([6, 7], np.int32)      # +y faces in shapes.box order
    rest = np.asarray([i for i in range(12) if i not in (6, 7)], np.int32)
    s.add_mesh(TriangleMesh(v, f[rest], material=Material(
        ambient=(0.108, 0.178, 0.273), diffuse=(0.071, 0.095, 0.77), shininess=5),
        draw_mode=FLAT))
    s.add_mesh(TriangleMesh(v, f[top], material=Material(
        ambient=(0.525, 0.185, 0.314), diffuse=(0.928, 0.633, 0.66), shininess=5),
        draw_mode=FLAT))
    s.max_depth = 1
    return s


def _face_mask(res: int = 144):
    """Sculpted human face mask shell (the o_06 golden is a face, not a blob).

    A parametric (u, v) grid over the face region is lifted onto a convex
    shell and displaced by anatomical features: brow ridge, recessed eye
    sockets (with real holes cut so the black background shows through),
    nose bridge/tip/nostrils, lips with a mouth crease, chin and
    cheekbone bumps. The top edge gets a jagged hairline cut like the
    golden's broken rim.

    Returns (verts [N,3], faces [M,3]) in a unit-ish frame: x right,
    y up, z toward the viewer.
    """

    def g2(x, y, cx, cy, sx, sy):
        return np.exp(-(((x - cx) / sx) ** 2 + ((y - cy) / sy) ** 2))

    n = res
    u = np.linspace(-1.0, 1.0, n)
    vv = np.linspace(-1.3, 1.05, n)
    U, V = np.meshgrid(u, vv, indexing="ij")   # U across face, V up face

    # face outline half-width as a function of height: widest at the
    # cheekbones, tapering to a rounded chin and a slightly narrower crown
    wv = (0.62
          - 0.28 * np.clip(-V - 0.25, 0, None) ** 1.6    # taper to chin
          - 0.10 * np.clip(V - 0.45, 0, None) ** 2)      # slight crown taper
    X = U * wv
    Y = V * 0.92

    # convex shell: an ellipsoid-like dome; the rim curls backward so the
    # silhouette reads as a shell edge, not a flat sheet
    oval = 1.0 - (U * 0.92) ** 2 - (V / 1.35) ** 2
    dome = np.sqrt(np.clip(oval, 0.0, None))
    Z = 0.42 * dome - 0.22 * np.clip(-oval, 0.0, None)

    # --- anatomical displacement field (positive = toward viewer) ---
    F = np.zeros_like(Z)
    # forehead: broad smooth dome
    F += 0.06 * g2(X, Y, 0, 0.62, 0.55, 0.38)
    # brow ridge: wide bar above the eyes
    F += 0.055 * g2(X, Y, 0, 0.30, 0.42, 0.085) * (1 - 0.8 * g2(X, Y, 0, 0.30, 0.10, 0.2))
    # eye sockets: deep recession around each eye
    for sx in (-1, 1):
        F -= 0.11 * g2(X, Y, sx * 0.30, 0.17, 0.17, 0.105)
    # cheekbones
    for sx in (-1, 1):
        F += 0.05 * g2(X, Y, sx * 0.42, -0.08, 0.16, 0.16)
    # nose: bridge rising from between the eyes, widening to the tip
    nose_prof = np.clip((0.30 - Y) / 0.62, 0, 1)          # 0 at brow, 1 at tip
    nose_amp = 0.05 + 0.13 * nose_prof ** 1.5
    nose_w = 0.05 + 0.045 * nose_prof
    nose_band = np.exp(-(X / nose_w) ** 2)
    # smooth vertical envelope: full strength on the bridge, fading in
    # above the brow and below the tip (no hard cutoff -> no dark wedge)
    env = (1.0 / (1.0 + np.exp((Y - 0.32) / 0.04))
           * 1.0 / (1.0 + np.exp((-0.36 - Y) / 0.035)))
    F += nose_amp * nose_band * env
    # nose tip ball + nostril flares
    F += 0.06 * g2(X, Y, 0, -0.30, 0.075, 0.06)
    for sx in (-1, 1):
        F += 0.035 * g2(X, Y, sx * 0.10, -0.33, 0.042, 0.04)
        F -= 0.012 * g2(X, Y, sx * 0.06, -0.375, 0.025, 0.022)  # nostril shadow
    # philtrum groove
    F -= 0.015 * g2(X, Y, 0, -0.47, 0.035, 0.06)
    # lips: upper and lower ridges with a crease between
    F += 0.04 * g2(X, Y, 0, -0.55, 0.17, 0.035)
    F -= 0.016 * g2(X, Y, 0, -0.585, 0.15, 0.02)               # mouth line
    F += 0.042 * g2(X, Y, 0, -0.63, 0.13, 0.04)
    # chin
    F += 0.06 * g2(X, Y, 0, -0.88, 0.20, 0.14)
    # temples recess slightly
    for sx in (-1, 1):
        F -= 0.03 * g2(X, Y, sx * 0.60, 0.42, 0.14, 0.2)

    # features fade near the rim so the shell edge stays clean
    rim = np.clip((np.abs(U) - 0.78) / 0.22, 0, 1)
    Z = Z + F * (1 - rim ** 2) * dome ** 0.25

    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3).astype(np.float32)

    # grid faces
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            faces.append([a, c, b])
            faces.append([b, c, d])
    faces = np.asarray(faces, np.int32)

    # --- cuts: eye holes + jagged hairline ---
    cent = verts[faces].mean(axis=1)
    # outline cut: only keep cells on the shell (inside the face oval)
    oval_f = oval.reshape(-1)
    keep = np.all(oval_f[faces] > -0.16, axis=1)
    for sx in (-1, 1):
        ex = (cent[:, 0] - sx * 0.30) / 0.105
        ey = (cent[:, 1] - 0.175) / 0.048
        keep &= (ex ** 2 + ey ** 2) > 1.0
    # gently irregular crown: the reference's top edge is a rounded
    # crown with a few soft notches, not deep teeth
    rng = np.random.default_rng(17)
    n_teeth = 5
    knots = rng.uniform(-0.035, 0.015, n_teeth + 1).astype(np.float32)
    tpos = (cent[:, 0] / 1.3 + 0.5) * n_teeth
    k0 = np.clip(tpos.astype(np.int32), 0, n_teeth - 1)
    frac = tpos - k0
    zig = 1 - np.abs(2 * frac - 1)                 # triangle wave per tooth
    jag = knots[k0] * (1 - zig) + (knots[k0] + 0.03) * zig
    keep &= cent[:, 1] < (0.90 + jag)
    faces = faces[keep]

    # drop unreferenced vertices
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces].astype(np.int32)


def scene_06_mask(scale: float = 1.0) -> Scene:
    """Sculpted skin-toned Phong face mask floating on black
    (outputs/o_06_mask.png)."""
    s = Scene()
    s.set_camera(eye=(0.25, 0.35, 4.3), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=42, width=int(500 * scale), height=int(500 * scale))
    # key raised/strengthened by the round-4 cell fit (the golden's
    # highlight pools on the forehead, not the cheek): mean 0.0265 ->
    # 0.0252, max cell 0.215 -> 0.177
    # round-5 cell fit (mean 0.0247 -> 0.0199): blown-out key, side
    # fill dropped, under-fill strengthened, ambient-dominated skin
    s.add_light((4.0, 2.0, 3.8), (1.8, 1.8, 1.8))
    s.add_light((-4, 1, 2), (0.0, 0.0, 0.0))
    s.add_light((0.5, -2.5, 5), (0.606, 0.492, 0.476))   # fill from below
    s.ambience = (0.306, 0.275, 0.266)
    s.background = (0, 0, 0)
    v, f = _face_mask(res=160)
    v = v * np.float32([1.16, 1.05, 1.05])  # the golden's face is broad
    # tilt like the golden: crown leaning to the viewer's right, face
    # turned slightly to its own right (viewer-left)
    cz, szn = np.cos(0.22), np.sin(0.22)
    rot_z = np.float32([[cz, -szn, 0], [szn, cz, 0], [0, 0, 1]])
    v = (v @ rot_z.T).astype(np.float32)
    v = shapes.transformed(v, rotate_y=-0.32, translate=(0.0, -0.15, 0))
    s.add_mesh(TriangleMesh(v, f, material=Material(
        ambient=(0.745, 0.502, 0.413), diffuse=(0.187, 0.111, 0.073),
        specular=(0.55, 0.464, 0.416), shininess=14), draw_mode=PHONG))
    s.max_depth = 1
    return s


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


def scene_07_toon_faces(scale: float = 1.0) -> Scene:
    """Six sculpted toon heads on a green mirror floor under a blue sky
    (outputs/o_07_toon_faces.png)."""
    s = Scene()
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


def scene_08_office(scale: float = 1.0, tess: int = 6, resolution=None) -> Scene:
    """The headline scene: an office room — walls, window wall with frames,
    curved desk, office chairs, cabinet wall — all triangle meshes.

    ``tess`` controls surface tessellation (triangle count) so the same
    scene scales from test-size to the BVH-stressing benchmark.
    ``resolution`` overrides (width, height) — the benchmark renders this
    scene at 1920x1080 (BASELINE.md).
    """
    w, h = resolution if resolution else (int(500 * scale), int(500 * scale))
    s = Scene()
    # camera + wall geometry solved jointly against 28 image anchors
    # measured from the golden PNG (corner/edge lines of the left wall,
    # window bands, cabinet wall, floor lines — round-5 least-squares
    # fit, max residual ~19 px at 500x500; see ROUND5.md)
    s.set_camera(eye=(-1.4463, 1.5923, 5.3346),
                 center=(-0.3003, 1.1542, -0.6405), up=(0, 1, 0),
                 fovy=47.82, width=w, height=h)
    s.add_light((-0.35, 2.45, 2.3), (0.864, 0.895, 0.96))
    # fill light sits near the camera plane so the near cabinet-front
    # faces (+z normals) read lit, as in the golden's bottom-right
    # the palette fit drives the fill light to zero color; its position
    # is kept so the shadow-query workload (the benchmark shape) is
    # unchanged — a zero-color light contributes nothing to the image
    s.add_light((-1.6, 2.4, 4.9), (0.0, 0.0, 0.0))
    s.ambience = (0.573, 0.564, 0.557)
    s.background = (0.0198, 0.0187, 0.0158)

    T = tess

    def add_box(size, center, mat, mode=FLAT, t=1):
        v, f = shapes.box(size, center)
        if t > 1:
            v, f = _tess_box(size, center, t)
        s.add_mesh(TriangleMesh(v, f, material=mat, draw_mode=mode))

    white = Material(ambient=(0.784, 0.786, 0.85), diffuse=(0.369, 0.344, 0.197),
                     shadowable=False)
    # the right wall faces the key lights near-normal; a full 0.55 diffuse
    # would blow it to ~0.8 where the golden reads ~0.55
    right_white = Material(ambient=(0.95, 0.95, 0.95), diffuse=(0.55, 0.55, 0.55),
                           shadowable=False)
    dark_gray = Material(ambient=(0.376, 0.486, 0.464), diffuse=(0.0, 0.0, 0.093),
                         specular=(0.127, 0.055, 0.0))
    maroon = Material(ambient=(0.126, 0.095, 0.007), diffuse=(0.157, 0.054, 0.124),
                      specular=(0.095, 0.047, 0.0))
    yellow = Material(ambient=(0.458, 0.439, 0.256), diffuse=(0.592, 0.595, 0.355),
                      specular=(1.621, 1.639, 1.144), shininess=8)
    # the golden's green band reads pale yellow-green where lit
    green = Material(ambient=(0.0, 0.0, 0.235), diffuse=(0.12, 0.211, 0.291),
                     specular=(0.0, 0.018, 0.116))
    # the golden's chairs read deep navy (near-black in shadow, ~0.4 blue
    # on lit faces)
    blue = Material(ambient=(0.153, 0.155, 0.468), diffuse=(0.153, 0.191, 0.285),
                    specular=(0.0, 0.0, 0.09), shininess=10)
    glass_white = Material(ambient=(0.252, 0.311, 0.214), diffuse=(0.131, 0.111, 0.048),
                           specular=(0.128, 0.109, 0.048), shadowable=False)

    W, H, D2 = 5.5, 2.9, 5.5  # room width / back-room height / near extent
    zw = -2.2                 # window wall plane (front room ends here)
    # wall heights from the round-5 anchor fit: the golden's walls are
    # FINITE with open black above — the left wall's top edge crosses the
    # frame from (0, 8) to (25, 36) px, the right wall tops out at 3.98
    # with a white band above the cabinets in the top-right corner only
    HT = 3.55                 # left wall height
    RT = 3.98                 # right wall height
    for p0, p1, p3, m in [
        ((-W/2, 0, D2), (W/2, 0, D2), (-W/2, 0, zw), maroon),               # floor
        ((-W/2, 0, D2), (-W/2, 0, zw), (-W/2, HT, D2), white),              # left wall
        # right wall wound so the face normal points INTO the room (-x):
        # FLAT diffuse is one-sided, and the golden's right wall reads lit
        ((W/2, 0, zw), (W/2, 0, D2), (W/2, RT, zw), right_white),           # right wall
    ]:
        v, f = _tess_quad(p0, p1, p3, 2 * T, 2 * T)
        s.add_mesh(TriangleMesh(v, f, material=m, draw_mode=FLAT))

    # window wall at z = -2.2, taller than the back room (3.65): sill band
    # 0..0.75 (the golden's green band tops out just below the glass),
    # main glass 0.75..2.85 open to the back room, dark transom bar
    # 2.85..3.05, LIT frosted transom panes 3.05..3.45, dark head band
    # 3.45..3.65, black above (open top).
    WH = 3.65
    # band heights re-inverted from the golden's measured rows under the
    # solved camera: sill 0..0.69, glass 0.69..2.61, wide transom bar
    # 2.61..3.14, frosted transoms 3.14..3.50, head band 3.50..3.65
    add_box((W, 0.69, 0.12), (0, 0.345, zw), dark_gray, t=T // 2 + 1)
    # the upper bands STOP at x=1.95: right of that the golden shows the
    # tall bright back-room wall OVER the window wall (the white band in
    # the top-right corner between the dark corner post and the frame)
    add_box((4.7, 0.53, 0.12), (-0.4, 2.875, zw), dark_gray)
    add_box((4.7, 0.15, 0.12), (-0.4, 3.575, zw), dark_gray)
    # frosted transom panes: dimmer than the back-room envelope; the
    # golden's transom band spans the same breadth as the glass with only
    # a THIN divider over the wide center post (measured runs at y=75)
    trans_white = Material(ambient=(0.465, 0.426, 0.402), diffuse=(0.266, 0.274, 0.237),
                           specular=(0.0, 0.0, 0.055), shadowable=False)
    add_box((1.65, 0.37, 0.10), (-1.575, 3.315, zw), trans_white)
    add_box((2.27, 0.37, 0.10), (0.435, 3.315, zw), trans_white)
    # mullions sit 0.005 proud of the coplanar bands so the overlap
    # doesn't z-fight. Measured from the golden through-glass runs
    # (y=170..230 -> wall-plane x): left post [-2.75, -2.37], left pane
    # [-2.37, -0.72], wide center post [-0.72, -0.13], right pane
    # [-0.13, 1.54], SOLID dark section [1.54, 2.75] (the pane does NOT
    # run to the wall; the golden is dark right of img x=357)
    for x, bw in ((-2.56, 0.38), (-0.425, 0.59)):
        add_box((bw, WH, 0.13), (x, WH / 2, zw), dark_gray)
    # solid corner post of the window wall (the golden's dark gray
    # column at img x 357-400); right of it the wall is OPEN above the
    # cabinets to the bright back room
    add_box((0.41, WH, 0.13), (1.745, WH / 2, zw), dark_gray)
    # --- visible back room behind the glass (the golden shows a lit room
    # with its own cabinets, desk, chair and doors through the window) ---
    zb = zw - 3.4                                  # back room rear wall
    # back room envelope: the golden's back room is brightly lit on its
    # own; the scene lights sit in the front room, so these surfaces are
    # ambient-heavy (self-lit look) instead of adding a third light that
    # would inflate the benchmark's shadow-query cost
    bright = Material(ambient=(1.341, 1.349, 0.912), diffuse=(0.0, 0.0, 0.188),
                      specular=(0.0, 0.0, 0.201), shadowable=False)
    bfloor = Material(ambient=(1.05, 1.05, 1.12), diffuse=(0.1, 0.1, 0.12),
                      shadowable=False)
    v, f = _tess_quad((-W/2, 0, zw), (-W/2, 0, zb), (-W/2, H, zw), T, T)
    s.add_mesh(TriangleMesh(v, f, material=bright, draw_mode=FLAT))
    v, f = _tess_quad((W/2, 0, zw), (W/2, 0, zb), (W/2, H, zw), T, T)
    s.add_mesh(TriangleMesh(v, f, material=bright, draw_mode=FLAT))
    # TALL bright return panel just behind the window-wall corner: the
    # white band the golden shows OVER the window wall in the top-right
    # (vertical left boundary at img x~400 -> panel depth ~0.7); beyond
    # it the back room tops out at H and the frame stays black
    vbright = Material(ambient=(1.8, 1.8, 1.8), diffuse=(0.3, 0.3, 0.32),
                       shadowable=False)
    v, f = _tess_quad((W/2, 0, zw), (W/2, 0, -2.9), (W/2, 4.2, zw), T, T)
    s.add_mesh(TriangleMesh(v, f, material=vbright, draw_mode=FLAT))
    v, f = _tess_quad((-W/2, 0.0, zb), (W/2, 0.0, zb), (-W/2, H, zb), T, T)
    s.add_mesh(TriangleMesh(v, f, material=bright, draw_mode=FLAT))
    v, f = _tess_quad((-W/2, 0, zw), (W/2, 0, zw), (-W/2, 0, zb), T, T)
    s.add_mesh(TriangleMesh(v, f, material=bfloor, draw_mode=FLAT))
    v, f = _tess_quad((-W/2, H, zw), (W/2, H, zw), (-W/2, H, zb), T, T)
    s.add_mesh(TriangleMesh(v, f, material=bright, draw_mode=FLAT))
    # wainscot: the golden's back room reads mid-gray below desk height
    # (furniture clutter / shadow), bright only in its upper half
    mid_gray = Material(ambient=(0.321, 0.249, 0.0), diffuse=(0.14, 0.212, 0.0),
                        specular=(0.071, 0.165, 0.0), shadowable=False)
    add_box((0.06, 1.2, zw - zb), (-W/2 + 0.03, 0.6, (zw + zb) / 2), mid_gray)
    add_box((W, 1.2, 0.06), (0, 0.6, zb + 0.03), mid_gray)
    # back-room furniture: cabinet row with seams, a desk, a blue chair,
    # and two door frames on the rear wall
    # the golden's back-room cabinets read pale tan, washed out by the
    # back room's own light
    pale_tan = Material(ambient=(0.0, 0.0, 0.0), diffuse=(0.0, 0.0, 0.0),
                        specular=(0.751, 0.696, 0.726), shininess=0.0,
                        shadowable=False)
    for ix in range(3):
        add_box((0.55, 2.25, 0.35), (1.43 + ix * 0.57, 1.125, zb + 0.25),
                pale_tan, t=T // 2 + 1)
        add_box((0.015, 2.25, 0.37), (1.43 + ix * 0.57 - 0.285, 1.125,
                                      zb + 0.25), dark_gray)
    add_box((1.5, 0.12, 0.7), (-1.3, 0.85, zb + 0.85), glass_white)
    add_box((0.1, 0.78, 0.1), (-1.3, 0.4, zb + 0.85), dark_gray)
    _chair(s, (-1.75, 0, zb + 1.5), 0.9,
           Material(ambient=(0.0, 0.0, 0.0), diffuse=(0.0, 0.0, 0.136)),
           dark_gray, T)
    # dark door on the rear wall (the golden's left pane shows a gray
    # door rectangle on the bright back wall, img x 150-225)
    door_gray = Material(ambient=(0.667, 0.64, 0.867), diffuse=(0.037, 0.036, 0.009),
                         shadowable=False)
    add_box((1.44, 2.25, 0.06), (-0.55, 1.125, zb + 0.04), door_gray)

    # cabinet wall on the right: doors with visible seams + dark handles.
    # Round-5 anchor fit: the cabinet FRONT plane sits at x = 0.97 (the
    # golden's vertical yellow edge at img x=377), the doors run from the
    # floor to 2.40 in two equal rows, and the wall fills the frame's
    # right edge down to the near corner
    CABX, CABT = 0.97, 2.40
    for iy in range(2):
        for ix in range(5):
            cz = 0.35 + ix * 1.12
            cy, ch = (0.60, 1.20) if iy == 0 else (1.80, 1.20)
            add_box((W/2 - CABX, ch, 1.05), ((W/2 + CABX) / 2, cy, cz),
                    yellow, t=T // 2 + 1)
            # horizontal seam at the row's bottom edge + full-height
            # vertical seam showing through the inter-door gaps
            add_box((0.6, 0.02, 1.07), (CABX + 0.45, cy - ch / 2, cz),
                    dark_gray)
            add_box((0.6, ch, 0.02), (CABX + 0.45, cy, cz - 0.53),
                    dark_gray)
            # handle knobs proud of the door face
            v, f = shapes.uv_sphere(0.035, 6, 8,
                                    center=(CABX - 0.03, cy - ch / 2 + 0.64,
                                            cz - 0.40))
            s.add_mesh(TriangleMesh(v, f, material=dark_gray, draw_mode=PHONG))

    # green sideboard under the window, topping out at the sill; it ends
    # at the cabinet front plane (the golden's green band stops at the
    # cabinet junction, img x~360); its right section reads dark
    add_box((CABX + 2.72, 0.72, 0.6), ((CABX - 2.72) / 2, 0.36, zw + 0.45),
            green, t=T // 2 + 1)
    dark_green = Material(ambient=(0.0, 0.0, 0.0), diffuse=(0.0, 0.0, 0.0),
                          specular=(0.0, 0.0, 0.543))
    add_box((1.0, 0.73, 0.62), (0.45, 0.36, zw + 0.45), dark_green)

    # long tapered desk along the left side of the room (round-5 fit of
    # the golden's yellow region inverted to the y=0.72 plane: left edge
    # ~straight at x=-1.52, right edge widening from -0.66 at the window
    # end to +0.04 near the camera, rounded ends)
    desk_yellow = Material(ambient=(0.698, 0.676, 0.254), diffuse=(0.758, 0.755, 0.52),
                           specular=(1.131, 1.13, 0.0), shininess=8)
    desk_top, desk_skirt = _desk(tess=max(24, 8 * T))
    s.add_mesh(TriangleMesh(desk_top[0], desk_top[1], material=desk_yellow, draw_mode=FLAT))
    s.add_mesh(TriangleMesh(desk_skirt[0], desk_skirt[1], material=dark_gray, draw_mode=FLAT))
    # desk legs
    for lx, lz in [(-1.1, -0.9), (-0.95, 0.9), (-0.72, 1.95)]:
        v, f = shapes.cylinder(0.06, 0.72, 10, center=(lx, 0.36, lz))
        s.add_mesh(TriangleMesh(v, f, material=dark_gray, draw_mode=PHONG))

    # office chairs (blue seats/backs on dark posts), placed by
    # inverting the golden's blue regions under the solved camera
    for cx, cz, rot, csc in [
            (-2.0, 0.6, 1.1, np.float32([0.95, 0.9, 0.95])),
            (0.02, 0.1, -0.5, 1.0),
            (-1.3, 3.3, 0.3, np.float32([0.8, 0.7, 0.8]))]:
        _chair(s, (cx, 0, cz), rot, blue, dark_gray, T, scale=csc)

    s.max_depth = 2
    return s


def _tess_box(size, center, t):
    """Box with each face grid-tessellated t x t."""
    sx, sy, sz = (v / 2 for v in size)
    cx, cy, cz = center
    patches = []
    c = np.float32([cx, cy, cz])
    # (origin, u-edge, v-edge) per face, outward CCW
    for p0, p1, p3 in [
        ((-sx, -sy, sz), (sx, -sy, sz), (-sx, sy, sz)),       # +z
        ((sx, -sy, -sz), (-sx, -sy, -sz), (sx, sy, -sz)),     # -z
        ((sx, -sy, sz), (sx, -sy, -sz), (sx, sy, sz)),        # +x
        ((-sx, -sy, -sz), (-sx, -sy, sz), (-sx, sy, -sz)),    # -x
        ((-sx, sy, sz), (sx, sy, sz), (-sx, sy, -sz)),        # +y
        ((-sx, -sy, -sz), (sx, -sy, -sz), (-sx, -sy, sz)),    # -y
    ]:
        v, f = _tess_quad(np.float32(p0) + c, np.float32(p1) + c, np.float32(p3) + c, t, t)
        patches.append((v, f))
    return shapes.merge(*patches)


def _desk(tess=48):
    """Long desk top + vertical skirt, y = 0.72..0.78.

    Footprint traced from the golden: the bright desk region's left and
    right boundaries inverted onto the y=0.75 plane under the solved
    round-5 camera (a long slab running along the room from the window
    to z~2.7, right edge widening to -0.08 at z~1.9, rounded near cap).
    Control polygon resampled to ``tess`` boundary points.
    """
    ctrl = np.asarray([
        (-1.52, -1.90), (-1.40, 0.10), (-1.28, 1.20), (-1.33, 2.05),
        (-1.10, 2.55), (-0.75, 2.72), (-0.40, 2.60), (-0.12, 2.25),
        (-0.08, 1.90), (-0.14, 1.45), (-0.22, 0.90), (-0.31, 0.30),
        (-0.45, -0.60), (-0.55, -1.40), (-0.80, -1.85), (-1.20, -1.95),
    ], np.float32)
    # periodic arc-length resample to tess points
    closed = np.concatenate([ctrl, ctrl[:1]])
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    tt = np.linspace(0, cum[-1], tess, endpoint=False)
    px = np.interp(tt, cum, closed[:, 0])
    pz = np.interp(tt, cum, closed[:, 1])
    # light smoothing so the resampled polygon reads curved, not faceted
    for _ in range(2):
        px = 0.5 * px + 0.25 * (np.roll(px, 1) + np.roll(px, -1))
        pz = 0.5 * pz + 0.25 * (np.roll(pz, 1) + np.roll(pz, -1))
    # control points trace the outline clockwise in plan view; the top
    # fan expects counterclockwise (+y normal), so reverse
    prof = np.stack([px, pz], 1).astype(np.float32)[::-1]
    y0, y1 = 0.72, 0.78
    n = tess
    top = np.concatenate([
        np.stack([prof[:, 0], np.full(n, y1), prof[:, 1]], 1),
        [[-0.80, y1, 0.40]],
    ]).astype(np.float32)
    top_faces = np.asarray([[n, (i + 1) % n, i] for i in range(n)], np.int32)
    skirt_v = np.concatenate([
        np.stack([prof[:, 0], np.full(n, y0), prof[:, 1]], 1),
        np.stack([prof[:, 0], np.full(n, y1), prof[:, 1]], 1),
    ]).astype(np.float32)
    skirt_f = []
    for i in range(n):
        j = (i + 1) % n
        skirt_f += [[i, n + i, j], [j, n + i, n + j]]
    return (top, top_faces), (skirt_v, np.asarray(skirt_f, np.int32))


def _chair(s: Scene, pos, rot, seat_mat, post_mat, t, scale=1.0):
    """Office swivel chair: cushioned seat, tilted backrest with lumbar
    curve, armrests, gas-lift column, 5-spoke star base with casters."""
    px, py, pz = pos

    def put(v, f, m, mode=FLAT):
        v = shapes.transformed(v * np.float32(scale), rotate_y=rot,
                               translate=(px, py, pz))
        s.add_mesh(TriangleMesh(v, f, material=m, draw_mode=mode))

    tt = max(2, t // 2)
    # seat cushion (slightly domed top via two stacked boxes)
    v, f = _tess_box((0.52, 0.07, 0.5), (0, 0.50, 0), tt)
    put(v, f, seat_mat)
    v, f = _tess_box((0.46, 0.04, 0.44), (0, 0.555, 0.01), tt)
    put(v, f, seat_mat)
    # backrest: tilted back ~10 deg, with a lumbar pad proud of it
    v, f = _tess_box((0.48, 0.66, 0.07), (0, 0.92, -0.28), tt)
    v = _rot_xyz(v - np.float32([0, 0.60, -0.28]), rx=-0.18) + np.float32(
        [0, 0.60, -0.28])
    put(v, f, seat_mat)
    v, f = _tess_box((0.40, 0.22, 0.05), (0, 0.78, -0.23), tt)
    put(v, f, seat_mat)
    # armrests: vertical supports + horizontal pads
    for sx in (-1, 1):
        v, f = shapes.box((0.05, 0.26, 0.05), (sx * 0.29, 0.60, 0.05))
        put(v, f, post_mat)
        v, f = shapes.box((0.07, 0.04, 0.34), (sx * 0.29, 0.74, 0.0))
        put(v, f, post_mat)
    # gas-lift column
    v, f = shapes.cylinder(0.035, 0.42, 10, center=(0, 0.28, 0))
    put(v, f, post_mat, PHONG)
    # 5-spoke star base with caster knobs
    for k in range(5):
        a = 2 * np.pi * k / 5 + 0.3
        v, f = shapes.box((0.30, 0.035, 0.055), (0.17, 0.045, 0))
        v = shapes.transformed(v, rotate_y=a)
        put(v, f, post_mat)
        cx, cz = 0.30 * np.cos(-a), 0.30 * np.sin(-a)
        v, f = shapes.uv_sphere(0.035, 6, 8, center=(cx, 0.035, cz))
        put(v, f, post_mat, PHONG)


def scene_09_rings(scale: float = 1.0, seg: int = 64) -> Scene:
    """Two interlocked Phong tori (olive + copper) with mirror highlights."""
    s = Scene()
    s.set_camera(eye=(0.2, 1.6, 6.0), center=(0, -0.2, 0), up=(0, 1, 0),
                 fovy=43, width=int(700 * scale), height=int(500 * scale))
    # round-5 cell fit, adopted in full: the golden's tori carry STRONG
    # mirror inter-reflections (copper glints on the olive ring), which
    # the fit recovers with high mirror x high ambient (effective
    # ambient = (1-m)*a); mean cell delta 0.0281 -> 0.0155
    s.add_light((-3, 6, 5), (0.894, 0.843, 0.789))
    s.add_light((4, 2, 4), (0.0, 0.0, 0.0))
    s.ambience = (0.655, 0.68, 0.536)
    s.background = (0, 0, 0)

    # pose/size/brightness fit against the reference PNG's 8x8 cell means
    # (round-4 sweep, mean cell delta 0.0653 -> 0.0278, max 0.229 ->
    # 0.166): the golden's rings are compact and centered — small major
    # radius, fat tube, strong tilt, interlock pulled toward the middle
    v1, f1 = shapes.torus(1.06, 0.45, seg, seg // 2)
    # both rings tilt toward the viewer so their holes read like the
    # golden's chain-link composition
    v1 = _rot_xyz(v1, rx=1.1, ry=0.2) + np.float32((-0.6, -0.32, 0.3))
    s.add_mesh(TriangleMesh(v1, f1, material=Material(
        ambient=(1.454, 1.152, 0.631), diffuse=(0.554, 0.612, 0.215),
        specular=(0.5, 0.5, 0.4), shininess=45, mirror=0.768), draw_mode=PHONG))

    v2, f2 = shapes.torus(1.06, 0.45, seg, seg // 2)
    # stand the second torus up-tilted and interlock
    v2 = _rot_xyz(v2, rx=1.2, ry=-0.55) + np.float32((0.55, -0.72, 0.2))
    s.add_mesh(TriangleMesh(v2, f2, material=Material(
        ambient=(0.229, 0.208, 0.14), diffuse=(0.922, 0.488, 0.326),
        specular=(0.5, 0.4, 0.3), shininess=45, mirror=0.639), draw_mode=PHONG))
    s.max_depth = 3
    return s


def scene_10_pokemon(scale: float = 1.0) -> Scene:
    """Three creature blobs on a sandy textured ground under a starfield
    sky — the textured-mesh scene (nearest-neighbor UV lookup), 4spp AA."""
    s = Scene()
    # camera pulled in to the golden's framing (creatures fill rows 2-6
    # and the sand texels read coarse; round-4 fit 0.064 -> 0.049 with
    # the sky-band/sand/white-tone changes below)
    s.set_camera(eye=(0, 0.9, 4.4), center=(0, 0.75, 0), up=(0, 1, 0),
                 fovy=44, width=int(600 * scale), height=int(300 * scale))
    s.add_light((3, 7, 7), (0.75, 0.73, 0.68))
    s.ambience = (0.3, 0.3, 0.33)
    s.background = (0.01, 0.02, 0.06)

    # sandy ground: big textured quad
    g, gf, guvi, gu, gv = shapes.plane_uv_quad(
        (-14, 0, 10), (14, 0, 10), (14, 0, -6), (-14, 0, -6))
    s.add_mesh(TriangleMesh(g, gf, uv_indices=guvi, u_coords=np.tile(gu, 1),
                            v_coords=gv, texture=_sand_texture(),
                            material=Material(ambient=(0.28, 0.24, 0.19),
                                              diffuse=(0.6, 0.52, 0.4)),
                            draw_mode=FLAT))
    # starfield backdrop quad: near-zero flat ambient so the texel (which
    # overrides diffuse) carries the whole sky through the light term
    b, bf, buvi, bu, bv = shapes.plane_uv_quad(
        (-16, 0, -6), (16, 0, -6), (16, 12, -6), (-16, 12, -6))
    s.add_mesh(TriangleMesh(b, bf, uv_indices=buvi, u_coords=bu, v_coords=bv,
                            texture=np.clip(_starfield_texture() * 1.7, 0, 1),
                            material=Material(ambient=(0.02, 0.03, 0.08),
                                              diffuse=(1.0, 1.0, 1.0),
                                              shadowable=False),
                            draw_mode=FLAT))

    # three articulated creatures (bodies, heads, ears, legs, tails — the
    # golden shows creatures, not blobs) + a small dark floater in the sky
    parts = _Parts(s)
    white = _creature_mat((0.585, 0.585, 0.615), spec=0.3)
    dkgray = _creature_mat((0.28, 0.28, 0.34), spec=0.35)
    yellow = _creature_mat((0.92, 0.84, 0.18), spec=0.2)
    black = _creature_mat((0.12, 0.12, 0.14), spec=0.45, shin=60)
    ring_y = _creature_mat((0.95, 0.82, 0.1), spec=0.3)

    # -- left: white quadruped with a curved head blade and bushy tail --
    parts.add("w", white, _ell((0, 0.95, 0), (0.62, 0.40, 0.32), n=20))
    parts.add("w", white, _ell((0.55, 1.2, 0), (0.3, 0.32, 0.24),
                               rz=-0.5))                       # chest/neck
    parts.add("w", white, _ell((0.82, 1.52, 0), (0.26, 0.21, 0.19)))  # head
    parts.add("g", dkgray, _ell((0.95, 1.47, 0), (0.16, 0.12, 0.14)))  # face
    # curved horn: a crescent blade sweeping back from the side of the head
    for k in range(6):
        t = k / 5.0
        th = 1.25 - 1.5 * t                     # sweep front-top -> back
        px = 0.82 + 0.38 * np.cos(th) - 0.25
        py = 1.58 + 0.34 * np.sin(th)
        parts.add("g", dkgray, _ell(
            (px, py, 0.14), (0.14 - 0.012 * k, 0.05 - 0.005 * k, 0.02),
            rz=th - 1.3, n=10))
    # legs (slightly splayed) + gray claws
    for lx, lz in [(0.42, 0.17), (0.42, -0.17), (-0.42, 0.17), (-0.42, -0.17)]:
        parts.add("w", white, _ell((lx, 0.42, lz), (0.1, 0.45, 0.1), n=12))
        parts.add("g", dkgray, _ell((lx, 0.08, lz), (0.12, 0.09, 0.14), n=10))
    # bushy tail: tapered crescent up-back
    parts.add("g", dkgray, _ell((-0.72, 1.35, 0), (0.12, 0.42, 0.07),
                                rz=0.55, taper=0.6, n=12))
    # shaggy chest fur hint
    parts.add("w", white, _ell((0.35, 0.72, 0), (0.3, 0.24, 0.26), n=12))
    # shifted right in round 5: the golden's left creature is centered
    # nearer the frame third (cells (3,1)/(3,2) carried a +0.12/-0.12
    # adjacent pair = body one cell left of the golden's)
    parts.emit(translate=(-1.88, 0.0, 0.25), ry=0.35)

    # -- middle: small yellow biped with huge ears, facing the camera --
    parts.add("y", yellow, _ell((0, 0.30, 0), (0.24, 0.27, 0.21), n=16))
    parts.add("y", yellow, _ell((0, 0.66, 0), (0.235, 0.215, 0.20), n=16))
    for sx in (-1, 1):
        # big triangular ears, black tips
        parts.add("y", yellow, _ell((sx * 0.17, 0.95, 0), (0.10, 0.24, 0.05),
                                    rz=-sx * 0.45, taper=0.55, n=12))
        parts.add("k", black, _ell((sx * 0.275, 1.12, 0), (0.075, 0.115, 0.04),
                                   rz=-sx * 0.45, taper=0.5, n=10))
        # stub arms + feet
        parts.add("y", yellow, _ell((sx * 0.2, 0.32, 0.1), (0.06, 0.12, 0.06),
                                    rz=-sx * 0.5, n=8))
        parts.add("y", yellow, _ell((sx * 0.11, 0.045, 0.1),
                                    (0.08, 0.05, 0.13), n=8))
    # cheeks (darker patches) + tiny black eyes, proud of the head surface
    for sx in (-1, 1):
        parts.add("p", _creature_mat((0.75, 0.45, 0.5)), _ell(
            (sx * 0.16, 0.60, 0.16), (0.055, 0.045, 0.03), n=8))
        parts.add("k", black, _ell((sx * 0.09, 0.71, 0.185),
                                   (0.026, 0.038, 0.02), n=8))
    parts.emit(translate=(0.1, 0.0, 0.55), ry=0.0)

    # -- right: black quadruped with ringed ears and tail, facing left --
    parts.add("k", black, _ell((0, 0.92, 0), (0.5, 0.34, 0.26), n=20))
    parts.add("k", black, _ell((-0.45, 1.18, 0.05), (0.22, 0.3, 0.2),
                               rz=0.4))                          # neck
    parts.add("k", black, _ell((-0.62, 1.45, 0.08), (0.19, 0.17, 0.16)))  # head
    for sx in (-1, 1):
        parts.add("k", black, _ell((-0.62 + sx * 0.1, 1.72, 0.08),
                                   (0.07, 0.2, 0.045), rz=-sx * 0.35,
                                   taper=0.5, n=10))             # ears
        parts.add("r", ring_y, _ell((-0.62 + sx * 0.085, 1.62, 0.08),
                                    (0.075, 0.045, 0.05), rz=-sx * 0.35,
                                    n=8))                        # ear rings
    parts.add("r", ring_y, _ell((-0.78, 1.47, 0.09), (0.035, 0.045, 0.03),
                                n=8))                            # forehead ring
    for lx, lz in [(-0.32, 0.14), (-0.32, -0.14), (0.34, 0.14), (0.34, -0.14)]:
        parts.add("k", black, _ell((lx, 0.42, lz), (0.085, 0.44, 0.085), n=12))
        parts.add("r", ring_y, _ell((lx, 0.62, lz), (0.095, 0.05, 0.095),
                                    n=8))                        # leg rings
    parts.add("k", black, _ell((0.62, 1.25, 0), (0.09, 0.3, 0.06),
                               rz=-0.5, taper=0.5, n=10))        # tail
    parts.add("r", ring_y, _ell((0.55, 1.12, 0), (0.1, 0.05, 0.07),
                                rz=-0.5, n=8))                   # tail ring
    # shifted right in round 5 (blob centroid 23px left of the golden's)
    parts.emit(translate=(2.7, 0.0, 0.0), ry=-0.15)

    # -- floating dark critter in the sky (top-center of the golden) --
    parts.add("k", black, _ell((0, 0, 0), (0.17, 0.14, 0.12), n=12))
    for a in (-1.9, -1.1, -0.5, 0.5, 1.1, 1.9):
        parts.add("k", black, _ell(
            (0.2 * np.sin(a), 0.1 * np.cos(a) - 0.08, 0),
            (0.035, 0.12, 0.025), rz=-a, n=6))
    parts.add("w2", white, _ell((0, 0.02, 0.1), (0.05, 0.04, 0.03), n=6))
    parts.emit(translate=(0.15, 3.1, -1.2))

    s.max_depth = 2
    return s


#: registry: name -> (builder, adaptive-AA compaction budget as a fraction
#: of the image). The reference supersamples EVERY pixel whose
#: 4-neighborhood deviation exceeds 0.02 (mytracer_gpu.cu:195-221); our
#: static-shape pass covers the top-K by deviation, so K must be >= the
#: above-threshold count for exact-rule parity. Budgets are per scene,
#: sized from measured above-threshold fractions with margin
#: (tests/test_aa_budget.py asserts coverage at the golden resolutions).
#: (builder, AA compaction budget). Budgets are pinned at the MEASURED
#: above-threshold fraction at reference resolution x ~1.3 margin
#: (re-measured 2026-08-20 on the round-3 scenes; tests/test_aa_budget.py
#: enforces coverage of the exact reference rule). The round-2 blanket
#: 0.10-0.15 budgets over-provisioned the AA pass 2-10x.
GOLDEN_SCENES = {
    "o_01_spheres": (scene_01_spheres, 0.014),   # measured 0.0119 (round-5 geom+refit)
    "o_02_shadow": (scene_02_shadow, 0.012),     # measured 0.0098 (round-5 fit)
    "o_03_mirror": (scene_03_mirror, 0.004),     # measured 0.0029 (round-5 fit)
    "o_04_molecule": (scene_04_molecule, 0.038), # measured 0.0324 (round-5 seed 42)
    "o_05_cube": (scene_05_cube, 0.012),         # measured 0.0089
    "o_06_mask": (scene_06_mask, 0.021),         # measured 0.0181 (round-5 fit)
    "o_07_toon_faces": (scene_07_toon_faces, 0.061),  # measured 0.0523 (round-5)
    "o_08_office": (scene_08_office, 0.081),     # measured 0.0700 (round-5 rebuild)
    "o_09_rings": (scene_09_rings, 0.045),       # measured 0.0389 (round-5 fit)
    "o_10_pokemon": (scene_10_pokemon, 0.077),   # measured 0.0670 (round-5)
}


def main(argv=None):
    import argparse
    import os
    import time

    ap = argparse.ArgumentParser(description="Render the 10 golden scenes")
    # no default: outputs/ holds the reference's committed renders
    ap.add_argument("--out", required=True,
                    help="directory for the PNGs (required)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--scene", default=None, help="render only this scene")
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the default is the GPU)")
    args = ap.parse_args(argv)

    from myraytracer_tpu_torch.ops.render import render, render_aa
    from myraytracer_tpu_torch.utils.image import write_png

    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.out, exist_ok=True)
    for name, (builder, aa_budget) in GOLDEN_SCENES.items():
        if args.scene and args.scene not in name:
            continue
        t0 = time.time()
        sc = builder(scale=args.scale)
        data = sc.build(device=device)
        t1 = time.time()
        if args.no_aa or not aa_budget:
            img = render(data, sc.camera)
        else:
            img = render_aa(data, sc.camera, budget_frac=aa_budget)
        img = img.cpu().numpy()
        t2 = time.time()
        path = os.path.join(args.out, f"{name}.png")
        write_png(path, img)
        print(f"{name}: {data.n_tris} tris, {data.n_spheres} spheres | "
              f"build {t1-t0:.2f}s render {t2-t1:.2f}s on {device} "
              f"-> {path}", flush=True)


if __name__ == "__main__":
    main()
