"""The office (golden o_08): a frozen copy of the port's scene builder.

``scene_08_office`` and its helpers are copied from the port's
``scenes/golden.py``; they author through :class:`common.Builder`
instead of the port's ``Scene``, and nothing else changed. The room,
its window wall, desk, chairs and cabinet wall are triangle meshes;
``tess`` sets the tessellation and ``resolution`` the image size.
:func:`generate` returns the scene as plain arrays (common.py).
"""

from __future__ import annotations

import numpy as np

from rtbench.scenes import shapes
from rtbench.scenes.common import FLAT, PHONG, Builder, Material


def generate(tess: int, width: int, height: int) -> dict:
    """The office at ``tess``, rendered at ``width`` x ``height``."""
    return scene_08_office(tess=tess, resolution=(width, height)).arrays()


def scene_08_office(scale: float = 1.0, tess: int = 6, resolution=None) -> Scene:
    """The headline scene: an office room — walls, window wall with frames,
    curved desk, office chairs, cabinet wall — all triangle meshes.

    ``tess`` controls surface tessellation (triangle count) so the same
    scene scales from test-size to the BVH-stressing benchmark.
    ``resolution`` overrides (width, height) — the benchmark renders this
    scene at 1920x1080 (BASELINE.md).
    """
    w, h = resolution if resolution else (int(500 * scale), int(500 * scale))
    s = Builder()
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
        s.add_mesh(v, f, mat, mode)

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
        s.add_mesh(v, f, m, FLAT)

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
    s.add_mesh(v, f, bright, FLAT)
    v, f = _tess_quad((W/2, 0, zw), (W/2, 0, zb), (W/2, H, zw), T, T)
    s.add_mesh(v, f, bright, FLAT)
    # TALL bright return panel just behind the window-wall corner: the
    # white band the golden shows OVER the window wall in the top-right
    # (vertical left boundary at img x~400 -> panel depth ~0.7); beyond
    # it the back room tops out at H and the frame stays black
    vbright = Material(ambient=(1.8, 1.8, 1.8), diffuse=(0.3, 0.3, 0.32),
                       shadowable=False)
    v, f = _tess_quad((W/2, 0, zw), (W/2, 0, -2.9), (W/2, 4.2, zw), T, T)
    s.add_mesh(v, f, vbright, FLAT)
    v, f = _tess_quad((-W/2, 0.0, zb), (W/2, 0.0, zb), (-W/2, H, zb), T, T)
    s.add_mesh(v, f, bright, FLAT)
    v, f = _tess_quad((-W/2, 0, zw), (W/2, 0, zw), (-W/2, 0, zb), T, T)
    s.add_mesh(v, f, bfloor, FLAT)
    v, f = _tess_quad((-W/2, H, zw), (W/2, H, zw), (-W/2, H, zb), T, T)
    s.add_mesh(v, f, bright, FLAT)
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
            s.add_mesh(v, f, dark_gray, PHONG)

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
    s.add_mesh(desk_top[0], desk_top[1], desk_yellow, FLAT)
    s.add_mesh(desk_skirt[0], desk_skirt[1], dark_gray, FLAT)
    # desk legs
    for lx, lz in [(-1.1, -0.9), (-0.95, 0.9), (-0.72, 1.95)]:
        v, f = shapes.cylinder(0.06, 0.72, 10, center=(lx, 0.36, lz))
        s.add_mesh(v, f, dark_gray, PHONG)

    # office chairs (blue seats/backs on dark posts), placed by
    # inverting the golden's blue regions under the solved camera
    for cx, cz, rot, csc in [
            (-2.0, 0.6, 1.1, np.float32([0.95, 0.9, 0.95])),
            (0.02, 0.1, -0.5, 1.0),
            (-1.3, 3.3, 0.3, np.float32([0.8, 0.7, 0.8]))]:
        _chair(s, (cx, 0, cz), rot, blue, dark_gray, T, scale=csc)

    s.max_depth = 2
    return s


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


def _chair(s: Builder, pos, rot, seat_mat, post_mat, t, scale=1.0):
    """Office swivel chair: cushioned seat, tilted backrest with lumbar
    curve, armrests, gas-lift column, 5-spoke star base with casters."""
    px, py, pz = pos

    def put(v, f, m, mode=FLAT):
        v = shapes.transformed(v * np.float32(scale), rotate_y=rot,
                               translate=(px, py, pz))
        s.add_mesh(v, f, m, mode)

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
