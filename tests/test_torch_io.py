"""The port's mesh files (OBJ, OFF) and scene files vs the reference.

tests/test_io.py's cases on the port, plus parity: each reader gives the
reference's arrays on the same file, and ``examples/demo.sce`` (a sphere,
a cylinder, the OFF mesh ``blob.off`` beside it and a mirror floor),
read and built by the port on the CPU, packs to the reference's build
field by field, bit for bit (the reference's NumPy BVH builder,
MRT_NO_NATIVE=1, which the port carries).
"""

import textwrap

import numpy as np
import pytest
import torch

from myraytracer_tpu.models import objio as robjio
from myraytracer_tpu.models import sceneio as rsceneio

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, PHONG, TriangleMesh
from myraytracer_tpu_torch.models.objio import (read_mesh, read_obj, read_off,
                                                write_obj)
from myraytracer_tpu_torch.models.scene import (ARRAY_FIELDS, STATIC_FIELDS,
                                                Scene)
from myraytracer_tpu_torch.models.sceneio import (SceneParseError, read_scene,
                                                  write_scene)
from myraytracer_tpu_torch.scenes.shapes import uv_sphere
from myraytracer_tpu_torch.utils.image import write_png

from test_torch_scene import REPO

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

OBJ_SIMPLE = """\
# a quad with uvs
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
mtllib ignored.mtl
usemtl ignored
f 1/1 2/2 3/3 4/4
"""

OFF_TETRA = """\
OFF
4 4 0
0 0 0
1 0 0
0 1 0
0 0 1
3 0 2 1
3 0 1 3
3 0 3 2
3 1 2 3
"""

#: name -> (file name, text, (vertices, triangles) it reads to)
MESH_FILES = {
    "quad_fan": ("quad.obj", OBJ_SIMPLE, (4, 2)),
    "negative_indices": ("neg.obj", "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n",
                         (3, 1)),
    "slash_forms": ("forms.obj",
                    "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n",
                    (3, 1)),
    "off_tetra": ("t.off", OFF_TETRA, (4, 4)),
}


@pytest.mark.parametrize("name", sorted(MESH_FILES))
def test_mesh_file_matches_reference(name, tmp_path):
    fn, text, (nv, nt) = MESH_FILES[name]
    p = tmp_path / fn
    p.write_text(text)
    m = read_mesh(str(p))
    want = robjio.read_mesh(str(p))
    assert (m.n_vertices, m.n_triangles) == (nv, nt)
    for f in ("vertices", "triangles", "uv_indices", "u_coords", "v_coords",
              "vertex_normals", "face_normals"):
        a, b = getattr(m, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert m.draw_mode == want.draw_mode == PHONG


def test_quad_fan_triangulated(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(OBJ_SIMPLE)
    m = read_obj(str(p))
    assert m.triangles.tolist() == [[0, 1, 2], [0, 2, 3]]
    assert m.uv_indices.shape == (2, 3)
    np.testing.assert_allclose(m.u_coords, [0, 1, 1, 0])


def test_negative_indices(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    assert read_obj(str(p)).triangles.tolist() == [[0, 1, 2]]


@pytest.mark.parametrize("uvs", [False, True])
def test_obj_round_trip(uvs, tmp_path):
    v, f = uv_sphere(1.0, 4, 6)
    kw = {}
    if uvs:
        kw = dict(uv_indices=f, u_coords=np.linspace(0, 1, len(v)),
                  v_coords=np.linspace(1, 0, len(v)))
    mesh = TriangleMesh(v, f, **kw)
    p = tmp_path / "s.obj"
    write_obj(str(p), mesh)
    back = read_obj(str(p))
    assert back.n_vertices == mesh.n_vertices
    np.testing.assert_array_equal(back.triangles, mesh.triangles)
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-5)
    if uvs:
        np.testing.assert_array_equal(back.uv_indices, mesh.uv_indices)
        np.testing.assert_allclose(back.u_coords, mesh.u_coords, atol=1e-6)
    else:
        assert back.uv_indices is None


def test_off_tetra(tmp_path):
    p = tmp_path / "t.off"
    p.write_text(OFF_TETRA)
    m = read_off(str(p), draw_mode=FLAT)
    assert m.n_vertices == 4 and m.n_triangles == 4 and m.draw_mode == FLAT
    p.write_text("OFX\n1 0 0\n0 0 0\n")
    with pytest.raises(ValueError, match="not an OFF file"):
        read_off(str(p))


def test_full_grammar(tmp_path):
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                      "vt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    write_png(str(tmp_path / "tex.png"), np.full((2, 2, 3), 0.5, np.float32))
    sce = tmp_path / "scene.sce"
    sce.write_text(textwrap.dedent("""\
        # test scene
        camera 0 1 5  0 0 0  0 1 0  45 64 48
        light 2 4 4  0.8 0.8 0.8
        light -2 4 4  0.2 0.2 0.2
        background 0 0 0.05
        ambience 0.2 0.2 0.2
        depth 3
        sphere 0 0 0 1  0.2 0 0  0.7 0 0  0.5 0.5 0.5  30 0.3
        plane 0 -1 0  0 1 0  0.1 0.1 0.1  0.5 0.5 0.5  0 0 0  5 0 0
        cylinder 1 0 0  0 1 0  0.2 1  0.1 0.1 0.1  0.3 0.3 0.3  0 0 0  5 0 1
        mesh tri.obj FLAT tex.png
    """))
    s = read_scene(str(sce))
    assert (s.camera.width, s.camera.height) == (64, 48)
    assert len(s.lights) == 2 and s.max_depth == 3
    assert s.background == (0.0, 0.0, 0.05)
    assert len(s._spheres) == 1 and len(s._planes) == 1
    assert len(s._cylinders) == 1
    assert len(s.meshes) == 1 and s.meshes[0].draw_mode == FLAT
    assert s.meshes[0].has_texture
    np.testing.assert_array_equal(s.meshes[0].texture,
                                  np.full((2, 2, 3), 128 / 255, np.float32))
    _, r, m = s._spheres[0]
    assert r == 1.0 and m.mirror == 0.3 and m.shininess == 30
    assert s._planes[0][2].shadowable is False      # trailing 0 flag
    assert s._cylinders[0][4].shadowable is True    # trailing 1 flag
    data = s.build(device="cpu")
    assert data.n_tris == 1 and data.has_textures and data.n_segments == 4


@pytest.mark.parametrize("text,match", [
    ("bogus 1 2 3\n", "unknown directive"),
    ("mesh t.obj GOURAUD\n", "bad draw mode"),
    ("light 1 2 3 4\n", "unexpected end of file"),
    ("depth x\n", "could not convert"),
])
def test_parse_errors(text, match, tmp_path):
    (tmp_path / "t.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    p = tmp_path / "bad.sce"
    p.write_text(text)
    with pytest.raises(SceneParseError, match=match):
        read_scene(str(p))


def test_write_read_round_trip(tmp_path):
    s = Scene()
    s.set_camera(eye=(0, 1, 5), center=(0, 0, 0), up=(0, 1, 0),
                 fovy=45, width=32, height=32)
    s.add_light((1, 2, 3), (0.5, 0.6, 0.7))
    s.background = (0.1, 0.0, 0.0)
    s.max_depth = 4
    s.add_sphere((1, 2, 3), 0.5, Material(mirror=0.25, shininess=12))
    s.add_plane((0, -1, 0), (0, 1, 0), Material(shadowable=False))
    s.add_cylinder((0, 0, 0), (0, 1, 0), 0.3, 2.0, Material())
    p = tmp_path / "rt.sce"
    write_scene(str(p), s)
    back = read_scene(str(p))
    assert back.max_depth == 4 and back.camera.width == 32
    assert back.background == (0.1, 0.0, 0.0)
    _, r, m = back._spheres[0]
    assert r == 0.5 and m.mirror == 0.25
    assert back._planes[0][2].shadowable is False
    assert back._cylinders[0][2:4] == (0.3, 2.0)
    # the reference reads the port's file to the same scene
    ref = rsceneio.read_scene(str(p))
    assert ref.max_depth == back.max_depth and len(ref._cylinders) == 1


def test_demo_scene_builds_as_the_reference(monkeypatch):
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    path = str(REPO / "examples" / "demo.sce")
    ref = rsceneio.read_scene(path).build()
    s = read_scene(path)
    got = s.build(device="cpu")
    for f in ARRAY_FIELDS:
        a, want = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == want.shape and a.dtype == want.dtype, f
        np.testing.assert_array_equal(a, want, err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.n_nodes == ref.n_nodes > 1
    assert (got.n_spheres, got.n_cylinders, got.n_planes) == (1, 1, 1)
    assert got.n_tris == 912 and got.n_segments == 4
    assert (s.camera.width, s.camera.height) == (640, 480)
