"""The port's host-side scene build, camera and packing vs the reference.

Both packages build the same authored scenes; every packed array of the
port's ``Scene.build()`` must equal the reference's bit for bit, and the
reference's packed leaves must carry across unchanged
(``scenedata_from_arrays``), so the other port tests can feed both
packages one identical packed scene.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.models.material import Material as RMaterial
from myraytracer_tpu.models.mesh import PHONG as RPHONG, TriangleMesh as RMesh
from myraytracer_tpu.models.scene import Scene as RScene
from myraytracer_tpu.ops import shade as rshade
from myraytracer_tpu.ops.pallas_cluster import (
    pack_cluster_constants as r_pack_cluster_constants)
from myraytracer_tpu.scenes import golden as rgolden
from myraytracer_tpu.scenes.shapes import uv_sphere as r_uv_sphere

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import PHONG, TriangleMesh
from myraytracer_tpu_torch.models.scene import (ARRAY_FIELDS, STATIC_FIELDS,
                                                Scene, scenedata_from_arrays)
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops.cuda_cluster import pack_cluster_constants
from myraytracer_tpu_torch.scenes import golden
from myraytracer_tpu_torch.scenes.shapes import uv_sphere

REPO = Path(__file__).resolve().parent.parent

# one intra-op thread per process: the suite runs several pytest workers
# per host, and a full OpenMP pool in each oversubscribes the cores
torch.set_num_threads(1)


def ref_arrays(data):
    """(arrays, static) of a reference SceneData, as NumPy / Python."""
    arrays = {f: np.asarray(getattr(data, f)) for f in ARRAY_FIELDS}
    static = {f: getattr(data, f) for f in STATIC_FIELDS}
    return arrays, static


def to_port(data, device="cpu"):
    """Carry a reference SceneData across to the port."""
    arrays, static = ref_arrays(data)
    return scenedata_from_arrays(arrays, static, device)


def mesh_scene(pkg, w=24, h=20):
    """A small two-light mesh scene authored with either package."""
    if pkg == "ref":
        S, Mat, Mesh, ph, sphere = RScene, RMaterial, RMesh, RPHONG, r_uv_sphere
    else:
        S, Mat, Mesh, ph, sphere = Scene, Material, TriangleMesh, PHONG, uv_sphere
    s = S()
    s.set_camera(eye=(0, 0.6, 4), center=(0, 0, 0), up=(0, 1, 0), fovy=45,
                 width=w, height=h)
    s.add_light((3, 3, 3), (0.9, 0.9, 0.9))
    s.add_light((-2, 1, 2), (0.3, 0.2, 0.1))
    s.add_light((0, 5, 0), (0.0, 0.0, 0.0))        # culled at build
    s.ambience = (0.15, 0.15, 0.15)
    s.background = (0.02, 0.03, 0.05)
    v, f = sphere(0.9, 8, 12)
    s.add_mesh(Mesh(v, f, material=Mat(
        ambient=(0.1, 0.1, 0.05), diffuse=(0.4, 0.5, 0.2),
        specular=(0.3, 0.3, 0.3), shininess=10), draw_mode=ph))
    v, f = sphere(0.4, 6, 9, center=(1.1, -0.2, 0.6))
    s.add_mesh(Mesh(v, f, material=Mat(diffuse=(0.6, 0.2, 0.2))))
    s.max_depth = 2
    return s


def office(pkg, tess=2, w=64, h=48):
    mod = rgolden if pkg == "ref" else golden
    return mod.scene_08_office(tess=tess, resolution=(w, h))


@pytest.mark.parametrize("name", ["office", "mesh"])
def test_build_matches_reference(name, monkeypatch):
    # the port carries the reference's NumPy BVH builder; the reference's
    # native builder can order SAH ties differently on symmetric meshes
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    make = office if name == "office" else mesh_scene
    ref = make("ref").build()
    got = make("port").build(device="cpu")
    want, static = ref_arrays(ref)
    for f in ARRAY_FIELDS:
        a = getattr(got, f).numpy()
        assert a.shape == want[f].shape, f
        assert a.dtype == want[f].dtype, f
        np.testing.assert_array_equal(a, want[f], err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(got, f) == static[f], f
    assert got.n_segments == ref.n_segments == 1
    assert got.n_lights == ref.n_lights
    assert got.n_nodes == ref.n_nodes == want["bvh_bbmin"].shape[0] > 1


def test_office_shapes():
    data = office("port").build(device="cpu")
    assert data.n_lights == 1                      # zero-colour light culled
    assert data.n_segments == 1                    # no mirrors
    assert not data.has_textures
    assert data.n_spheres == data.n_planes == data.n_cylinders == 0


def test_scenedata_from_arrays_round_trips():
    ref = mesh_scene("ref").build()
    arrays, static = ref_arrays(ref)
    got = scenedata_from_arrays(arrays, static, "cpu")
    for f in ARRAY_FIELDS:
        t = getattr(got, f)
        assert t.dtype in (torch.float32, torch.int32), f
        np.testing.assert_array_equal(t.numpy(), arrays[f], err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(got, f) == static[f]
    missing = dict(arrays)
    del missing["cl_first"]
    with pytest.raises(ValueError, match="cl_first"):
        scenedata_from_arrays(missing, static, "cpu")


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['myraytracer_tpu'] = None; "
            "import myraytracer_tpu_torch as m; "
            "from myraytracer_tpu_torch.ops import render, tracer, cuda_shade; "
            "from myraytracer_tpu_torch.ops import refit, shade_grad; "
            "from myraytracer_tpu_torch.parallel import shard_render; "
            "from myraytracer_tpu_torch.ops import intersect, texture; "
            "from myraytracer_tpu_torch.scenes import golden, kinds; "
            "from myraytracer_tpu_torch.utils import image, checks, profiling; "
            "from myraytracer_tpu_torch.models import objio, sceneio; "
            "from myraytracer_tpu_torch import bench, cli, inverse, __main__; "
            "print(m.render.__module__, m.render_loss_grad_image.__module__, "
            "m.split_params.__module__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "myraytracer_tpu_torch.ops.render" in out.stdout
    assert "myraytracer_tpu_torch.parallel.shard_render" in out.stdout


def test_camera_rays_match_reference():
    rs, ps = office("ref", w=40, h=24), office("port", w=40, h=24)
    rng = np.random.default_rng(5)
    xs = rng.uniform(-0.5, 39.5, 500).astype(np.float32)
    ys = rng.uniform(-0.5, 23.5, 500).astype(np.float32)
    ro, rd = rs.camera.primary_rays(jnp.asarray(xs), jnp.asarray(ys))
    po, pd = ps.camera.primary_rays(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), atol=1e-6)
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), atol=1e-6)


def test_packing_matches_reference():
    ref = mesh_scene("ref").build()
    port = to_port(ref)
    rg = rshade.pack_shade_geom(ref)
    pg = shade.pack_shade_geom(port)
    np.testing.assert_array_equal(pg.tri_pack.numpy(), np.asarray(rg.tri_pack))
    np.testing.assert_array_equal(pg.mat16.numpy(), np.asarray(rg.mat16))
    # same cross products, possibly another summation order for N.p2
    np.testing.assert_allclose(pack_cluster_constants(port).numpy(),
                               np.asarray(r_pack_cluster_constants(ref)),
                               rtol=1e-6, atol=1e-6)


def test_build_defaults_to_cuda():
    """Scene.build() targets the GPU unless the caller asks for the CPU;
    without a GPU it raises instead of falling back."""
    import inspect

    assert inspect.signature(Scene.build).parameters["device"].default == "cuda"
    s = mesh_scene("port")
    if torch.cuda.is_available():
        assert s.build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.build()
    assert s.build(device="cpu").device.type == "cpu"
