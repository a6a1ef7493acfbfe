"""The port's forward render vs the reference's, end to end.

The reference renders through its fused path (cluster scan + fused
shading kernels, interpret mode on the CPU); the port renders through the
plain PyTorch versions of its kernels. Both get the identical packed
scene. Bar: >= 99.5% of pixels within 1e-4 and a mean abs diff <= 1e-4
(a flipped fp tie changes the hit triangle of a pixel, not the image).
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import render as rrender

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import TriangleMesh
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.scenes.shapes import box

from test_torch_scene import mesh_scene, office, to_port

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _agree(got, want):
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.995, (diff <= 1e-4).mean()
    assert np.abs(got - want).mean() <= 1e-4


def test_office_render_matches_reference():
    s = office("ref", tess=2, w=64, h=48)
    ref = s.build()
    want = np.asarray(rrender(ref, s.camera, cfg=REF_CFG))
    port = to_port(ref)
    got = prender.render(port, office("port", tess=2, w=64, h=48).camera)
    assert got.shape == (48, 64, 3) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and 0.05 < got.mean() < 0.95
    _agree(got, want)


def test_mirror_mesh_render_matches_reference():
    """Two lights and a mirror material: three Whitted segments."""
    s = mesh_scene("ref")
    s.meshes[1].material.mirror = 0.5
    ref = s.build()
    assert ref.n_segments == 3 and ref.n_lights == 2
    want = np.asarray(rrender(ref, s.camera, cfg=REF_CFG))
    got = prender.render(to_port(ref), mesh_scene("port").camera).numpy()
    _agree(got, want)


def test_tiled_render_equals_whole_frame():
    data = office("port", tess=2, w=64, h=48).build(device="cpu")
    cam = office("port", tess=2, w=64, h=48).camera
    whole = prender.render(data, cam)
    # 3 screen blocks per tile: the last tile is padded
    tiled = prender.render(data, cam, tile=3 * 1024)
    np.testing.assert_array_equal(tiled.numpy(), whole.numpy())


def test_fit_tile_matches_reference_rule():
    from myraytracer_tpu.ops.render import _fit_tile as r_fit_tile

    for R, tile in ((2040 * 1024, 16384), (4096, 3072), (5 * 1024, 2048),
                    (1000, 512)):
        assert prender._fit_tile(R, tile, 1024) == r_fit_tile(R, tile, 1024)


@pytest.mark.parametrize("what", ["sphere", "plane", "cylinder", "texture"])
def test_unported_scene_kinds_raise(what):
    """The forward renders every kind; the training step still takes
    untextured triangle meshes only."""
    s = mesh_scene("port")
    mat = Material()
    if what == "sphere":
        s.add_sphere((0, 0, 0), 0.5, mat)
    elif what == "plane":
        s.add_plane((0, -1, 0), (0, 1, 0), mat)
    elif what == "cylinder":
        s.add_cylinder((0, 0, 0), (0, 1, 0), 0.3, 1.0, mat)
    else:
        v, f = box((1, 1, 1), (0, 0, -2))
        s.add_mesh(TriangleMesh(
            v, f, material=mat, uv_indices=f, u_coords=np.zeros(8),
            v_coords=np.zeros(8), texture=np.ones((2, 2, 3), np.float32)))
    data = s.build(device="cpu")
    img = prender.render(data, s.camera)
    assert bool(torch.isfinite(img).all())
    target = torch.zeros_like(img)
    with pytest.raises(NotImplementedError):
        prender.render_loss_grad_image(data, s.camera, target)


def test_plain_config_runs_the_same_path_on_cpu():
    data = office("port", tess=2, w=32, h=32).build(device="cpu")
    cam = office("port", tess=2, w=32, h=32).camera
    a = prender.render(data, cam)
    b = prender.render(data, cam, cfg=tr.TraceConfig(plain=True))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
