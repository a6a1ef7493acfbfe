"""The port's runtime guards (utils/checks.py): tests/test_checks.py's
fast cases on the port, on the reference's gradient-test scene (a sphere
with a mirror, a sphere mesh and a floor) carried across unchanged."""

import dataclasses

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.ops.render import render
from myraytracer_tpu_torch.utils.checks import assert_valid_image, checked_trace

from test_grad import grad_scene
from test_torch_scene import to_port

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def port_camera(cam) -> Camera:
    """The port's Camera of a reference camera."""
    return Camera.make(*(np.array(getattr(cam, f)) for f in
                         ("eye", "center", "up", "fovy")), cam.width,
                       cam.height)


def grad_case():
    """(reference Scene, its SceneData, the port's SceneData, the port's
    camera) of tests/test_grad.py's grad_scene."""
    s = grad_scene()
    ref = s.build()
    return s, ref, to_port(ref), port_camera(s.camera)


def central_pixels(cam, n, margin, seed):
    """tests/test_grad.central_rays's pixel coordinates (NumPy)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(cam.width * margin, cam.width * (1 - margin), n)
    ys = rng.uniform(cam.height * margin, cam.height * (1 - margin), n)
    return xs.astype(np.float32), ys.astype(np.float32)


def test_checked_trace_passes_on_clean_scene():
    _, _, data, cam = grad_case()
    xs, ys = central_pixels(cam, 30, 0.3, 0)
    o, d = cam.primary_rays(torch.from_numpy(xs), torch.from_numpy(ys))
    color = checked_trace(data, o.contiguous(), d)
    assert color.shape == (30, 3) and bool(torch.isfinite(color).all())
    assert float(color.max()) > 0.05


@pytest.mark.parametrize("scale,match", [(float("nan"), "non-finite"),
                                         (-1.0, "negative")])
def test_checked_trace_raises(scale, match):
    _, _, data, cam = grad_case()
    bad = dataclasses.replace(data, light_color=data.light_color * scale)
    xs, ys = central_pixels(cam, 10, 0.3, 0)
    o, d = cam.primary_rays(torch.from_numpy(xs), torch.from_numpy(ys))
    with pytest.raises(ValueError, match=match):
        checked_trace(bad, o.contiguous(), d)


@pytest.mark.parametrize("img,match", [
    (np.full((4, 4, 3), np.nan), "non-finite"),
    (np.zeros((4, 3)), r"\[H, W, 3\]"),
    (np.full((2, 2, 3), 1.5), "outside"),
    (torch.full((2, 2, 3), -0.5), "outside"),
])
def test_assert_valid_image_raises(img, match):
    with pytest.raises(ValueError, match=match):
        assert_valid_image(img)


def test_assert_valid_image_passes_a_render():
    _, _, data, cam = grad_case()
    assert_valid_image(render(data, cam))
