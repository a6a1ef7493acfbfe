"""The golden gallery through the port vs the reference.

Each of the ten golden scenes builds in both packages (the reference's
NumPy BVH builder, MRT_NO_NATIVE=1, which the port carries) and must
pack to the same arrays bit for bit. Then each renders through
``render_aa`` at a tenth of its golden resolution: the reference through
its fused path (cluster scan + fused shading, Pallas in interpret mode),
the port through the plain PyTorch versions of its kernels. Bar: >= 99.5%
of pixels within 1e-4 (a flipped fp tie changes a pixel's hit, not the
image). The AA budget covers every above-threshold pixel (the golden
budgets are sized for the full resolution), so the selected pixel set
does not depend on how top-k orders equal deviations.

Also here: the gallery's helpers (shapes, PNG IO, the camera's pixel
grid) against the reference's, and the gallery entry point on the CPU.
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu.models.camera import Camera as RCamera
from myraytracer_tpu.ops import tracer as rtr
from myraytracer_tpu.ops.render import render_aa as r_render_aa
from myraytracer_tpu.scenes import golden as rgolden
from myraytracer_tpu.scenes import shapes as rshapes
from myraytracer_tpu.utils import image as rimage

from myraytracer_tpu_torch.models.camera import Camera
from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, STATIC_FIELDS
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.scenes import golden, shapes
from myraytracer_tpu_torch.utils import image

from test_torch_scene import REPO

REF_CFG = rtr.TraceConfig(tri_method="cluster", use_pallas_cluster=True)
SCALE = 0.1

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

#: name -> (reference Scene, its SceneData, port Scene, port SceneData),
#: built once per process
_BUILT = {}


def _built(name):
    if name not in _BUILT:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MRT_NO_NATIVE", "1")
            rs = rgolden.GOLDEN_SCENES[name][0](scale=SCALE)
            ps = golden.GOLDEN_SCENES[name][0](scale=SCALE)
            _BUILT[name] = (rs, rs.build(), ps, ps.build(device="cpu"))
    return _BUILT[name]


def test_gallery_registry_matches_reference():
    assert list(golden.GOLDEN_SCENES) == list(rgolden.GOLDEN_SCENES)
    for name, (_, budget) in golden.GOLDEN_SCENES.items():
        assert budget == rgolden.GOLDEN_SCENES[name][1], name


@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_golden_builds_match_reference(name):
    rs, ref, ps, port = _built(name)
    for f in ARRAY_FIELDS:
        a, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == want.shape and a.dtype == want.dtype, f
        np.testing.assert_array_equal(a, want, err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert (ps.camera.width, ps.camera.height) == (rs.camera.width,
                                                   rs.camera.height)


@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_golden_render_aa_matches_reference(name):
    rs, ref, ps, port = _built(name)
    cam = ps.camera
    img1 = prender.render(port, cam)
    # a budget that covers the above-threshold pixels with a margin of
    # 3% (at least 4 pixels) for the reference's pass 1
    n_px = cam.width * cam.height
    above = int((prender._deviation(img1) > prender.AA_THRESHOLD).sum())
    budget = min(1.0, max(golden.GOLDEN_SCENES[name][1],
                          (above + max(4, 0.03 * above) + 1) / n_px))
    assert prender.aa_budget_covered(img1, budget)
    want = np.asarray(r_render_aa(ref, rs.camera, cfg=REF_CFG,
                                  budget_frac=budget))
    # render_aa's second pass on the pass-1 image just rendered
    got = prender._aa_refine(port, cam, img1, budget_frac=budget)
    assert got.shape == (cam.height, cam.width, 3)
    got = got.numpy()
    assert np.isfinite(got).all() and 0.0 <= got.min() and got.max() <= 1.0
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.995, (diff <= 1e-4).mean()


@pytest.mark.parametrize("fn,args", [
    ("quad", ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))),
    ("torus", (1.0, 0.3, 12, 8, (0.5, 0, 0))),
    ("checkerboard", (6, 40)),
    ("plane_uv_quad", ((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1))),
])
def test_shapes_match_reference(fn, args):
    got = getattr(shapes, fn)(*args)
    want = getattr(rshapes, fn)(*args)
    got, want = ((x,) if isinstance(x, np.ndarray) else x for x in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pixel_grid_matches_reference():
    args = ((0.0, 1.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0, 7, 5)
    xs, ys = Camera.make(*args).pixel_grid("cpu")
    rxs, rys = RCamera.make(*args).pixel_grid()
    assert xs.shape == (5, 7) and xs.dtype == torch.float32
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(rys))


@pytest.mark.parametrize("name", ["o_05_cube", "o_10_pokemon"])
def test_read_png_matches_reference(name):
    path = REPO / "outputs" / f"{name}.png"
    got = image.read_png(str(path))
    np.testing.assert_array_equal(got, rimage.read_png(str(path)))
    assert got.dtype == np.float32 and got.shape[2] == 3


def test_write_png_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(
        image.to_uint8(img), np.asarray(rimage.to_uint8(img)))
    back = image.read_png(path)
    np.testing.assert_array_equal(back, rimage.read_png(path))
    np.testing.assert_array_equal(back, image.to_uint8(img) / np.float32(255))


def test_gallery_main_on_cpu(tmp_path, capsys):
    golden.main(["--out", str(tmp_path), "--scale", "0.05", "--cpu",
                 "--scene", "o_02"])
    out = capsys.readouterr().out
    assert "o_02_shadow" in out and "on cpu" in out
    img = image.read_png(str(tmp_path / "o_02_shadow.png"))
    assert img.shape == (20, 30, 3) and img.mean() > 0.0


def test_gallery_main_without_out_writes_nothing(monkeypatch, capsys):
    """--out has no default: a run without it, even from the repository
    root, stops before rendering and leaves the reference's committed
    renders in outputs/ untouched."""
    outputs = REPO / "outputs"
    before = {p.name: p.stat().st_mtime_ns for p in outputs.iterdir()}
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit) as exc:
        golden.main(["--cpu", "--scale", "0.05", "--scene", "o_02"])
    assert exc.value.code == 2
    assert "--out" in capsys.readouterr().err
    assert {p.name: p.stat().st_mtime_ns for p in outputs.iterdir()} == before


def test_gallery_main_needs_a_gpu_without_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default build succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        golden.main(["--out", str(tmp_path), "--scale", "0.05",
                     "--scene", "o_02"])
