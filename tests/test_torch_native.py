"""The port's native (C++) BVH builder (runtime/native.py) against its
NumPy builder and the reference's.

Counterpart of tests/test_native.py, on its random meshes: the native
build equals the port's NumPy build array for array, bit for bit, with
the median split and with the binned SAH, passes validate_bvh, and
equals the reference's NumPy builder (MRT_NO_NATIVE=1 set inside the
test, as tests/test_native.py does). ``native=True`` raises, and never
falls back to NumPy, when the library cannot be built. The tests that
build skip only when ``g++`` is missing.
"""

import inspect
import shutil

import numpy as np
import pytest

from myraytracer_tpu.ops.bvh import build_bvh as r_build_bvh

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, Scene
from myraytracer_tpu_torch.ops.bvh import build_bvh, validate_bvh
from myraytracer_tpu_torch.runtime import native
from myraytracer_tpu_torch.scenes.golden import scene_08_office

FIELDS = ("bbmin", "bbmax", "left", "first", "count", "axis", "entry",
          "skip", "order")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native BVH builder cannot be built")


def random_mesh(n, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    tri = (base + rng.normal(size=(n, 3, 3)) * 0.5).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


def assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.n_nodes == b.n_nodes and a.max_leaf == b.max_leaf


@pytest.mark.parametrize("builder", ["median", "sah"])
@pytest.mark.parametrize("n,leaf", [(1, 2), (7, 2), (300, 2), (300, 4),
                                    (1000, 8)])
def test_native_matches_numpy(gxx, n, leaf, builder, monkeypatch):
    v0, v1, v2 = random_mesh(n, n)
    got = build_bvh(v0, v1, v2, leaf, builder, native=True)
    assert_same(got, build_bvh(v0, v1, v2, leaf, builder))
    o = got.order
    validate_bvh(got, v0[o], v1[o], v2[o])
    monkeypatch.setenv("MRT_NO_NATIVE", "1")
    assert_same(got, r_build_bvh(v0, v1, v2, leaf_size=leaf, builder=builder))


def test_native_degenerate_centroids(gxx):
    rng = np.random.default_rng(0)
    tri = np.tile(rng.normal(size=(1, 3, 3)).astype(np.float32), (33, 1, 1))
    a = build_bvh(tri[:, 0], tri[:, 1], tri[:, 2], 2, native=True)
    assert a.max_leaf <= 2
    assert_same(a, build_bvh(tri[:, 0], tri[:, 1], tri[:, 2], 2))


def test_validate_bvh_finds_a_broken_tree(gxx):
    v0, v1, v2 = random_mesh(300, 3)
    tree = build_bvh(v0, v1, v2, 4, native=True)
    leaf = int(np.flatnonzero(tree.left < 0)[0])
    tree.bbmax[leaf] = tree.bbmin[leaf]
    o = tree.order
    with pytest.raises(AssertionError, match="outside leaf"):
        validate_bvh(tree, v0[o], v1[o], v2[o])


def test_scene_build_native_equals_numpy(gxx):
    sc = scene_08_office(tess=2, resolution=(64, 48))
    got = sc.build(device="cpu", native=True)
    want = sc.build(device="cpu")
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    assert inspect.signature(Scene.build).parameters["native"].default is False
    assert inspect.signature(Scene.pack).parameters["native"].default is False


def test_native_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    v0, v1, v2 = random_mesh(7, 7)
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        build_bvh(v0, v1, v2, 2, native=True)


def test_native_raises_when_the_build_fails(gxx, tmp_path, monkeypatch):
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    v0, v1, v2 = random_mesh(7, 7)
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        build_bvh(v0, v1, v2, 2, native=True)
    assert not list((tmp_path / "build").glob("*.so"))
