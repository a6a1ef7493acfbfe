"""Large-scene hardening of the port: >100k triangles, >1,000 clusters.

Counterpart of tests/test_large_scene.py. Office at tess 28 and 64x64,
built on the CPU with ``Scene.build``'s default builder (the native one
where ``g++`` is found, else NumPy: both give the same arrays), and the
reference's 512 rays sampled with ``default_rng(5)``. The port's two
triangle paths, its cluster scan and its BVH walk (their plain versions
on the CPU, the kernels' twins), must agree with each other: equal hit
masks, ``t`` within rtol 1e-5 on hits. Both are held to the reference's
``intersect_clusters`` on the same packed scene (the port's build
carried across) at the port's parity bar: >= 99.5% id agreement, ``t``
fp32-allclose (rtol 1e-5).

The reference's chunked phase-1 test (``cluster.STORE_LIMIT`` forced
down) has no counterpart: that chunking bounds TPU memory and is listed
under "Not ported" in ROADMAP.md; the port's phase-1 (K2 and its plain
version) has no store limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.models.scene import SceneData as RSceneData
from myraytracer_tpu.ops import cluster as rcluster

from myraytracer_tpu_torch.models.scene import ARRAY_FIELDS, STATIC_FIELDS
from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.scenes.golden import scene_08_office

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

TESS = 28  # 110,572 triangles, 1,356 clusters
ID_AGREE, RTOL_T = 0.995, 1e-5


@pytest.fixture(scope="module")
def big():
    """The scene, its rays and each path's hits (computed once)."""
    sc = scene_08_office(tess=TESS, resolution=(64, 64))
    data = sc.build(device="cpu")
    rng = np.random.default_rng(5)
    xs = rng.uniform(0, 64, 512).astype(np.float32)
    ys = rng.uniform(0, 64, 512).astype(np.float32)
    o, d = sc.camera.primary_rays(torch.from_numpy(xs), torch.from_numpy(ys))
    o, d = o.contiguous(), d.contiguous()
    ref = RSceneData(**{f: jnp.asarray(getattr(data, f).numpy())
                        for f in ARRAY_FIELDS},
                     **{f: getattr(data, f) for f in STATIC_FIELDS})
    want = rcluster.intersect_clusters(ref, jnp.asarray(o.numpy()),
                                       jnp.asarray(d.numpy()))
    return dict(data=data, cluster=cc.intersect_clusters(data, o, d),
                walk=trv.traverse_bvh(data, o, d),
                ref_idx=np.asarray(want.idx), ref_t=np.asarray(want.t))


def test_scene_scale(big):
    data = big["data"]
    assert data.n_tris > 100_000
    assert data.cl_first.shape[0] > 1_000
    assert data.n_nodes > 2 * data.cl_first.shape[0]


def test_cluster_scan_agrees_with_bvh_walk(big):
    got, want = big["cluster"], big["walk"]
    hit = want.idx >= 0
    assert torch.equal(got.idx >= 0, hit)
    assert float(hit.float().mean()) > 0.5, "camera rays should mostly hit"
    np.testing.assert_allclose(got.t[hit].numpy(), want.t[hit].numpy(),
                               rtol=RTOL_T)


@pytest.mark.parametrize("path", ["cluster", "walk"])
def test_paths_match_reference_cluster_scan(big, path):
    got = big[path]
    idx, t = got.idx.numpy(), got.t.numpy()
    assert (idx == big["ref_idx"]).mean() >= ID_AGREE, path
    hit = big["ref_idx"] >= 0
    np.testing.assert_array_equal(idx >= 0, hit)
    np.testing.assert_allclose(t[hit], big["ref_t"][hit], rtol=RTOL_T)
