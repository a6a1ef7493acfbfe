"""The port's shading kernels (K3 pre, K4 phong) vs the reference.

The reference runs ``pallas_shade.shade_pre`` / ``shade_phong`` in
interpret mode; the port runs the plain PyTorch versions (CPU tensors).
Inputs are real hits on a triangle-only, untextured mesh scene plus
NumPy-seeded liveness, weights and shadow masks, for one and two lights.

Tolerance: rtol 1e-5, atol 1e-6 on floats (the reference's rsqrt and the
port's may differ in the last bit; everything else is the same fp32
expression in the same order); integer outputs (material id, shadow-ray
activity) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myraytracer_tpu.ops import pallas_shade as rps
from myraytracer_tpu.ops import shade as rshade

from myraytracer_tpu_torch.ops import cuda_cluster as cc
from myraytracer_tpu_torch.ops import cuda_shade as cs
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.ops.render import primary_rays_blocked

from test_torch_scene import mesh_scene, to_port

TOL = dict(rtol=1e-5, atol=1e-6)

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)


def _inputs(n_lights, seed=0):
    s = mesh_scene("ref", w=32, h=32)
    ref = s.build()
    port = to_port(ref)
    o, d = primary_rays_blocked(mesh_scene("port", w=32, h=32).camera, "cpu")
    hit = cc.intersect_clusters(port, o, d)
    R = o.shape[0]
    rng = np.random.default_rng(seed)
    live = rng.uniform(size=R) > 0.1
    valid = (hit.idx.numpy() >= 0) & live
    kind = np.where(valid, shade.KIND_TRI, shade.KIND_MISS).astype(np.int32)
    tri_idx = np.where(valid, np.maximum(hit.idx.numpy(), 0), 0).astype(np.int32)
    geom = shade.pack_shade_geom(port)
    return dict(ref=ref, port=port, o=o.numpy(), d=d.numpy(),
                t=hit.t.numpy(), kind=kind, live=live, tri_idx=tri_idx,
                tri_pack=geom.tri_pack.numpy(), mat16=geom.mat16.numpy(),
                lp=np.array(ref.light_pos)[:n_lights],
                lc=np.array(ref.light_color)[:n_lights], rng=rng)


@pytest.mark.parametrize("n_lights", [1, 2])
def test_shade_pre_matches_reference(n_lights):
    x = _inputs(n_lights)
    assert (x["kind"] > 0).mean() > 0.2
    want = rps.shade_pre(
        jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(x["t"]),
        jnp.asarray(x["kind"]), jnp.asarray(x["live"]),
        jnp.asarray(x["tri_pack"][x["tri_idx"]]), None,
        jnp.asarray(x["mat16"]), jnp.asarray(x["lp"]), interpret=True)
    point, normal, mid, _, so, sd, st, sact = [
        None if w is None else np.asarray(w) for w in want]
    got = cs.shade_pre(
        torch.from_numpy(x["o"]), torch.from_numpy(x["d"]),
        torch.from_numpy(x["t"]), torch.from_numpy(x["kind"]),
        torch.from_numpy(x["live"].astype(np.int32)),
        torch.from_numpy(x["tri_idx"]), torch.from_numpy(x["tri_pack"]),
        torch.from_numpy(x["mat16"]), torch.from_numpy(x["lp"]))
    g = [t.numpy() for t in got]
    R = x["o"].shape[0]
    assert g[3].shape == (n_lights * R, 4)
    for name, a, b in (("point", g[0], point), ("normal", g[1], normal),
                       ("so", g[3], so), ("sd", g[4], sd), ("st", g[5], st)):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    np.testing.assert_array_equal(g[2], mid)
    np.testing.assert_array_equal(g[6], sact)
    assert sact.any() and not sact.all()


@pytest.mark.parametrize("n_lights", [1, 2])
def test_shade_phong_matches_reference(n_lights):
    x = _inputs(n_lights, seed=1)
    rng = x["rng"]
    R = x["o"].shape[0]
    mat16 = x["mat16"].copy()
    mat16[0, 10] = 0.4          # one mirror material: exercise the bounce
    pre = cs.shade_pre(
        torch.from_numpy(x["o"]), torch.from_numpy(x["d"]),
        torch.from_numpy(x["t"]), torch.from_numpy(x["kind"]),
        torch.from_numpy(x["live"].astype(np.int32)),
        torch.from_numpy(x["tri_idx"]), torch.from_numpy(x["tri_pack"]),
        torch.from_numpy(mat16), torch.from_numpy(x["lp"]))
    point, normal, mid = (t.numpy() for t in pre[:3])
    weight = np.where(rng.uniform(size=R) < 0.1, 0.0,
                      rng.uniform(0.2, 1.0, R)).astype(np.float32)
    live = x["live"] & (weight > 0)
    valid = x["kind"] > 0
    shadow = rng.uniform(size=(n_lights, R)) < 0.3
    env = np.concatenate([np.asarray(x["ref"].ambience),
                          np.asarray(x["ref"].background)]).astype(np.float32)

    want = rps.shade_phong(
        jnp.asarray(x["o"]), jnp.asarray(x["d"]), jnp.asarray(weight),
        jnp.asarray(valid), jnp.asarray(live), jnp.asarray(mid),
        jnp.asarray(point), jnp.asarray(normal), jnp.asarray(shadow),
        jnp.asarray(mat16), jnp.asarray(x["lp"]), jnp.asarray(x["lc"]),
        jnp.asarray(env[:3]), jnp.asarray(env[3:]), interpret=True)
    got = cs.shade_phong(
        torch.from_numpy(x["o"]), torch.from_numpy(x["d"]),
        torch.from_numpy(weight), torch.from_numpy(valid.astype(np.int32)),
        torch.from_numpy(live.astype(np.int32)), torch.from_numpy(mid),
        torch.from_numpy(point), torch.from_numpy(normal),
        torch.from_numpy(shadow.astype(np.int32)), torch.from_numpy(mat16),
        torch.from_numpy(x["lp"]), torch.from_numpy(x["lc"]),
        torch.from_numpy(env))
    for name, a, b in zip(("add", "o2", "d2", "w2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
    assert (got[3].numpy() > 0).any()          # some rays bounce on


def test_shade_pre_without_lights():
    x = _inputs(0)
    got = cs.shade_pre(
        torch.from_numpy(x["o"]), torch.from_numpy(x["d"]),
        torch.from_numpy(x["t"]), torch.from_numpy(x["kind"]),
        torch.from_numpy(x["live"].astype(np.int32)),
        torch.from_numpy(x["tri_idx"]), torch.from_numpy(x["tri_pack"]),
        torch.from_numpy(x["mat16"]), torch.zeros((0, 3)))
    assert got[3].shape == (0, 4) and got[6].shape == (0,)


def test_shade_geom_matches_reference_rows():
    """tri_pack rows gathered by the port's hit ids equal the reference's
    ShadeGeom rows (the pre kernel reads them by id)."""
    x = _inputs(1)
    rg = rshade.pack_shade_geom(x["ref"])
    np.testing.assert_array_equal(x["tri_pack"], np.asarray(rg.tri_pack))
    assert x["tri_pack"].shape[1] == 48
    assert np.isfinite(x["t"][x["kind"] > 0]).all()
    assert (x["t"][x["kind"] == 0][:10] <= np.float32(INF)).all()
