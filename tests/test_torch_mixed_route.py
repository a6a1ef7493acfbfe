"""The training replay's ``"fused_mixed"`` route (``tracer.ROUTES``) on
scenes that hold triangles beside spheres or planes: K5/K6's plain
version on the triangle hits and K10/K11's on the sphere and plane hits
of each segment, merged by kind, against the autograd replay of the same
topology (``TraceConfig(fused_shade_grad=False)``) on the CPU.

Cases: o_07 at a tenth of its size (19,680 PHONG triangles over a mirror
plane, two lights) and the mixed scene without its cylinder (a mirror
sphere, plane and mesh reflecting each other, max_depth 2: the rays that
miss die before the last segment).

Tolerances: the colour within rtol 1e-5, atol 1e-5 of the autograd
replay's and of ``trace``'s (test_torch_grad's bar for a segment's
forward); the gradients of the fit's leaves and of the rays within
3e-5 x max|a| (COT_REL, test_torch_grad's bar for a segment's
cotangents).
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as prender
from myraytracer_tpu_torch.ops import shade
from myraytracer_tpu_torch.ops import shade_grad as sg
from myraytracer_tpu_torch.ops import shade_grad_ana as sga
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.parallel.shard_render import (merge_params,
                                                         split_params)
from myraytracer_tpu_torch.scenes import golden, kinds

COT_REL = 3e-5

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

#: the scenes of the route, each (scene, the kinds its segment 1 hits)
SCENES = {
    "toon": (lambda: golden.scene_07_toon_faces(scale=0.1),
             (shade.KIND_TRI,)),
    "mixed": (lambda: kinds.mixed_scene(mirror=0.4, cyl=False, w=24, h=20),
              (shade.KIND_SPHERE, shade.KIND_PLANE, shade.KIND_TRI)),
}
#: the leaves whose gradients are compared, besides the rays
LEAVES = ("mat_diffuse", "light_color", "ambience")


def _case(name):
    build, hit = SCENES[name]
    sc = build()
    data = sc.build(device="cpu")
    o, d = prender.primary_rays_blocked(sc.camera, "cpu")
    return data, o, d, tr.trace_topology(data, o, d), hit


def _replay(data, o, d, topo, fused):
    """(colour, the gradients of LEAVES and of o and d) of trace_shade
    under a squared error against a seeded target."""
    cfg = tr.TraceConfig(fused_shade_grad=fused)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in split_params(data).items()}
    scene = merge_params(data, params)
    oo, dd = (x.clone().requires_grad_(True) for x in (o, d))
    c = tr.trace_shade(scene, oo, dd, topo, cfg)
    tgt = torch.rand(c.shape, generator=torch.Generator().manual_seed(7))
    grads = torch.autograd.grad(((c - tgt) ** 2).sum(),
                                [params[k] for k in LEAVES] + [oo, dd])
    return c.detach(), dict(zip(LEAVES + ("o", "d"), grads))


def _scaled_close(got, want, rel, name):
    got, want = got.numpy(), want.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    tol = rel * max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", list(SCENES))
def test_mixed_route_matches_the_autograd_replay(name):
    """The route's colour and gradients against the autograd replay's on
    the same topology, and its colour against ``trace``'s (the K3/K4
    chain); segment 1 is live and hits the scene's kinds, and some rays
    are dead before the last segment."""
    data, o, d, topo, hit = _case(name)
    assert tr.TraceConfig().replay_route(data) == "fused_mixed"
    assert tr.TraceConfig(fused_shade_grad=False).replay_route(
        data) == "autograd"
    for k in hit:
        assert bool((topo.hit[1] & (topo.kind[1] == k)).any()), k
    live = topo.hit | topo.miss
    assert bool(live[0].all()) and not bool(live[-1].all())
    got, g_got = _replay(data, o, d, topo, True)
    want, g_want = _replay(data, o, d, topo, False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tr.trace(data, o, d).numpy(),
                               rtol=1e-5, atol=1e-5)
    for k in g_want:
        _scaled_close(g_got[k], g_want[k], COT_REL, k)
    assert float(g_want["mat_diffuse"].abs().max()) > 0


def _counted(monkeypatch, counts, mod, names):
    """Count the calls of ``mod``'s functions ``names`` in ``counts``."""
    for nm in names:
        fn = getattr(mod, nm)
        counts[nm] = 0

        def counted(*a, _f=fn, _n=nm):
            counts[_n] += 1
            return _f(*a)
        monkeypatch.setattr(mod, nm, counted)


@pytest.mark.parametrize("name", list(SCENES))
def test_mixed_route_runs_both_segments_once_a_segment(monkeypatch, name):
    """Each segment runs K5 and K10 once forward and K6 and K11 once
    backward (the plain versions, through the kernels' wrappers), adds
    one to the tallies ``replay.fused_tri`` and ``replay.fused_ana``,
    and the pack's material gather once a call (``pack.rowsum``, K12's
    backward): no autograd replay."""
    data, o, d, topo, _ = _case(name)
    counts = {}
    _counted(monkeypatch, counts, sg, ("segment_fwd", "segment_bwd"))
    _counted(monkeypatch, counts, sga, ("segment_ana_fwd", "segment_ana_bwd"))
    replayed = []
    step = tr._replay_segment
    monkeypatch.setattr(tr, "_replay_segment",
                        lambda *a: (replayed.append(1), step(*a))[1])
    before = dict(graphs.TALLIES)
    data = merge_params(data, {"mat_diffuse": data.mat_diffuse.clone()
                               .requires_grad_(True)})
    c = tr.trace_shade(data, o, d, topo)
    c.sum().backward()
    S = data.n_segments
    assert counts == dict.fromkeys(counts, S)
    moved = {k: v - before.get(k, 0) for k, v in graphs.TALLIES.items()
             if v != before.get(k, 0)}
    assert moved == {"replay.fused_tri": S, "replay.fused_ana": S,
                     "pack.rowsum": 1}
    assert not replayed


def test_mixed_route_keeps_the_mixed_pack_32_wide():
    """The 48-column rows are the route's own: ``pack_shade_geom`` of a
    mixed scene stays 32 wide (K3/K4 read it in every render), and the
    route's rows hold it beside each triangle's material row."""
    data, *_ = _case("mixed")
    geom = shade.pack_shade_geom(data)
    assert geom.tri_pack.shape == (data.n_tris, 32)
    mixed = tr._mixed_geom(data, geom, tr.TraceConfig())
    assert mixed.tri_pack.shape == (data.n_tris, 48)
    assert torch.equal(mixed.tri_pack[:, :32], geom.tri_pack)
    assert torch.equal(mixed.tri_pack[:, 32:],
                       geom.mat16[data.tri_mat.long()])
    assert mixed.mat16 is geom.mat16 and mixed.ana16 is geom.ana16
