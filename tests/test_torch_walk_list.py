"""The list walk of the bounce segments' triangle queries on the CPU.

``traverse_bvh(listed=True)`` (every segment after the first,
ops/tracer._tri_query) on the card lists the active rays (csrc/bvh_walk.cu
``walk_list_kernel``, whose plain version is ``walk_list_plain``) and
walks the list alone; here the walk of the listed rays alone
(``_walk_listed``) must equal the walk over the masked batch to the bit,
for closest and any hit. Each listed query, on the CPU too, adds one to
the tally ``"walk.list"`` and its rays to the region's counters
``traverse.listed`` (``traverse.listed_rays``). The card's kernels are
held against these in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from myraytracer_tpu_torch.models.material import Material
from myraytracer_tpu_torch.models.mesh import FLAT, TriangleMesh
from myraytracer_tpu_torch.models.scene import Scene
from myraytracer_tpu_torch.ops import graphs, render as prender
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch.ops import traverse as trv
from myraytracer_tpu_torch.ops.intersect import INF
from myraytracer_tpu_torch.scenes.golden import scene_08_office, scene_09_rings

torch.set_num_threads(1)

DENSITIES = [0.0, 0.01, 0.3, 1.0]


def _case(seed, n_tris=300, R=1500):
    """A random-triangle scene and R random rays (R not a multiple of 32)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-8, 8, size=(n_tris, 1, 3))
    tri = (base + rng.normal(size=(n_tris, 3, 3)) * 0.5).astype(np.float32)
    s = Scene()
    s.add_light((2, 9, 4), (0.8, 0.8, 0.8))
    s.add_mesh(TriangleMesh(tri.reshape(-1, 3),
                            np.arange(3 * n_tris).reshape(n_tris, 3),
                            material=Material(), draw_mode=FLAT))
    o = rng.uniform(-15, 15, size=(R, 3)).astype(np.float32)
    d = rng.uniform(-6, 6, size=(R, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:5, 1] = -0.0                               # 1/d = -inf
    return (s.build(device="cpu", native=False), torch.from_numpy(o),
            torch.from_numpy(d), rng)


def _walk_listed(data, o, d, t_max=None, any_hit=False, active=None,
                 tri_flat=None):
    """What K7's list launch walks: the rays of ``walk_list_plain``'s list
    alone, each result written back to its ray over the list's misses."""
    ids, t, idx = trv.walk_list_plain(active)
    part = trv.traverse_bvh_plain(data, o[ids], d[ids],
                                  None if t_max is None else t_max[ids],
                                  any_hit, tri_flat=tri_flat)
    t[ids], idx[ids] = part.t, part.idx
    return trv.TriHit(idx, t)


@pytest.mark.parametrize("density", DENSITIES)
def test_walk_list_plain_lists_the_live_rays(density):
    rng = np.random.default_rng(7)
    R = 2500
    active = torch.from_numpy(rng.uniform(size=R) < density)
    counts = torch.zeros(2, dtype=torch.int64)
    ids, t, idx = trv.walk_list_plain(active, counts)
    n = int(active.sum())
    assert ids.shape == (n,) and torch.equal(ids, torch.nonzero(active)[:, 0])
    assert bool((ids[1:] > ids[:-1]).all())                  # call order
    assert torch.equal(t, torch.full((R,), INF))
    assert torch.equal(idx, torch.full((R,), -1, dtype=torch.int32))
    # a launch that listed nothing adds nothing, as a skipped body would
    assert counts.tolist() == ([n, R] if n else [0, 0])


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("density", DENSITIES)
def test_list_walk_equals_the_walk(any_hit, density):
    data, o, d, rng = _case(31)
    R = o.shape[0]
    active = torch.from_numpy(rng.uniform(size=R) < density)
    t_max = (torch.from_numpy(rng.uniform(0.5, 30.0, R).astype(np.float32))
             if any_hit else None)
    want = trv.traverse_bvh_plain(data, o, d, t_max=t_max, any_hit=any_hit,
                                  active=active)
    got = _walk_listed(data, o, d, t_max=t_max, any_hit=any_hit,
                       active=active)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.t, want.t)
    listed = trv.traverse_bvh(data, o, d, t_max=t_max, any_hit=any_hit,
                              active=active, listed=True)
    assert torch.equal(listed.idx, want.idx) and torch.equal(listed.t, want.t)
    if density >= 0.3:
        assert bool((want.idx >= 0).any())
    assert bool((want.idx[~active] == -1).all())


def _bounce_queries(monkeypatch, scene, camera, cfg):
    """The listed triangle queries of one ``render`` call on the CPU:
    (o, d, kwargs) of each."""
    got = []
    orig = trv.traverse_bvh

    def spy(sc, o, d, **kw):
        if kw.get("listed"):
            got.append((o.clone(), d.clone(), dict(kw)))
        return orig(sc, o, d, **kw)
    with monkeypatch.context() as m:
        m.setattr(trv, "traverse_bvh", spy)
        prender.render(scene, camera, cfg=cfg)
    return got


def test_list_walk_on_the_rings_bounce_rays(monkeypatch):
    """The rings' reflected rays (segments 1 to 3, closest and shadow
    queries) walked from their list equal the masked walk to the bit."""
    s = scene_09_rings(scale=0.08, seg=16)
    data = s.build(device="cpu")
    cfg = tr.TraceConfig(tri_method="bvh")
    got = _bounce_queries(monkeypatch, data, s.camera, cfg)
    assert len(got) == 6                          # 3 segments x 2 queries
    assert sum(bool(kw["any_hit"]) for _, _, kw in got) == 3
    n_live = 0
    for o, d, kw in got:
        plain = {k: v for k, v in kw.items() if k not in ("listed", "plain")}
        want = trv.traverse_bvh_plain(data, o, d, **plain)
        hit = _walk_listed(data, o, d, **plain)
        assert torch.equal(hit.idx, want.idx) and torch.equal(hit.t, want.t)
        n_live += int(kw["active"].sum())
    assert n_live > 0
    # segment 1's closest query: rays that left a mirror
    assert int(got[0][2]["active"].sum()) > 0 and not got[0][2]["any_hit"]


def test_bounce_queries_are_listed_and_counted(monkeypatch):
    """A rings render_aa lists 12 queries (3 bounce segments x closest and
    shadow x 2 passes), and the counters hold the rays each listed; the
    office scene (one segment) lists none."""
    s = scene_09_rings(scale=0.08, seg=16)
    data = s.build(device="cpu")
    cfg = tr.TraceConfig(tri_method="bvh")
    before = dict(graphs.TALLIES)
    want = [0, 0]
    orig = trv.traverse_bvh

    def spy(sc, o, d, **kw):
        n = int(kw["active"].sum()) if kw.get("listed") else 0
        if n:
            want[0] += n
            want[1] += o.shape[0]
        return orig(sc, o, d, **kw)
    start = [trv.listed_rays(e) for e in ("render", "aa_refine")]
    with monkeypatch.context() as m:
        m.setattr(trv, "traverse_bvh", spy)
        prender.render_aa(data, s.camera, budget_frac=0.05, cfg=cfg)
    assert graphs.TALLIES["walk.list"] - before.get("walk.list", 0) == 12
    end = [trv.listed_rays(e) for e in ("render", "aa_refine")]
    listed = sum(b[0] - a[0] for a, b in zip(start, end))
    rays = sum(b[1] - a[1] for a, b in zip(start, end))
    assert (listed, rays) == tuple(want) and 0 < listed < rays
    o = scene_08_office(tess=2, resolution=(32, 24))
    before = graphs.TALLIES["walk.list"]
    prender.render_aa(o.build(device="cpu"), o.camera, budget_frac=0.05,
                      cfg=cfg)
    assert graphs.TALLIES["walk.list"] == before
