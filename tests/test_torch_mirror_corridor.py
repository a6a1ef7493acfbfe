"""The mirror corridor (golden o_03, the benchmark's ``mirror-1000x400``) on
the CPU at 100x40: the port's ``render`` and ``render_aa`` against the
benchmark's plain reference (``rtbench/reference/whitted.py``) on the
frozen generator's arrays, at several mirror depths and with materials
and a light drawn from a seed; and the segment counters that K3 keeps
(``tracer.live_rays``, ``segments_run``, ``rays_run``) against a plain
count of the live rays of each segment."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import compare  # noqa: E402
from rtbench.port_scene import port_camera, port_scene  # noqa: E402
from rtbench.reference import whitted as W  # noqa: E402
from rtbench.scenes import scene_03_mirror  # noqa: E402

from myraytracer_tpu_torch.ops import cuda_shade as cs  # noqa: E402
from myraytracer_tpu_torch.ops import graphs  # noqa: E402
from myraytracer_tpu_torch.ops import render as prender  # noqa: E402
from myraytracer_tpu_torch.ops import tracer as tr  # noqa: E402

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

W_PX, H_PX = 100, 40
BUDGET = 0.004
CFG = tr.TraceConfig(tri_method="auto")


def _arrays(max_depth: int = 20, seed=None) -> dict:
    """The corridor at 100x40, with ``max_depth``; with a ``seed``, its
    materials and light drawn from it (the walls' mirror in [0.5, 0.95])."""
    a = scene_03_mirror.generate(W_PX, H_PX)
    a["max_depth"] = int(max_depth)
    if seed is not None:
        rng = np.random.default_rng(seed)
        n = a["mat_mirror"].shape[0]
        for k in ("mat_ambient", "mat_diffuse", "mat_specular"):
            a[k] = rng.uniform(0.0, 0.8, (n, 3)).astype(np.float32)
        a["mat_shininess"] = rng.uniform(1.0, 80.0, n).astype(np.float32)
        mirror = rng.uniform(0.0, 0.5, n).astype(np.float32)
        mirror[a["plane_mat"]] = rng.uniform(0.5, 0.95)
        a["mat_mirror"] = mirror
        a["light_pos"] = np.asarray([[rng.uniform(-2.0, 2.0),
                                      rng.uniform(2.0, 8.0),
                                      rng.uniform(-3.0, 3.0)]], np.float32)
        a["light_color"] = rng.uniform(0.3, 1.0, (1, 3)).astype(np.float32)
    return a


def _program(arrays, aa: bool):
    data = port_scene(arrays).build(device="cpu")
    cam = port_camera(arrays["camera"], "cpu")
    if aa:
        return prender.render_aa(data, cam, CFG, budget_frac=BUDGET)
    return prender.render(data, cam, CFG)


def _reference(arrays, aa: bool):
    scene = W.RefScene(arrays, "cpu")
    if aa:
        return W.render_aa(scene, arrays["camera"], BUDGET, 4, 0.02, ties=True)
    return W.render(scene, arrays["camera"], ties=True)


def _assert_matches(arrays, aa: bool) -> None:
    img = _program(arrays, aa)
    ref, unsure = _reference(arrays, aa)
    got = compare.image_numbers(img, ref, unsure)
    assert got["bad_px"] == 0.0, got
    assert got["mean_abs"] < 1e-6, got


@pytest.mark.parametrize("aa", [False, True], ids=["render", "render_aa"])
@pytest.mark.parametrize("max_depth", [1, 3, 20])
def test_corridor_matches_the_plain_reference(max_depth, aa):
    _assert_matches(_arrays(max_depth), aa)


@pytest.mark.parametrize("seed", [2 ** 31 + 19, 7])
def test_corridor_with_seeded_materials_matches_the_plain_reference(seed):
    arrays = _arrays(20, seed)
    assert 0.5 <= float(arrays["mat_mirror"][arrays["plane_mat"][0]]) <= 0.95
    _assert_matches(arrays, True)


def test_deep_segments_change_the_image():
    """A loop cut short shows: depths 3 and 20 give different images."""
    assert not torch.equal(_program(_arrays(3), False),
                           _program(_arrays(20), False))


def _plain_live_counts(data, cam) -> list:
    """Rays with weight > 0 entering each segment of render's trace, from
    segment_step run by hand outside any entry point (so uncounted)."""
    o, d = prender.primary_rays_blocked(cam, "cpu")
    pack = tr.pack_trace(data, CFG)
    carry = tr.Bounce(o=o, d=d, weight=torch.ones(o.shape[0]),
                      color=torch.zeros((o.shape[0], 3)))
    out = []
    for _ in range(data.n_segments):
        out.append(int((carry.weight > 0).sum()))
        carry, _ = tr.segment_step(data, pack, carry, CFG)
    return out


def test_segment_counters_equal_a_plain_count_of_live_rays():
    graphs.clear()
    arrays = _arrays(20)
    data = port_scene(arrays).build(device="cpu")
    cam = port_camera(arrays["camera"], "cpu")
    want = _plain_live_counts(data, cam)
    assert graphs.counters("render", tr.COUNTERS) == []
    for _ in range(2):
        prender.render(data, cam, CFG)
    got = [tr.live_rays("render", s) for s in range(data.n_segments)]
    assert got == [2 * n for n in want]
    assert tr.live_rays("render") == 2 * sum(want)
    assert tr.live_rays("render", data.n_segments) == 0
    # every segment with a live ray ran, once a call; the corridor keeps
    # rays alive to the last one
    ran = sum(1 for n in want if n)
    assert ran == data.n_segments
    assert tr.segments_run("render") == 2 * ran
    assert tr.rays_run("render") == 2 * ran * (128 * 64)
    assert 0 < want[-1] < want[0]
    graphs.clear()
    assert tr.segments_run("render") == 0 and tr.live_rays("render", 0) == 0


def test_a_dead_segment_counts_no_body():
    """A segment run eagerly with no live ray counts neither a live ray
    nor a body: the counts of a replay that skips it."""
    graphs.clear()
    arrays = _arrays(3)
    arrays["mat_mirror"][:] = 0.0
    arrays["mat_mirror"][arrays["sphere_mat"][0]] = 0.2
    data = port_scene(arrays).build(device="cpu")
    cam = port_camera(arrays["camera"], "cpu")
    want = _plain_live_counts(data, cam)
    prender.render(data, cam, CFG)
    got = [tr.live_rays("render", s) for s in range(data.n_segments)]
    assert got == want
    assert want[-1] == 0
    assert tr.segments_run("render") == sum(1 for n in want if n)
    graphs.clear()


def test_shade_pre_plain_counts_live_rays_and_its_condition():
    o = torch.zeros((6, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(6, 3).contiguous()
    zi = torch.zeros(6, dtype=torch.int32)
    live = torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.int32)
    args = (o, d, torch.full((6,), 1e30), zi, live, zi, zi,
            torch.zeros((1, 32)), torch.zeros((1, 16)), torch.zeros((1, 16)),
            torch.zeros((1, 3)))
    counts = torch.zeros(3, dtype=torch.int64)
    base = cs.shade_pre_plain(*args)
    got = cs.shade_pre_plain(*args, counts=counts)
    assert counts.tolist() == [3, 1, 6]
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    cs.shade_pre(*args, counts=counts, cond=torch.tensor(False))
    assert counts.tolist() == [6, 1, 6]
    cs.shade_pre(*args, counts=counts, cond=torch.tensor(True))
    assert counts.tolist() == [9, 2, 12]
