"""The port's tracing (utils/profiling.py), on the CPU.

Host spans: with no profiler recording, ``span()`` is one shared no-op
context and enters no profiler op; under a CPU ``torch.profiler`` the
entry points and the fit loop record their ``mrt.*`` spans, and with the
CUDA-graph machinery stood in for (as tests/test_torch_diff_graphs.py
does), ``graphs.run``'s key, stage, launch and clone spans, its set-up
seconds and its evictions. Device marks: on CPU tensors a mark launches
nothing and counts no launch; the phase table is unique, keeps every
earlier phase's index, and every call site names one of its phases; no
mark is made while a backward runs; and the marks each entry point
makes, in order, on office and o_04 (an office frame makes 13, a fit
step 11, each graph adding ``end``), and on the o_09 rings, whose later
segments mark their triangle queries ``tri.bounce``. The autograd
replay's ``shade.autograd``: tests/test_torch_toon_fit.py.
"""

import ast
import contextlib
import re
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myraytracer_tpu_torch.inverse import InverseRenderer, adam
from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import render as R
from myraytracer_tpu_torch.ops import tracer as tr
from myraytracer_tpu_torch import inverse as I
from myraytracer_tpu_torch.scenes.golden import (scene_04_molecule,
                                                 scene_08_office,
                                                 scene_09_rings)
from myraytracer_tpu_torch.utils import profiling

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

PKG = Path(profiling.__file__).resolve().parent.parent
ROOT = PKG.parent


def _office(resolution=(32, 24)):
    s = scene_08_office(tess=2, resolution=resolution)
    return s.build(device="cpu"), s.camera


def _molecule():
    s = scene_04_molecule(scale=0.05, n_atoms=24)
    return s.build(device="cpu"), s.camera


def _rings():
    """o_09's two Phong mirror tori at 35 x 25, 8 x 4 segments each (128
    triangles), max_depth 3."""
    s = scene_09_rings(scale=0.05, seg=8)
    return s.build(device="cpu"), s.camera


#: the triangle method of the profiled calls: the fewest operations on
#: the CPU, so the profiles stay small
BRUTE = tr.TraceConfig(tri_method="brute")


def _spans(fn):
    """The ``mrt.*`` host events of ``fn()`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("mrt.")]


class _Spans(list):
    """The names of the spans opened, as if a profiler recorded: the
    profiler's flag set and its range replaced by a recorder."""

    def __call__(self, name):
        self.append(name)
        return contextlib.nullcontext()


@pytest.fixture
def recorded_spans(monkeypatch):
    names = _Spans()
    monkeypatch.setattr(profiling, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(profiling, "_RANGE", names)
    return names


def _fit(data, cam, steps=1, method="auto"):
    inv = InverseRenderer(data, ("mat_diffuse", "light_color"),
                          optimizer=adam(0.05), camera=cam,
                          cfg=tr.TraceConfig(tri_method=method,
                                             texture_filter="bilinear"))
    xs, ys = (g.reshape(-1) for g in cam.pixel_grid("cpu"))
    tgt = torch.full((xs.numel(), 3), 0.4)
    return lambda: inv.fit_pixels(xs, ys, tgt, steps=steps)


# --- spans ---------------------------------------------------------------

def _raising(*args, **kwargs):
    raise RuntimeError("a profiler op was entered")


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """No span enters the profiler's op (torch's own ranges, such as
    the optimizer's, still do), nor opens a range."""
    enter = torch.ops.profiler._record_function_enter_new

    def watched(name, *args, **kwargs):
        if name.startswith("mrt."):
            _raising()
        return enter(name, *args, **kwargs)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        watched)
    monkeypatch.setattr(profiling, "_RANGE", _raising)
    assert profiling.span("render") is profiling._NOOP
    assert profiling.span("graphs.launch", "aa_refine") is profiling._NOOP
    data, cam = _office()
    R.render_aa(data, cam, budget_frac=0.05)
    _fit(data, cam)()
    with profile(activities=[ProfilerActivity.CPU]):
        # the patch holds: under a profiler a span opens its range
        with pytest.raises(RuntimeError, match="profiler op"):
            profiling.span("render")


@pytest.mark.parametrize("entry", ["render_aa", "render", "fit"])
def test_entry_points_record_their_spans(entry):
    data, cam = _office((16, 12))
    fn = {"render_aa": lambda: R.render_aa(data, cam, BRUTE,
                                           budget_frac=0.05),
          "render": lambda: R.render(data, cam, BRUTE),
          "fit": _fit(data, cam, steps=2, method="brute")}[entry]
    names = _spans(fn)
    want = {"render_aa": {"mrt.render_aa", "mrt.render", "mrt.aa_refine",
                          "mrt.graphs.key render", "mrt.graphs.stage render",
                          "mrt.graphs.key aa_refine",
                          "mrt.graphs.stage aa_refine"},
            "render": {"mrt.render", "mrt.graphs.key render",
                       "mrt.graphs.stage render"},
            "fit": {"mrt.fit.step", "mrt.fit.loss_read", "mrt.fit.result"}
            }[entry]
    assert want <= set(names), names
    if entry == "fit":
        assert names.count("mrt.fit.step") == 2
        assert names.count("mrt.fit.loss_read") == 2
    else:
        assert names.count(f"mrt.{entry}") == 1


class _Stand:
    """A stand-in CUDA graph: a replay calls its region again."""

    def __init__(self, region):
        self.region = region

    def replay(self):
        self.region()

    def pool(self):
        return None

    def reset(self):
        pass


@pytest.fixture
def stood_in(monkeypatch):
    """graphs.run takes the card's path for CPU tensors: the warm-up a
    direct call, each capture and replay a direct call of the region."""
    def record(region, pool, mode):
        region()
        return _Stand(region)

    monkeypatch.setattr(graphs, "runs_eagerly",
                        lambda device, group=None: not graphs.graphs_enabled())
    monkeypatch.setattr(graphs, "_warm_up", lambda call, device: call())
    monkeypatch.setattr(graphs, "_record", record)
    graphs.clear()
    yield
    graphs.clear()


def test_graph_run_spans_seconds_and_counts(stood_in, recorded_spans,
                                            monkeypatch):
    data, cam = _office()

    def frame():
        recorded_spans.clear()
        R.render_aa(data, cam, budget_frac=0.05)
        return list(recorded_spans)

    before = dict(graphs.SECONDS)
    names = frame()
    assert {"mrt.graphs.warm_up render", "mrt.graphs.warm_up aa_refine"
            } <= set(names)
    assert graphs.SECONDS["warm_up"] > before["warm_up"]
    names = frame()
    assert {"mrt.graphs.capture render", "mrt.graphs.capture aa_refine"
            } <= set(names)
    assert graphs.SECONDS["capture"] > before["capture"]
    seconds = dict(graphs.SECONDS)
    names = frame()
    assert names[:2] == ["mrt.render_aa", "mrt.render"]
    for entry in ("render", "aa_refine"):
        for what in ("key", "stage", "launch", "clone"):
            assert f"mrt.graphs.{what} {entry}" in names, (what, entry)
        assert names.count(f"mrt.graphs.launch {entry}") == 1
    assert not [n for n in names if "warm_up" in n or "capture" in n]
    assert graphs.SECONDS == seconds            # a replay adds no set-up
    # a new key beyond MAX_GRAPHS evicts the oldest, in a span
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    evicted = graphs.COUNTS["evictions"]
    recorded_spans.clear()
    R.render(data, cam, tr.TraceConfig(tri_method="bvh"))
    assert graphs.COUNTS["evictions"] == evicted + 1
    assert "mrt.graphs.evict render" in recorded_spans


def test_graph_nodes_count_bodies_and_backward():
    pred = torch.tensor(True)
    fwd = graphs._Graph(None, {}, [graphs._Body(pred, {}, "a", 7),
                                   graphs._Body(pred, {}, "b", 5)],
                        nodes=30, label="render")
    bwd = graphs._Graph(None, {}, [], nodes=11, label="render (backward)")
    entry = graphs._Entry(torch.device("cpu"), (), (), forward=fwd,
                          backward=bwd, name="render")
    graphs.clear()
    graphs._CACHE[("render",)] = entry
    try:
        assert graphs.nodes("render") == 42
        assert graphs.nodes("render (backward)") == 11
        assert graphs.nodes("aa_refine") == 0
    finally:
        graphs._CACHE.clear()


# --- marks -----------------------------------------------------------------

@pytest.mark.parametrize("phase", profiling.PHASES)
def test_mark_on_cpu_launches_nothing(monkeypatch, phase):
    monkeypatch.setattr(_build, "library", _raising)
    before = dict(_build.LAUNCHES)
    profiling.mark(phase, torch.device("cpu"))
    assert _build.LAUNCHES == before
    with pytest.raises(KeyError):
        profiling.mark(phase + ".x", torch.device("cpu"))


def _mark_calls():
    """(file, line, first argument) of every ``mark(...)`` call in the
    package."""
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id",
                                getattr(node.func, "attr", None)) == "mark"):
                arg = node.args[0] if node.args else None
                yield (path.name, node.lineno,
                       arg.value if isinstance(arg, ast.Constant) else arg)


def test_phase_table_is_unique_and_every_call_site_names_a_phase():
    assert len(set(profiling.PHASES)) == len(profiling.PHASES)
    assert set(profiling.TRACE_PHASES) <= set(profiling.PHASES)
    calls = list(_mark_calls())
    assert len(calls) >= 15
    for where in calls:
        assert where[2] in profiling.PHASES, where
    # every phase is marked somewhere (``end`` by graphs._record)
    assert {c[2] for c in calls} == set(profiling.PHASES)
    # csrc/mark.cu holds one kernel per phase
    src = (PKG / "csrc" / "mark.cu").read_text()
    n = int(re.search(r"#define MRT_N_PHASES (\d+)", src).group(1))
    assert n == len(profiling.PHASES)


#: the phase table before ``tri.bounce``: a trace's marks are read by
#: their index, so each of these keeps it
EARLIER_PHASES = ("rays", "segment", "analytic", "tri", "shade", "aa.select",
                  "aa.apply", "refit", "topology", "replay", "backward",
                  "fit.topology", "fit.replay", "fit.backward", "fit.adam",
                  "end")


def test_phase_table_keeps_every_earlier_index():
    n = len(EARLIER_PHASES)
    assert profiling.PHASES[:n] == EARLIER_PHASES
    assert profiling.PHASES[n:] == ("tri.bounce", "shade.autograd")
    assert {"tri.bounce", "shade.autograd"} <= set(profiling.TRACE_PHASES)


@pytest.mark.parametrize("name, phase", [
    ("void mrt_mark<3>()", "tri"), ("mrt_mark<15>", "end"),
    ("void mrt_mark<16>()", "tri.bounce"),
    ("void mrt_mark<17>()", "shade.autograd"),
    ("void mrt_mark<(int)0>()", "rays"),
    ("void (anonymous namespace)::bvh_walk_kernel<false>(float const*)",
     None), ("mrt.graphs.launch render", None)])
def test_phase_of_reads_a_marks_kernel_name(name, phase):
    assert profiling.phase_of(name) == phase


def test_no_mark_while_a_backward_runs(monkeypatch):
    """A CUDA-typed device reaches the launch in a forward, but not from
    a custom Function's backward or a checkpoint's recompute."""
    launched = []
    monkeypatch.setattr(profiling, "_launch_mark",
                        lambda index, device: launched.append(
                            profiling.PHASES[index]))
    card = types.SimpleNamespace(type="cuda")

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            profiling.mark("replay", card)
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            profiling.mark("backward", card)
            return 2 * g

    def body(x):
        profiling.mark("shade", card)
        return x.sin()

    x = torch.ones(3, requires_grad=True)
    y = torch.utils.checkpoint.checkpoint(body, Twice.apply(x),
                                          use_reentrant=False)
    assert launched == ["replay", "shade"]
    y.sum().backward()
    assert launched == ["replay", "shade"]


@contextlib.contextmanager
def _recorded(monkeypatch):
    """Every mark the call sites make, as a list of phases, under mark()'s
    own rule: none while a backward runs."""
    seq = []

    def record(phase, device):
        profiling._PHASE_INDEX[phase]
        if torch._C._current_autograd_node() is None:
            seq.append(phase)

    for mod in (R, tr, I):
        monkeypatch.setattr(mod, "mark", record)
    yield seq


SEGMENT_TRI = ["segment", "tri", "shade", "tri", "shade"]
SEGMENT_ANA = ["segment", "analytic", "shade", "analytic", "shade"]
#: a later segment of a triangle scene: its closest and shadow queries
SEGMENT_BOUNCE = ["segment", "tri.bounce", "shade", "tri.bounce", "shade"]


@pytest.mark.parametrize("scene", ["office", "molecule"])
def test_marks_of_a_frame(monkeypatch, scene):
    data, cam = {"office": _office, "molecule": _molecule}[scene]()
    seg = SEGMENT_TRI if scene == "office" else SEGMENT_ANA
    trace = seg * data.n_segments
    with _recorded(monkeypatch) as seq:
        R.render_aa(data, cam, tr.TraceConfig(tri_method="auto"),
                    budget_frac=0.05)
    assert seq == ["rays"] + trace + ["aa.select"] + trace + ["aa.apply"]
    if scene == "office":
        # two graphs add one ``end`` each: 15 marks a frame, 16 at most
        assert len(seq) + 2 <= 16
    else:
        assert data.n_segments == 3 and "tri" not in seq


@pytest.mark.parametrize("scene", ["office", "molecule"])
def test_marks_of_a_fit_step(monkeypatch, scene):
    data, cam = {"office": _office, "molecule": _molecule}[scene]()
    fit = _fit(data, cam)
    with _recorded(monkeypatch) as seq:
        fit()
    seg = SEGMENT_TRI if scene == "office" else SEGMENT_ANA
    replay = ["segment", "shade"] * data.n_segments
    assert seq == (["fit.topology"] + seg * data.n_segments
                   + ["fit.replay"] + replay + ["fit.backward", "fit.adam"])
    if scene == "office":
        assert len(seq) + 1 <= 12           # with the graph's ``end``


@pytest.mark.parametrize("entry", ["render_aa", "trace_topology"])
def test_marks_of_mirror_segments(monkeypatch, entry):
    """On the rings (4 segments, triangles only), segment 0's closest and
    shadow queries mark ``tri`` and every later segment's ``tri.bounce``,
    in a frame's two passes and in the topology pass alike."""
    data, cam = _rings()
    trace = SEGMENT_TRI + SEGMENT_BOUNCE * (data.n_segments - 1)
    with _recorded(monkeypatch) as seq:
        if entry == "render_aa":
            R.render_aa(data, cam, tr.TraceConfig(tri_method="auto"),
                        budget_frac=0.05)
        else:
            o, d = cam.primary_rays(*cam.pixel_grid(torch.device("cpu")))
            tr.trace_topology(data, o.reshape(-1, 3), d.reshape(-1, 3),
                              tr.TraceConfig(tri_method="auto"))
    assert data.n_segments == 4 and data.n_spheres == data.n_planes == 0
    if entry == "render_aa":
        assert seq == ["rays"] + trace + ["aa.select"] + trace + ["aa.apply"]
    else:
        assert seq == trace


def test_marks_of_a_training_step(monkeypatch):
    data, cam = _office()
    tgt = torch.full((cam.height, cam.width, 3), 0.3)
    with _recorded(monkeypatch) as seq:
        R.render_loss_grad_image(data, cam, tgt)
    n = data.n_segments
    assert seq == (["rays", "refit", "topology"] + SEGMENT_TRI * n
                   + ["replay"] + ["segment", "shade"] * n + ["backward"])


def test_torch_profile_splits_stages_and_phases():
    """tools/torch_profile.py's table from a canned profile: each kernel
    to the last mark before it, the trace's phases inside their stage."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_profile

    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, a, b):
        return types.SimpleNamespace(
            name=name, device_type=cuda, is_user_annotation=False,
            time_range=types.SimpleNamespace(
                start=a, end=b, elapsed_us=lambda: b - a))

    events = [ev("k0", 0, 10), ev("void mrt_mark<7>()", 10, 11),
              ev("k1", 11, 31), ev("void mrt_mark<8>()", 31, 32),
              ev("void mrt_mark<1>()", 32, 33), ev("k2", 33, 73),
              ev("void mrt_mark<3>()", 73, 74), ev("k3", 74, 174),
              ev("void mrt_mark<15>()", 174, 175), ev("k4", 175, 180)]
    prof = types.SimpleNamespace(events=lambda: events)
    stages, phases = torch_profile.phase_split(prof, reps=2)
    assert stages == pytest.approx({"(none)": 7.5e-3, "refit": 10e-3,
                                    "topology": 70e-3})
    assert phases == pytest.approx({"(none)": 7.5e-3, "refit": 10e-3,
                                    "segment": 20e-3, "tri": 50e-3})
