"""The readers of the program's own tracing (rtbench/spans.py and the
metrics that read spans, marks and graph counters), on synthetic traces
with known spans and marks; and on a program without them (an older
one), where each reads nothing and none raises."""

import pytest

from conftest import run_small
from rtbench import harness
from rtbench import spans as sp
from rtbench import trace as tr

from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.utils import profiling

NEW = ["graphs.key_ms.frames", "graphs.launch_ms.frames",
       "graphs.nodes.frames", "tracer.analytic_ms.frames",
       "graphs.launch_ms.fit", "graphs.nodes.fit", "fit.backward_ms.fit",
       "graphs.capture_s"]


def _read(metric, trace):
    reader = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    return reader.read(None, {}, trace, {})


def _mark(phase, t):
    return (f"void mrt_mark<{profiling.PHASES.index(phase)}>()", t, t + 1.0)


def _frames():
    """Two frames of render_aa: spans (us) and marks with known sums."""
    host = [(tr.WINDOW, 0.0, 1000.0),
            ("mrt.render_aa", 0.0, 400.0), ("mrt.render_aa", 500.0, 900.0),
            ("mrt.graphs.key render", 10.0, 20.0),
            ("mrt.graphs.key aa_refine", 200.0, 230.0),
            ("mrt.graphs.key render", 510.0, 530.0),
            ("mrt.graphs.launch render", 30.0, 60.0),
            ("mrt.graphs.launch aa_refine", 240.0, 250.0),
            ("mrt.graphs.launch render", 540.0, 560.0),
            ("mrt.graphs.launch aa_refine", 700.0, 710.0),
            # neither a key span nor inside the window
            ("mrt.graphs.keyed", 0.0, 50.0),
            ("mrt.graphs.key render", 1200.0, 1300.0)]
    dev = [("copy", 50.0, 60.0),                       # before any mark
           _mark("rays", 100.0), ("k", 101.0, 120.0),
           _mark("segment", 120.0), ("k", 121.0, 150.0),
           _mark("analytic", 150.0), ("k", 151.0, 300.0),
           _mark("shade", 300.0), ("k", 301.0, 320.0),
           _mark("end", 320.0), ("clone", 330.0, 340.0),
           _mark("analytic", 600.0), ("k", 601.0, 640.0),
           ("k2", 630.0, 660.0),                        # over the end
           _mark("end", 650.0)]
    return tr.make(dev, host)


def _steps():
    host = [(tr.WINDOW, 0.0, 1000.0),
            ("mrt.fit.step", 0.0, 300.0), ("mrt.fit.step", 400.0, 700.0),
            ("mrt.fit.loss_read", 300.0, 350.0),
            ("mrt.graphs.launch fit_step", 100.0, 150.0),
            ("mrt.graphs.launch fit_step", 500.0, 530.0)]
    dev = [_mark("fit.topology", 10.0), ("k", 11.0, 50.0),
           _mark("fit.backward", 50.0), ("bwd", 51.0, 200.0),
           _mark("fit.adam", 200.0), ("adam", 201.0, 210.0),
           _mark("end", 210.0),
           _mark("fit.backward", 450.0), ("bwd", 451.0, 500.0),
           _mark("end", 500.0)]
    return tr.make(dev, host)


@pytest.fixture
def counters(monkeypatch):
    """The program's node counts and set-up seconds, known."""
    monkeypatch.setattr(graphs, "nodes", {"render": 100, "aa_refine": 40,
                                          "fit_step": 900}.__getitem__)
    monkeypatch.setattr(graphs, "SECONDS", {"warm_up": 1.5, "capture": 2.0})


def test_rtbench_span_readers_per_frame_and_step(counters):
    t = _frames()
    assert _read("graphs.key_ms.frames", t) == pytest.approx(
        (10 + 30 + 20) * 1e-3 / 2)
    assert _read("graphs.launch_ms.frames", t) == pytest.approx(
        (30 + 10 + 20 + 10) * 1e-3 / 2)
    assert _read("graphs.nodes.frames", t) == pytest.approx(
        (2 * 100 + 2 * 40) / 2)
    s = _steps()
    assert _read("graphs.launch_ms.fit", s) == pytest.approx(
        (50 + 30) * 1e-3 / 2)
    assert _read("graphs.nodes.fit", s) == pytest.approx(900.0)
    assert _read("graphs.capture_s", s) == pytest.approx(3.5)


def test_rtbench_phase_readers_take_the_union_to_the_next_mark():
    t = _frames()
    busy = sp.phase_busy_s(t)
    assert busy["rays"] == pytest.approx(19e-6)
    assert busy["segment"] == pytest.approx(29e-6)
    # frame 1: 151..300; frame 2: k and k2 together 601..650
    assert busy["analytic"] == pytest.approx((149 + 49) * 1e-6)
    assert busy["shade"] == pytest.approx(19e-6)
    # before the first mark, after each end: 50..60, 330..340, 650..660
    assert busy[None] == pytest.approx(30e-6)
    assert sum(busy.values()) == pytest.approx(
        tr.busy_s(t) - sp.mark_busy_s(t))
    # seven marks, the last under k2
    assert sp.mark_busy_s(t) == pytest.approx(6e-6)
    assert _read("tracer.analytic_ms.frames", t) == pytest.approx(
        (149 + 49) * 1e-3 / 2)
    assert _read("fit.backward_ms.fit", _steps()) == pytest.approx(
        (149 + 49) * 1e-3 / 2)


def test_rtbench_phase_readers_read_zero_where_the_phase_is_bypassed():
    t = _frames()
    dev = [d for d in t.device if "mrt_mark<2>" not in d[0]]
    bypass = t._replace(device=dev)
    assert _read("tracer.analytic_ms.frames", bypass) == 0.0


def test_rtbench_readers_read_nothing_of_a_program_without_them(monkeypatch):
    """An older program: no spans and no marks in the trace, and no phase
    table, node count or set-up tally in the program."""
    bare = tr.make([("k", 10.0, 20.0)],
                   [(tr.WINDOW, 0.0, 100.0), ("rtbench.render_aa", 0.0, 90.0),
                    ("rtbench.fit_pixels", 0.0, 90.0)])
    for m in NEW[:-1]:
        assert _read(m, bare) is None, m
    frames, steps = _frames(), _steps()
    monkeypatch.delattr(graphs, "nodes")
    monkeypatch.delattr(graphs, "SECONDS")
    monkeypatch.delattr(profiling, "PHASES")
    for m in NEW:
        if "key_ms" in m or "launch_ms" in m:
            continue                # spans alone, which this trace has
        assert _read(m, frames if "frames" in m else steps) is None, m


def test_rtbench_traced_line_reads_the_programs_spans_on_the_cpu():
    """A traced run on the CPU (every graph runs eagerly there): the
    entry point's spans are read; no graph was launched or captured."""
    line = run_small("office-1080p.aa-orbit", trace=True)
    m = line["metrics"]
    assert m["graphs.key_ms.frames"]["value"] > 0
    assert m["graphs.launch_ms.frames"]["value"] == 0.0
    assert m["graphs.capture_s"]["value"] == 0.0
    assert "graphs.nodes.frames" not in m
    assert "tracer.analytic_ms.frames" not in m
    assert line["correct"] is True
