"""Reading the program's own tracing out of a traced stretch.

The program names its host work with spans, ``torch.profiler`` ranges
called ``mrt.<name>`` or ``mrt.<name> <entry point>`` (its
``utils/profiling.span``), and splits the device time inside its CUDA
graphs with phase marks: empty kernels ``mrt_mark<P>`` whose ``P``
indexes the program's phase table (``utils/profiling.PHASES``). A phase
opens at its mark's start and lasts until the next mark's start (the
last until the window's end); the phase ``end`` closes a captured
region. A phase's device time is the union of the device operations'
intervals (marks left out) clipped to its stretches.

A program that has no spans, marks, phase table or graph counters (an
older one) gives nothing to read: every function here returns None
there, and none raises.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Tuple

from rtbench import trace as tr

#: a mark's kernel as the profile names it, e.g. "void mrt_mark<3>()"
MARK = re.compile(r"\bmrt_mark<[^0-9>]*([0-9]+)")

#: the spans that count the calls of each traffic kind
FRAME = "mrt.render_aa"
STEP = "mrt.fit.step"


def program_attr(module: str, name: str):
    """``name`` of the program's module ``module`` (e.g. "ops.graphs"),
    or None where the program has no such module or attribute."""
    import importlib

    try:
        mod = importlib.import_module(f"myraytracer_tpu_torch.{module}")
    except ImportError:
        return None
    return getattr(mod, name, None)


def host_spans(trace: tr.Trace, name: str) -> List[tr.Interval]:
    """The host spans called ``name`` or ``name <what>`` that start in
    the window, in order of start."""
    out = [h for h in trace.host
           if (h[0] == name or h[0].startswith(name + " "))
           and trace.w0 <= h[1] <= trace.w1]
    return sorted(out, key=lambda h: h[1])


def calls(trace: tr.Trace, name: str) -> int:
    return len(host_spans(trace, name))


def span_ms_per_call(trace: tr.Trace, name: str, per: str) -> Optional[float]:
    """Milliseconds of the spans ``name`` (``name <what>`` included) per
    span ``per``; None where the stretch holds no span ``per``."""
    n = calls(trace, per)
    if not n:
        return None
    return 1e3 * sum(b - a for _, a, b in host_spans(trace, name)) * 1e-6 / n


def nodes_per_call(trace: tr.Trace, per: str) -> Optional[float]:
    """The nodes of the graph each ``mrt.graphs.launch <entry>`` span
    replays (the program's ``ops.graphs.nodes(entry)``), summed, per
    span ``per``; None where the program counts no nodes or the stretch
    launches nothing."""
    nodes = program_attr("ops.graphs", "nodes")
    launches = host_spans(trace, "mrt.graphs.launch")
    n = calls(trace, per)
    if nodes is None or not launches or not n:
        return None
    head = len("mrt.graphs.launch ")
    return sum(nodes(name[head:]) for name, _, _ in launches) / n


def marks(trace: tr.Trace) -> Optional[List[Tuple[str, float]]]:
    """(phase, start us) of each mark in the window, in order; None
    where the program has no phase table or the stretch no mark."""
    table = program_attr("utils.profiling", "PHASES")
    if table is None:
        return None
    out = []
    for n, a, _ in trace.device:
        m = MARK.search(n)
        if m and int(m.group(1)) < len(table):
            out.append((table[int(m.group(1))], a))
    return sorted(out, key=lambda x: x[1]) or None


def _work(trace: tr.Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, marks left out."""
    return tr.merged(trace._replace(
        device=[d for d in trace.device if not MARK.search(d[0])]))


def phase_busy_s(trace: tr.Trace) -> Optional[Dict[str, float]]:
    """Device seconds in each phase (the work's union clipped to the
    phase's stretches), and under None the busy time in no phase (before
    the first mark, after an ``end``); None where there is no mark."""
    ms = marks(trace)
    if ms is None:
        return None
    bounds = [(None, trace.w0)] + ms + [(None, trace.w1)]
    stretches = [(p if p != "end" else None, a, b)
                 for (p, a), (_, b) in zip(bounds[:-1], bounds[1:])]
    out: Dict[Optional[str], float] = collections.defaultdict(float)
    work = _work(trace)
    i = 0
    for phase, a, b in stretches:
        while i < len(work) and work[i][1] <= a:
            i += 1
        j = i
        while j < len(work) and work[j][0] < b:
            out[phase] += (min(b, work[j][1]) - max(a, work[j][0])) * 1e-6
            j += 1
    return dict(out)


def phase_ms_per_call(trace: tr.Trace, phase: str,
                      per: str) -> Optional[float]:
    """Device milliseconds in the phase ``phase`` per span ``per``: 0
    where the program marks phases and none is ``phase``; None where it
    marks none or the stretch holds no span ``per``."""
    busy = phase_busy_s(trace)
    n = calls(trace, per)
    if busy is None or not n:
        return None
    return 1e3 * busy.get(phase, 0.0) / n


def mark_busy_s(trace: tr.Trace) -> float:
    """Device seconds that the marks' own kernels add to the busy time:
    the union with them less the union without them."""
    return tr.busy_s(trace) - sum(b - a for a, b in _work(trace)) * 1e-6
