"""Reading a traced stretch: the device's intervals, its busy and idle
time, and the breakdown that the result line carries.

A stretch is traced by ``torch.profiler`` (CPU and CUDA activities)
around the harness's calls, each call inside a ``record_function``
named ``rtbench.<what>`` and the whole inside ``rtbench.window``. The
device's operations are the profile's events on the CUDA device
(kernels, copies, sets); its busy time is the union of their intervals
inside the window, and an idle gap is a stretch of the window that no
device operation covers.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

Interval = Tuple[str, float, float]      # name, start us, end us

WINDOW = "rtbench.window"


class Trace(NamedTuple):
    """A traced stretch: device and host events, the window (us)."""

    device: List[Interval]
    host: List[Interval]
    w0: float
    w1: float

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6


def from_profile(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != cuda:
            host.append(iv)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("rtbench.")):
            # the device's copy of a record_function span is no operation
            dev.append(iv)
    return make(dev, host)


def make(device: List[Interval], host: List[Interval]) -> Trace:
    """A :class:`Trace` from its events: the window is the host span
    ``rtbench.window``, stretched to the end of the last device event
    that starts inside it."""
    spans = [h for h in host if h[0] == WINDOW]
    if not spans:
        raise ValueError(f"no {WINDOW} span in the trace")
    w0, w1 = spans[0][1], spans[0][2]
    inside = [d for d in device if w0 <= d[1] <= w1]
    if inside:
        w1 = max(w1, max(d[2] for d in inside))
    return Trace(sorted(inside, key=lambda d: d[1]), host, w0, w1)


def merged(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for _, a, b in trace.device:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    return sum(b - a for a, b in merged(trace)) * 1e-6


def idle_share(trace: Trace) -> Optional[float]:
    """Percent of the window in which no device operation ran; None
    where the device ran nothing."""
    if not trace.device or trace.w1 <= trace.w0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def device_time(trace: Trace, names) -> float:
    """Seconds of the device events whose name contains one of ``names``."""
    return sum(b - a for n, a, b in trace.device
               if any(k in n for k in names)) * 1e-6


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches that no device operation covers."""
    out, t = [], trace.w0
    for a, b in merged(trace):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.w1 > t:
        out.append((t, trace.w1))
    return out


def _host_at(host: List[Interval], starts: List[float], t: float) -> str:
    """The innermost (latest started) of the host events ``host``, sorted
    by start, that covers time ``t``."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if host[i][2] >= t:
            return host[i][0]
    return "(no host event)"


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the idle gaps
    summed by the innermost host event at each gap's middle, each the
    ``top`` largest, in seconds."""
    ops: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in trace.device:
        ops[n] += (b - a) * 1e-6
    idle: Dict[str, float] = collections.defaultdict(float)
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    for a, b in gaps(trace):
        idle[_host_at(host, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    second = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in first],
            "idle_gaps": [[n[:160], v] for n, v in second]}
