"""``tracer.live_share.frames``: the share, in %, of the rays that the
segment bodies of ``render_aa``'s two passes ran over that were still
alive on entering the segment: the program's segment counters, the live
rays of every segment (``ops.tracer.live_rays``) over the rays of every
body that ran (``ops.tracer.rays_run``), of its graphs ``render`` and
``aa_refine``, over the run's calls (set-up's frames among them).
Nothing where the program keeps no such counters."""

from rtbench import spans as sp

#: the program's graphs that one frame of render_aa replays
ENTRIES = ("render", "aa_refine")


def read(run, state, trace, spans):
    live = sp.program_attr("ops.tracer", "live_rays")
    rays = sp.program_attr("ops.tracer", "rays_run")
    if live is None or rays is None:
        return None
    total = sum(rays(e) for e in ENTRIES)
    if not total:
        return None
    return 100.0 * sum(live(e) for e in ENTRIES) / total
