"""``tracer.live_share.fit``: the share, in %, of the rays that the fit
step's segment bodies ran over that were still alive on entering the
segment: the program's segment counters, the live rays of every segment
(``ops.tracer.live_rays``) over the rays of every body that ran
(``ops.tracer.rays_run``), of its entry point ``fit_step``, over the
run's steps (set-up's among them). Nothing where the program keeps no
such counters."""

from rtbench import spans as sp

ENTRY = "fit_step"


def read(run, state, trace, spans):
    live = sp.program_attr("ops.tracer", "live_rays")
    rays = sp.program_attr("ops.tracer", "rays_run")
    if live is None or rays is None:
        return None
    total = rays(ENTRY)
    if not total:
        return None
    return 100.0 * live(ENTRY) / total
