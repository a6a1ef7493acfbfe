"""``tracer.segments_run.frames``: the Whitted segment bodies run per
frame, over both of ``render_aa``'s passes: the program's segment
counters (``ops.tracer.segments_run`` of its graphs ``render`` and
``aa_refine``: segment 0 of each pass, and each later segment whose IF
node's body ran) over its ``render_aa`` calls (``ops.render.CALLS``).
The counters hold every call of the run, set-up's frames among them; a
frame's count depends only on its pose. Nothing where the program keeps
no such counters."""

from rtbench import spans as sp

#: the program's graphs that one frame of render_aa replays
ENTRIES = ("render", "aa_refine")


def read(run, state, trace, spans):
    ran = sp.program_attr("ops.tracer", "segments_run")
    calls = sp.program_attr("ops.render", "CALLS")
    if ran is None or not calls or not calls.get("render_aa"):
        return None
    return sum(ran(e) for e in ENTRIES) / calls["render_aa"]
