"""``replay.autograd_ms.fit``: device milliseconds per traced fit step in
the program's ``shade.autograd`` phase (the autograd replay's forward:
``shade.resolve_hit``'s row gathers and the lighting of each segment
that the fit step replays on that route): the union of the device's
operations from each ``shade.autograd`` mark to the next mark
(rtbench/spans.py), over the ``mrt.fit.step`` spans. Its backward is in
``fit.backward``. 0 where every segment took a fused route; nothing
where the program marks no phases or has no such phase."""

from rtbench import spans as sp

PHASE = "shade.autograd"


def read(run, state, trace, spans):
    table = sp.program_attr("utils.profiling", "PHASES")
    if table is None or PHASE not in table:
        return None
    return sp.phase_ms_per_call(trace, PHASE, sp.STEP)
