"""``tracer.tri_bounce_ms.frames``: device milliseconds per traced frame
in the program's ``tri.bounce`` phase (the triangle queries, closest hit
and shadows, of every segment after the first: the reflected rays'
walks): the union of the device's operations from each ``tri.bounce``
mark to the next mark (rtbench/spans.py), over the ``mrt.render_aa``
spans. 0 where no segment bounced; nothing where the program marks no
phases or has no such phase."""

from rtbench import spans as sp

PHASE = "tri.bounce"


def read(run, state, trace, spans):
    table = sp.program_attr("utils.profiling", "PHASES")
    if table is None or PHASE not in table:
        return None
    return sp.phase_ms_per_call(trace, PHASE, sp.FRAME)
