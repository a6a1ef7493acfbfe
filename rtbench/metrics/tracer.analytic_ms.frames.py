"""``tracer.analytic_ms.frames``: device milliseconds per traced frame in
the program's ``analytic`` phase (the dense sphere, plane and cylinder
tests, closest and occlusion): the union of the device's operations
from each ``analytic`` mark to the next mark (rtbench/spans.py), over
the ``mrt.render_aa`` spans. 0 on a scene with no analytic primitive;
nothing where the program marks no phases."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.phase_ms_per_call(trace, "analytic", sp.FRAME)
