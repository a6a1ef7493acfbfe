"""``fit.backward_ms.fit``: device milliseconds per traced fit step in the
program's ``fit.backward`` phase (the whole backward of the step, its
recomputed and conditional segments among it, up to ``fit.adam``), over
the ``mrt.fit.step`` spans. Nothing where the program marks no phases."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.phase_ms_per_call(trace, "fit.backward", sp.STEP)
