"""``graphs.nodes.fit``: graph nodes launched per traced fit step, as
``graphs.nodes.frames`` counts them, over the ``mrt.fit.step`` spans.
Nothing where the program counts no nodes."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.nodes_per_call(trace, sp.STEP)
