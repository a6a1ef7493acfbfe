"""``graphs.key_ms.frames``: the host's milliseconds per traced frame in
the program's ``mrt.graphs.key`` spans (the graphs' keys: the scene's
static fields and held tensors, ``make_key``, the cache lookup) of both
of ``render_aa``'s graphs; frames are its ``mrt.render_aa`` spans.
Nothing where the program has no such spans."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.span_ms_per_call(trace, "mrt.graphs.key", sp.FRAME)
