"""``graphs.launch_ms.fit``: the host's milliseconds per traced fit step in
the program's ``mrt.graphs.launch`` spans (the fit step graph's
``CUDAGraph.replay``); steps are its ``mrt.fit.step`` spans. Nothing
where the program has no such spans."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.span_ms_per_call(trace, "mrt.graphs.launch", sp.STEP)
