"""``graphs.nodes.frames``: graph nodes launched per traced frame: for each
``mrt.graphs.launch <entry>`` span, the nodes of that entry point's
captured graph (the program's ``ops.graphs.nodes``: kernels, copies and
IF nodes, with every IF node's body), summed, over the ``mrt.render_aa``
spans. Nothing where the program counts no nodes."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    return sp.nodes_per_call(trace, sp.FRAME)
