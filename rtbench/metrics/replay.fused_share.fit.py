"""``replay.fused_share.fit``: the share, in %, of the training replay's
segments that the traced fit steps ran through a fused hand-written
segment (K5/K6 on triangles, K10/K11 on spheres and planes) rather than
the autograd replay. The program counts each segment by its route where
``trace_shade`` chooses it (host tallies ``replay.fused_tri``,
``replay.fused_ana``, ``replay.autograd``), and a captured graph keeps
the counts of its capture: for each ``mrt.graphs.launch <entry>`` span
of the stretch, ``ops.graphs.tallies(entry)``, summed. Nothing where the
program keeps no such tallies or the stretch replays no segment."""

from rtbench import spans as sp

#: the routes that count as fused, and every route
FUSED = ("replay.fused_tri", "replay.fused_ana")
ROUTES = FUSED + ("replay.autograd",)


def read(run, state, trace, spans):
    tallies = sp.program_attr("ops.graphs", "tallies")
    if tallies is None:
        return None
    head = len("mrt.graphs.launch ")
    counts = dict.fromkeys(ROUTES, 0)
    for name, _, _ in sp.host_spans(trace, "mrt.graphs.launch"):
        for k, n in tallies(name[head:]).items():
            if k in counts:
                counts[k] += n
    total = sum(counts.values())
    if not total:
        return None
    return 100.0 * sum(counts[k] for k in FUSED) / total
