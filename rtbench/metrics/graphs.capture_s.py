"""``graphs.capture_s``: the host's seconds of the program's graph set-up,
every key's eager warm-up and every capture, each to a synchronise (the
program's ``ops.graphs.SECONDS``, summed), read after the traced
stretch, which neither warms up nor captures. Nothing where the program
keeps no such tally."""

from rtbench import spans as sp


def read(run, state, trace, spans):
    seconds = sp.program_attr("ops.graphs", "SECONDS")
    return None if seconds is None else float(sum(seconds.values()))
