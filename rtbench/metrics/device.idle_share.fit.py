"""``device.idle_share.fit``: percent of the traced stretch of fit steps in
which no operation ran on the device (rtbench/trace.py ``idle_share``)."""

from rtbench import trace as tr


def read(run, state, trace, spans):
    return tr.idle_share(trace)
