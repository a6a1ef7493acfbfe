"""``device.idle_share.frames``: percent of the traced stretch of frames in
which no operation ran on the device (rtbench/trace.py ``idle_share``)."""

from rtbench import trace as tr


def read(run, state, trace, spans):
    return tr.idle_share(trace)
