"""``graphs.enqueue_ms.frames``: the host's milliseconds in ``render_aa``,
from its call to its return, before the frame's synchronise: the mean
over the traced frames (rtbench/traffic/aa_orbit.py ``traced``). With
both graphs replayed, this is the host's share of a frame: the key, the
staged camera and pass-1 image, the launches and the output clones."""


def read(run, state, trace, spans):
    return spans.get("enqueue_ms")
