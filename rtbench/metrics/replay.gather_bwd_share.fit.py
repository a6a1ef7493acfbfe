"""``replay.gather_bwd_share.fit``: percent of the device's busy time in a
traced stretch of fit steps spent in PyTorch's ``indexing_backward_kernel``
family: the backward of the row gathers (``x[idx]``) of the shading
replay, which scatter each ray's cotangent back into a table's rows.
0 where the step launches none; nothing where the device ran nothing."""

from rtbench import trace as tr

#: the kernels read, by a part of their name
KERNELS = ("indexing_backward_kernel",)


def read(run, state, trace, spans):
    busy = tr.busy_s(trace)
    if busy <= 0:
        return None
    return 100.0 * tr.device_time(trace, KERNELS) / busy
