"""Calls a step in which the host waits for the device: the CUDA runtime's
stream, device and event synchronisations and blocking ``cudaMemcpy`` in
the traced sub-window that start inside one of the program's ``dream/step``
ranges, over the number of those ranges.  A run without the program's
spans, or without device time (the CPU), gives nothing."""

import bisect

from gnnbench import spans

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(ctx):
    if spans.device_s(ctx, "step") is None:
        return None
    host = ctx.trace.host
    steps = sorted((s, e) for s, e, name in host if name == "dream/step")
    if not steps:
        return None
    starts = [s for s, _ in steps]
    n = 0
    for s, _, name in host:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s <= steps[i][1]
    return n / len(steps)
