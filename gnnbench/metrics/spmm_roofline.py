"""The segmented sums' share of their roofline in the traced sub-window:
the bytes of the encoder's sparse aggregations (forward and transposed
backward) and of the decoder's table-gradient scatters, each input read
once and the float32 output written once (gnnbench/counts.py), at 3.35
TB/s, over the device time of ``segment_sum_kernel``."""

from gnnbench import counts

PATTERN = r"\bsegment_sum_kernel"


def read(ctx):
    t, nbytes = ctx.trace, ctx.counts.get("segment_sum_bytes")
    if t is None or not nbytes:
        return None
    seconds = t.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    return 100.0 * nbytes * t.steps / counts.PEAK_BYTES / seconds
