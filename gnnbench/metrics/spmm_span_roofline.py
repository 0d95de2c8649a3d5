"""The segmented sums' share of their roofline, read from the program's
spans: the bytes of ``spmm_roofline`` (gnnbench/counts.py) times the traced
steps, at 3.35 TB/s, over the device-stream seconds of the span
``segment_sum``, which wraps every launch of the segment sum.  A span
holds at least its kernel, so this reads at most ``spmm_roofline``."""

from gnnbench import counts, spans


def read(ctx):
    nbytes = ctx.counts.get("segment_sum_bytes")
    seconds = spans.device_s(ctx, "segment_sum")
    if not nbytes or not seconds:
        return None
    return 100.0 * nbytes * ctx.trace.steps / counts.PEAK_BYTES / seconds
