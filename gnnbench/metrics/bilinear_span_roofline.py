"""The bilinear decoder kernel's share of its roofline, read from the
program's spans: its least time (of the forward launch and of the
backward's passes, each its operations at the float32 peak or its bytes at
3.35 TB/s, whichever is larger, summed; counted from the shapes,
gnnbench/counts_gcmc.py) times the traced steps, over the device-stream
seconds of the spans ``bilinear`` (the forward launch) and
``bilinear_bwd`` (the backward's passes and node sums).  A cell without the
kernel, or a program without the spans, gives nothing."""

from gnnbench import spans


def read(ctx):
    least = ctx.counts.get("bilinear_least_s")
    seconds = spans.device_s(ctx, "bilinear", "bilinear_bwd")
    if not least or not seconds:
        return None
    return 100.0 * least * ctx.trace.steps / seconds
