"""The decoder's share of its roofline, read from the program's spans: the
least time of the decoder MLP's forward and backward over the cell's cells
(as ``decoder_roofline``, gnnbench/counts.py) times the traced steps, over
the device-stream seconds of the spans ``decoder`` (node projections and
the fused forward) and ``decoder_bwd`` (the fused backward).  A span holds
at least its kernels, so this reads at most ``decoder_roofline``, whatever
the kernels are named."""

from gnnbench import spans


def read(ctx):
    least = ctx.counts.get("decoder_least_s")
    seconds = spans.device_s(ctx, "decoder", "decoder_bwd")
    if not least or not seconds:
        return None
    return 100.0 * least * ctx.trace.steps / seconds
