"""The decoder MLP's share of its roofline in the traced sub-window: the
least time of its forward and backward over the cell's cells (operations
at the bf16 peak or bytes at 3.35 TB/s, whichever is larger; counted from
the shapes, gnnbench/counts.py) over the device time of the kernels whose
names match the driver's decoder pattern (the grid, per-edge or scale
decoder's forward, backward and scatter kernels)."""


def read(ctx):
    t, c = ctx.trace, ctx.counts
    if t is None or not c.get("decoder_kernels"):
        return None
    seconds = t.kernel_seconds(c["decoder_kernels"])
    if seconds <= 0:
        return None
    return 100.0 * c["decoder_least_s"] * t.steps / seconds
