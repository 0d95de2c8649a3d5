"""The whole training step's share of the card's peak: the least time of
the step's model operations, each dtype at its own peak (float32 at 67
TFLOP/s, TF32 being off; bf16 at 989), over the step's time in the
unprofiled window, its evals left out.  The operations are counted from
the configuration's shapes (gnnbench/counts.py)."""

from gnnbench import counts


def read(ctx):
    least = counts.least_seconds(ctx.counts["step_ops"])
    return 100.0 * least / ctx.step_s
