"""Device-stream milliseconds a step of the program's span ``optimizer``
(the gradients gathered, any broadcast between ranks, the clip and the Adam
step) in the traced sub-window: its CUDA events' seconds over the traced
steps (gnnbench/spans.py)."""

from gnnbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "optimizer")
