"""Device-stream milliseconds a step of the program's span ``backward``
(the autograd backward of the loss) in the traced sub-window: its CUDA
events' seconds over the traced steps (gnnbench/spans.py)."""

from gnnbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "backward")
