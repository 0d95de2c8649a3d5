"""Device-stream milliseconds a step of the program's span ``forward``
(augmentation, the model's forward and the loss) in the traced
sub-window: its CUDA events' seconds over the traced steps
(gnnbench/spans.py)."""

from gnnbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "forward")
