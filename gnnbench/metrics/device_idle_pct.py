"""The share of a training step in which the device runs nothing: one
less the device's busy time a step in the traced sub-window (kernels,
copies and fills, whose durations the profiler does not stretch) over the
step's time in the unprofiled window, its evals left out.  The profiler
slows the host, so the traced sub-window's own idle share would measure
the profiler where the host paces the step."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.steps / ctx.step_s)
