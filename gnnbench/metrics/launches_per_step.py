"""Kernel launches on the device in the traced sub-window, over its
steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.trace.steps
