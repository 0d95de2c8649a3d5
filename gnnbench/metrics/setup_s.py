"""Seconds from the process's start to the first measured step: imports,
inputs, the program's builders, the kernels' build or load, and the
warm-up steps and evals (host clock, the device synchronised)."""


def read(ctx):
    return ctx.setup_s
