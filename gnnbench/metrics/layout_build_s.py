"""Seconds of the program's builders of the data and its layouts: the
dataset, its kNN graphs and folds and the fold stacks, or the scale path's
encoder graph and decoder layouts (host clock, the device synchronised)."""


def read(ctx):
    return ctx.layout_build_s
