"""Training steps of one model completed in the window, over the window's
seconds: stack size x whole steps / window, the window's evals inside it
(host clock, the device synchronised at both ends)."""


def read(ctx):
    return ctx.n_models * ctx.window.steps / ctx.window.seconds
