"""Milliseconds of one eval of the train side and the test side, the mean
over the window's evals (host clock, the device synchronised around each).
A window that holds no eval gives nothing."""


def read(ctx):
    evals = ctx.window.eval_s
    return 1e3 * sum(evals) / len(evals) if evals else None
