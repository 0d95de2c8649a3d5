"""Faults planted in the program, to show that the comparison catches
them: the training step's kinds of fault that a one-chip cell can have.

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: half of each model's cells or candidates left out of the
  loss, whose mean runs over the rest;
- ``altered``: an answer altered where it is produced: the first tenth of
  the first model's logits raised by 1 where the decoder hands them to the
  loss and the metrics.

A cell on one chip has no exchange between chips to leave out.  Each fault
is a patch of the program's module attributes inside a ``with`` block; the
benchmark's own runs plant none.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


def _half(targets):
    def wrapped(pred, *args, **kwargs):
        pred, labels, weight = targets(pred, *args, **kwargs)
        weight = weight.clone()
        weight[..., weight.shape[-1] // 2:] = 0.0
        return pred, labels, weight
    return wrapped


def _altered(targets):
    def wrapped(pred, *args, **kwargs):
        pred, labels, weight = targets(pred, *args, **kwargs)
        delta = pred.new_zeros(pred.shape)
        first = delta.reshape(-1, pred.shape[-1])[0]
        first[: pred.shape[-1] // 10] = 1.0
        return pred + delta, labels, weight
    return wrapped


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` planted."""
    import torch

    from dream_gnn_tpu_torch.train import stacked, step
    from dream_gnn_tpu_torch.train.optim import StackedAdam

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    saved = [(stacked, "decoder_targets", stacked.decoder_targets),
             (step, "decoder_targets", step.decoder_targets),
             (StackedAdam, "step", StackedAdam.step),
             (torch.optim.Adam, "step", torch.optim.Adam.step)]
    try:
        if name == "unchanged":
            StackedAdam.step = lambda self, grads: None
            torch.optim.Adam.step = lambda self, closure=None: None
        else:
            wrap = _half if name == "half_batch" else _altered
            for module in (stacked, step):
                module.decoder_targets = wrap(module.decoder_targets)
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
