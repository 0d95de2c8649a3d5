"""Activation registry (reference utils.py:47-80), as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTS = {
    "leaky": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    # jax.nn.gelu defaults to the tanh approximation; torch's does not.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "selu": F.selu,
    "none": lambda x: x,
}


def get_activation(act):
    """Return the activation callable for ``act``: a registry name,
    ``None`` (identity) or a callable (passed through)."""
    if act is None:
        return _ACTS["none"]
    if callable(act):
        return act
    try:
        return _ACTS[act]
    except KeyError:
        raise NotImplementedError(f"unknown activation {act!r}")
