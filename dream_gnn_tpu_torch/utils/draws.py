"""The random draws of a fold stack, whole or as a rank's block of it.

Every training draw of a fold stack is one call that makes the whole
(F, ...) tensor (train/stacked.py).  On a dp x mp mesh a rank holds a
block of the folds (sharding/partition.py).  Under ``fold_block`` each
draw is still made for the whole stack, from the generator that every rank
seeds alike, and the rank keeps its own folds of it, as
``RowBlock.dropout`` does for rows (sharding/collectives.py).  So the
ranks of a mesh draw bit for bit the masks, noise, permutations and seeds
of a one-rank run of the same stack.  Without a block in force a draw is
the plain call.

``fold_dim`` names the draw's fold axis where it is not the first (the
mix-up coefficients, (2, F)).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_BLOCK = contextvars.ContextVar("fold_block", default=None)


@contextlib.contextmanager
def fold_block(n_folds: int, lo: int, size: int):
    """Draws inside keep folds [lo, lo + size) of a stack of ``n_folds``."""
    token = _BLOCK.set((n_folds, lo, size))
    try:
        yield
    finally:
        _BLOCK.reset(token)


def _draw(fn, shape, fold_dim: int) -> torch.Tensor:
    block = _BLOCK.get()
    shape = tuple(shape)
    if block is None:
        return fn(shape)
    n_folds, lo, size = block
    if shape[fold_dim] != size:
        raise ValueError(f"a draw of shape {shape} inside a block of {size} "
                         f"folds: its axis {fold_dim} is not the fold axis")
    whole = shape[:fold_dim] + (n_folds,) + shape[fold_dim + 1:]
    return fn(whole).narrow(fold_dim, lo, size)


def rand(gen, shape, device, dtype=torch.float32,
         fold_dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``."""
    return _draw(lambda s: torch.rand(s, generator=gen, device=device,
                                      dtype=dtype), shape, fold_dim)


def randn(gen, shape, device, dtype=torch.float32,
          fold_dim: int = 0) -> torch.Tensor:
    """``torch.randn(shape)`` from ``gen``."""
    return _draw(lambda s: torch.randn(s, generator=gen, device=device,
                                       dtype=dtype), shape, fold_dim)


def randint(gen, high: int, shape, device, dtype=torch.int64,
            fold_dim: int = 0) -> torch.Tensor:
    """``torch.randint(0, high, shape)`` from ``gen``."""
    return _draw(lambda s: torch.randint(0, high, s, generator=gen,
                                         device=device, dtype=dtype),
                 shape, fold_dim)
