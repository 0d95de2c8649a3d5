"""Optimizer + LR plateau schedule.

Reference: ``th.optim.Adam(lr, weight_decay)`` with
``clip_grad_norm_(1.0)`` before each step (train.py:217,297-300) and
``ReduceLROnPlateau('max', patience=500, factor=0.5)`` stepped on test
AUPR every eval (train.py:235,323).

The JAX package's optax chain is clip -> add_decayed_weights ->
scale_by_adam(eps 1e-8), with the learning rate applied outside
(dream_gnn_tpu/train/optim.py:20-28).  torch's Adam adds the L2 term to
the gradient before its moments, so ``torch.optim.Adam(weight_decay=…)``
after the clip is the same chain.  The clip is written as optax writes
it, ``g * max_norm / max(norm, max_norm)``: torch's ``clip_grad_norm_``
adds 1e-6 to the norm.

A stack of F folds (train/stacked.py) trains F independent models whose
leaves carry a leading fold axis.  Its clip takes one global norm per
fold, and ``StackedAdam`` follows the optax chain of the JAX stacked step
(stacked.py:97-104): clip -> add_decayed_weights -> scale_by_adam, then
``p - lr[f] * u`` with a learning rate per fold.  ``torch.optim.Adam``
takes one learning rate per param group, so it cannot do this.
"""

from __future__ import annotations

from typing import List

import torch


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """Scale ``grads`` in place so their global L2 norm is <= max_norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.clamp_min(norm, max_norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _per_fold(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(F,) ``x`` shaped to broadcast over a (F, ...) leaf ``like``."""
    return x.reshape(-1, *([1] * (like.dim() - 1)))


def global_norm_per_fold(grads: List[torch.Tensor]) -> torch.Tensor:
    """(F,) global L2 norms of (F, ...) leaves, each over one fold's slice
    of every leaf: a fold's norm never sees another fold's gradients."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.flatten(1), dim=1) for g in grads]),
        dim=0)


def clip_by_global_norm_per_fold_(grads: List[torch.Tensor],
                                  max_norm: float) -> torch.Tensor:
    """Scale each fold's slice of the (F, ...) ``grads`` in place so that
    its global norm is <= max_norm; returns the (F,) norms before the
    clip."""
    norm = global_norm_per_fold(grads)
    scale = max_norm / torch.clamp_min(norm, max_norm)
    for g in grads:
        g.mul_(_per_fold(scale, g))
    return norm


class StackedAdam:
    """Adam over stacked (F, ...) leaves with an (F,) learning rate:
    optax ``add_decayed_weights`` then ``scale_by_adam(b1, b2, eps)``, and
    ``p - lr[f] * u`` (eps outside the square root, as optax and torch).
    The moments update with ``torch._foreach_*`` over all leaves at once."""

    def __init__(self, params: List[torch.Tensor], lr: torch.Tensor,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from ``grads`` (used as scratch: they are changed)."""
        if self.weight_decay > 0:
            torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        for p, u in zip(self.params, mu_hat):
            p.addcmul_(_per_fold(self.lr, p), u, value=-1.0)


class PlateauScheduler:
    """torch ReduceLROnPlateau equivalent (mode='max', threshold_mode
    ='rel', threshold=1e-4, cooldown=0, min_lr=0)."""

    def __init__(self, lr: float, patience: int = 500, factor: float = 0.5,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("-inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        # torch is_better (mode='max', threshold_mode='rel'):
        # a > best * (1 + threshold); AUPR metrics are non-negative.
        if metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
