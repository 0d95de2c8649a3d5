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
