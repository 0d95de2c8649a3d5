"""Functional inverted dropout (torch ``nn.Dropout`` semantics)."""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.utils import draws


def dropout(gen, x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Zero elements with prob ``rate`` and scale survivors by 1/(1-rate),
    drawing the mask from ``gen``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = draws.rand(gen, x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
