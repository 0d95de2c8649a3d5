"""Functional inverted dropout (torch ``nn.Dropout`` semantics)."""

from __future__ import annotations

import torch


def dropout(gen, x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """Zero elements with prob ``rate`` and scale survivors by 1/(1-rate),
    drawing the mask from ``gen``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
