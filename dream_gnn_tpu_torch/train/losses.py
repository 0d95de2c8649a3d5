"""Loss functions (reference train.py:15-23,289-294 + utils.py:87-95)."""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    smoothing: float = 0.0, weight=None) -> torch.Tensor:
    """Mean BCE-with-logits; optional label smoothing (``t*(1-s) + s/2``,
    train.py:20-23).  With ``weight`` the mean runs over weight mass."""
    if smoothing > 0.0:
        targets = targets * (1.0 - smoothing) + smoothing * 0.5
    # Numerically stable: max(x,0) - x*t + log1p(exp(-|x|))
    loss = (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is None:
        return torch.mean(loss)
    return torch.sum(loss * weight) / torch.sum(weight)


def common_loss(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """Covariance-alignment loss between the two routes (utils.py:87-95):
    MSE between the N x N Gram matrices of centred, row-L2-normalised
    embeddings."""
    def _norm_cov(e):
        e = e - torch.mean(e, dim=0, keepdim=True)
        n = torch.linalg.norm(e, dim=1, keepdim=True)
        e = e / torch.clamp_min(n, 1e-12)   # F.normalize eps
        return e @ e.T

    return torch.mean((_norm_cov(emb1) - _norm_cov(emb2)) ** 2)


def total_loss(pred, labels, drug_out, drug_sim_out, dis_out, dis_sim_out, *,
               beta: float, smoothing: float = 0.0, weight=None):
    """BCE + beta * (common_drug + common_dis) (train.py:289-294).
    Returns (loss, bce)."""
    rel = bce_with_logits(pred, labels, smoothing, weight)
    if beta == 0.0:
        return rel, rel
    com = (common_loss(drug_out, drug_sim_out)
           + common_loss(dis_out, dis_sim_out))
    return rel + beta * com, rel
