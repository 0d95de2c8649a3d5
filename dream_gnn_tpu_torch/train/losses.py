"""Loss functions (reference train.py:15-23,289-294 + utils.py:87-95).

Every loss reduces over its trailing axes only, so inputs with a leading
fold axis give one loss per fold: each fold's BCE mean over its own
weight mass, each fold's own N x N Gram matrices.  Nothing is pooled
across folds.
"""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.sharding.collectives import sum_ranks


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    smoothing: float = 0.0, weight=None,
                    group=None) -> torch.Tensor:
    """Mean BCE-with-logits; optional label smoothing (``t*(1-s) + s/2``,
    train.py:20-23).  With ``weight`` the mean runs over weight mass; with
    a process ``group`` as well, over every rank's logits: the weighted sum
    and the weight mass are each this rank's sum, summed over the ranks
    (sharding/collectives.py ``sum_ranks``)."""
    if smoothing > 0.0:
        targets = targets * (1.0 - smoothing) + smoothing * 0.5
    # Numerically stable: max(x,0) - x*t + log1p(exp(-|x|))
    loss = (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if weight is None:
        return torch.mean(loss, dim=-1)
    num, den = torch.sum(loss * weight, dim=-1), torch.sum(weight, dim=-1)
    if group is not None:
        num, den = sum_ranks(num, group), sum_ranks(den, group)
    return num / den


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weight=None) -> torch.Tensor:
    """GCMC's loss (DGL's ``nn.CrossEntropyLoss``): the mean softmax
    cross-entropy of class-major ``logits`` (R, E) against the level index
    ``labels`` (E,) of each rating; with ``weight`` (E,) the mean runs over
    weight mass."""
    loss = torch.logsumexp(logits, dim=0) \
        - torch.gather(logits, 0, labels.long()[None])[0]
    if weight is None:
        return loss.mean()
    return torch.sum(loss * weight) / torch.sum(weight)


def common_loss(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """Covariance-alignment loss between the two routes (utils.py:87-95):
    MSE between the N x N Gram matrices of centred, row-L2-normalised
    embeddings."""
    def _norm_cov(e):
        e = e - torch.mean(e, dim=-2, keepdim=True)
        n = torch.linalg.norm(e, dim=-1, keepdim=True)
        e = e / torch.clamp_min(n, 1e-12)   # F.normalize eps
        return e @ e.mT

    return torch.mean((_norm_cov(emb1) - _norm_cov(emb2)) ** 2, dim=(-2, -1))


def total_loss(pred, labels, drug_out, drug_sim_out, dis_out, dis_sim_out, *,
               beta: float, smoothing: float = 0.0, weight=None, group=None):
    """BCE + beta * (common_drug + common_dis) (train.py:289-294).
    Returns (loss, bce).  ``group``: ``pred`` is this rank's share of the
    candidates of a process group (the candidate-sharded decoder)."""
    rel = bce_with_logits(pred, labels, smoothing, weight, group)
    if beta == 0.0:
        return rel, rel
    com = (common_loss(drug_out, drug_sim_out)
           + common_loss(dis_out, dis_sim_out))
    return rel + beta * com, rel
