"""AUROC / AUPR on the device, sklearn-equivalent, and on the host.

Port of ``dream_gnn_tpu/utils/metrics.py``.  Parity trap (SURVEY.md
§7.3.9): AUPR is ``auc(recall, precision)`` — trapezoidal area over the
PR curve — not average precision.  Ties are grouped as sklearn groups
them; sorts are stable (``jnp.argsort`` is).  ``roc_aupr_host`` is the
reference's own host computation (evaluation.py:60-65) in numpy float64,
without sklearn.
"""

from __future__ import annotations

import numpy as np
import torch


def _average_ranks(scores: torch.Tensor) -> torch.Tensor:
    """1-based ranks of ``scores`` with ties assigned their average rank."""
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)  # ascending
    ss = scores[order]
    idx = torch.arange(n, device=scores.device)
    diff = ss[1:] != ss[:-1]
    one = torch.ones(1, dtype=torch.bool, device=scores.device)
    new_group = torch.cat([one, diff])
    last_of_group = torch.cat([diff, one])
    group_start = torch.cummax(torch.where(new_group, idx, -1), dim=0).values
    # Reverse cummin by flipping.
    group_end = torch.flip(torch.cummin(torch.flip(
        torch.where(last_of_group, idx, n), [0]), dim=0).values, [0])
    avg = (group_start + group_end).to(scores.dtype) / 2.0 + 1.0
    ranks = torch.empty_like(scores)
    ranks[order] = avg
    return ranks


def auroc(y_true: torch.Tensor, y_score: torch.Tensor) -> torch.Tensor:
    """ROC AUC via the tie-corrected Mann-Whitney statistic."""
    y = y_true.to(torch.float32)
    ranks = _average_ranks(y_score.to(torch.float32))
    n_pos = torch.sum(y)
    n_neg = y.shape[0] - n_pos
    rank_sum = torch.sum(ranks * y)
    return (rank_sum - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)


def aupr(y_true: torch.Tensor, y_score: torch.Tensor) -> torch.Tensor:
    """Trapezoidal area under the PR curve: one point per distinct
    threshold, truncated at the first full recall, closed with (0, 1)."""
    n = y_true.shape[0]
    y = y_true.to(torch.float32)
    s = y_score.to(torch.float32)
    dev = s.device

    order = torch.argsort(-s, stable=True)  # descending score
    ss = s[order]
    ys = y[order]
    idx = torch.arange(n, device=dev)

    tp = torch.cumsum(ys, dim=0)
    n_pos = tp[-1]
    precision = tp / (idx.to(torch.float32) + 1.0)
    recall = tp / n_pos

    one = torch.ones(1, dtype=torch.bool, device=dev)
    kept = torch.cat([ss[:-1] != ss[1:], one])
    full = kept & (tp >= n_pos)
    first_full = torch.min(torch.where(full, idx, n))
    valid = kept & (idx <= first_full)

    prev_idx = torch.cat([
        torch.full((1,), -1, dtype=idx.dtype, device=dev),
        torch.cummax(torch.where(valid, idx, -1), dim=0).values[:-1]])
    has_prev = prev_idx >= 0
    safe_prev = torch.clamp_min(prev_idx, 0)
    r_prev = torch.where(has_prev, recall[safe_prev], 0.0)
    p_prev = torch.where(has_prev, precision[safe_prev], 1.0)

    contrib = (recall - r_prev) * (precision + p_prev) / 2.0
    return torch.sum(torch.where(valid, contrib, 0.0))


def auroc_masked(y_true, y_score, valid):
    """AUROC over the subset where ``valid > 0``: invalid points take the
    lowest ranks (score -inf, label 0), whose offset is subtracted."""
    valid = valid > 0
    y = torch.where(valid, y_true, 0.0).to(torch.float32)
    s = torch.where(valid, y_score, -torch.inf).to(torch.float32)
    n_inv = torch.sum(~valid).to(torch.float32)
    ranks = _average_ranks(s)
    n_pos = torch.sum(y)
    n_neg = y.shape[0] - n_inv - n_pos
    rank_sum = torch.sum(ranks * y) - n_pos * n_inv
    return (rank_sum - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)


def aupr_masked(y_true, y_score, valid):
    """AUPR over the subset where ``valid > 0``: invalid points (score
    -inf, label 0) sort after every valid point."""
    valid = valid > 0
    return aupr(torch.where(valid, y_true, 0.0),
                torch.where(valid, y_score, -torch.inf))


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """sklearn's ``auc``: the trapezoidal area under (x, y), x monotone
    (its sign taken from the direction); nan where x or y holds nan."""
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1.0
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


def _binary_curve(y_true, y_score):
    """(fps, tps) at each distinct score, in decreasing score order, as
    float64: sklearn's ``confusion_matrix_at_thresholds`` with pos_label
    1 and no sample weights."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if y_true.shape != y_score.shape:
        raise ValueError(f"{y_true.size} labels for {y_score.size} scores")
    if not np.isfinite(y_score).all():
        raise ValueError("y_score holds a nan or an infinity")
    classes = set(np.unique(y_true).tolist())
    if not (classes <= {0, 1} or classes <= {-1, 1}):
        raise ValueError(f"labels {sorted(classes)}: binary 0/1 or -1/1 "
                         f"labels only")
    order = np.argsort(-y_score, kind="stable")
    s = y_score[order]
    last = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tps = np.cumsum((y_true[order] == 1).astype(np.float64))[last]
    fps = 1.0 + last.astype(np.float64) - tps
    return fps, tps


def roc_aupr_host(y_true, y_score):
    """(AUROC, AUPR) as the reference computes them on the host
    (evaluation.py:60-65): sklearn's ``auc`` over ``roc_curve`` (collinear
    points dropped) and over ``precision_recall_curve``, as in sklearn
    1.9, ties grouped.  Only one class: the AUROC is nan, as sklearn's
    (which warns); with no positive the recall is 1 at every threshold,
    as there."""
    fps, tps = _binary_curve(y_true, y_score)
    keep = slice(None)
    if fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                     True]
    rfps, rtps = np.r_[0.0, fps[keep]], np.r_[0.0, tps[keep]]
    fpr = rfps / rfps[-1] if rfps[-1] > 0 else np.full(rfps.shape, np.nan)
    tpr = rtps / rtps[-1] if rtps[-1] > 0 else np.full(rtps.shape, np.nan)
    roc = _trapezoid(tpr, fpr)

    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    pr = _trapezoid(np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0])
    return roc, pr


def rmse_expected(logits: torch.Tensor, labels: torch.Tensor, weight,
                  values) -> torch.Tensor:
    """GCMC's RMSE (DGL's ``evaluate``): the prediction of a rating is the
    softmax over its class-major logits (R, E) times the level ``values``
    (R,), against the value of its level index ``labels`` (E,); weighted by
    ``weight`` (E,), on the device."""
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=logits.device)
    pred = torch.softmax(logits, dim=0).T @ values
    err = (pred - values[labels.long()]) ** 2
    return torch.sqrt(torch.sum(err * weight) / torch.sum(weight))
