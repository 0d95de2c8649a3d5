"""The planted low-rank problem of the scale path, made on the device from
the run's seed.

The distribution of ``build_problem`` in the port's ``train/scale.py``
(copied from the JAX package's ``scripts/train_scale.py``), drawn with
torch on the card instead of numpy on the host:

    u ~ N(0, I_r) / sqrt(r) per drug, v per disease
    cells drawn uniformly, 5% oversampled, duplicates dropped (first kept)
    cell (i, j) is positive iff u_i . v_j lies above the (1 - pos_rate)
        quantile of the drawn cells' scores
    the first n_enc cells are the encoder graph, the next n_cand the train
        candidates, the last n_cand the test candidates
    features: u W_d + N(0, 0.25), v W_v + N(0, 0.25), W ~ N(0, 1) (r x d)

The program never reads this file.
"""

from __future__ import annotations

import torch


def planted_problem(n_drug: int, n_dis: int, rank: int, d: int, n_enc: int,
                    n_cand: int, pos_rate: float, seed: int, device) -> dict:
    """Tensors on ``device``: ``enc``, ``train`` and ``test`` as (src, dst,
    y), and ``feat_drug``, ``feat_dis``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    u = normal(n_drug, rank) / rank ** 0.5
    v = normal(n_dis, rank) / rank ** 0.5
    n_total = n_enc + 2 * n_cand
    n_draw = int(n_total * 1.05)
    src = torch.randint(0, n_drug, (n_draw,), generator=gen, device=device)
    dst = torch.randint(0, n_dis, (n_draw,), generator=gen, device=device)
    key = src * n_dis + dst
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    keep = torch.sort(order[first]).values[:n_total]
    if keep.shape[0] != n_total:
        raise ValueError("oversampling margin too small for these sizes")
    src, dst = src[keep], dst[keep]
    score = (u[src] * v[dst]).sum(1)
    k = int(round((1.0 - pos_rate) * n_total))
    tau = torch.sort(score).values[k - 1]
    y = (score > tau).float()
    w_d, w_v = normal(rank, d), normal(rank, d)
    feat_d = u @ w_d + 0.5 * normal(n_drug, d)
    feat_v = v @ w_v + 0.5 * normal(n_dis, d)
    part = lambda lo, hi: (src[lo:hi], dst[lo:hi], y[lo:hi])  # noqa: E731
    return dict(enc=part(0, n_enc), train=part(n_enc, n_enc + n_cand),
                test=part(n_enc + n_cand, n_total), feat_drug=feat_d,
                feat_dis=feat_v)
