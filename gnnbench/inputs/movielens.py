"""MovieLens-10M-shaped ratings, made on the device from the run's seed.

The benchmark's own generator (the program's data/movielens.py is not
used): the configuration's users, movies and ratings, each (user, movie)
pair rated once, and DGL's split of examples/pytorch/gcmc's data.py (a
random ``test_ratio`` of the ratings is the test set, a random
``valid_ratio`` of the rest the valid set).  The shapes that set a step's
cost follow the configuration's ``assumed`` block: users' counts
log-normal (sigma 1.1) with at least ``min_user_ratings`` and at most a
quarter of the movies; movies' popularity 1 / (rank + 60), the ranks
shuffled; the levels' shares ``level_shares``.
"""

from __future__ import annotations

import math

import torch


def _user_counts(gen, n_users: int, n_ratings: int, n_movies: int, low: int,
                 device) -> torch.Tensor:
    cap = n_movies // 4 - low
    extra = n_ratings - low * n_users
    if extra < 0 or extra > cap * n_users:
        raise ValueError("the ratings do not fit the users' bounds")
    w = torch.exp(1.1 * torch.randn(n_users, generator=gen, device=device,
                                    dtype=torch.float64))
    lo, hi = 0.0, extra / float(w.min())
    for _ in range(100):                       # sum(min(cap, s w)) = extra
        mid = (lo + hi) / 2
        if float(torch.clamp_max(mid * w, cap).sum()) < extra:
            lo = mid
        else:
            hi = mid
    x = torch.clamp_max(hi * w, cap)
    counts = torch.floor(x).long()
    short = extra - int(counts.sum())
    rest = torch.where(counts < cap, x - counts, torch.full_like(x, -1.0))
    counts[torch.argsort(-rest, stable=True)[:short]] += 1
    return counts + low


def ratings(cfg: dict, seed: int, device) -> dict:
    """users, movies, levels (int64, one entry a rating) and the index sets
    train, valid and test, all on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nu, nm, n = cfg["n_users"], cfg["n_movies"], cfg["n_ratings"]
    a = cfg["assumed"]
    counts = _user_counts(gen, nu, n, nm, a["min_user_ratings"], device)
    users = torch.repeat_interleave(torch.arange(nu, device=device), counts)
    pop = 1.0 / (torch.arange(nm, device=device, dtype=torch.float64) + 60.0)
    pop = pop[torch.randperm(nm, generator=gen, device=device)]
    cdf = torch.cumsum(pop / pop.sum(), 0)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    movies = torch.clamp_max(torch.searchsorted(cdf, u), nm - 1)
    # A pair drawn twice is drawn again, uniformly, until all are distinct.
    while True:
        key = users * nm + movies
        order = torch.argsort(key, stable=True)
        dup = torch.zeros(n, dtype=torch.bool, device=device)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        k = int(dup.sum())
        if k == 0:
            break
        movies[dup] = torch.randint(0, nm, (k,), generator=gen, device=device)
    shares = torch.tensor(a["level_shares"], dtype=torch.float64,
                          device=device)
    lcdf = torch.cumsum(shares / shares.sum(), 0)
    levels = torch.clamp_max(torch.searchsorted(
        lcdf, torch.rand(n, generator=gen, device=device,
                         dtype=torch.float64)), len(shares) - 1)
    n_test = math.ceil(n * cfg["test_ratio"])
    first = torch.randperm(n, generator=gen, device=device)
    test, rest = first[:n_test], first[n_test:]
    n_valid = math.ceil(rest.shape[0] * cfg["valid_ratio"])
    second = torch.randperm(rest.shape[0], generator=gen, device=device)
    return dict(users=users, movies=movies, levels=levels,
                train=rest[second[n_valid:]], valid=rest[second[:n_valid]],
                test=test)
