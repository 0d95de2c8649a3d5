"""MovieLens-10M, the dataset of GCMC's published ml-10m run (DGL's
``examples/pytorch/gcmc``, ``data.py``): its schema, a reader of its
``ratings.dat`` and, where the file is absent, ratings made from a seed at
its shapes.

Schema: 69,878 users, 10,677 movies, 10,000,054 ratings on 10 levels,
0.5 to 5.0 in half stars; a rating is ``UserID::MovieID::Rating::Timestamp``
in ``ratings.dat``.  DGL's split: a random 10% of the ratings are the test
set, a random 10% of the rest the valid set, and the train set is what
remains (8,100,043 / 900,005 / 1,000,006).  Levels are given by their index
0..9 (level value 0.5 * (index + 1)).

The made ratings (``synthetic_ratings``) are a stand-in for trying the
path without the file: the dataset's counts of users, movies and ratings,
each (user, movie) pair rated once, pairs and levels drawn uniformly.
MovieLens' skews (heavy-tailed users, popular movies, rare half stars) are
left out; the benchmark makes ratings with them on the card
(``gnnbench/inputs/movielens.py``, the assumptions in its configuration).
"""

from __future__ import annotations

import numpy as np

N_USERS = 69_878
N_MOVIES = 10_677
N_RATINGS = 10_000_054
LEVELS = tuple(0.5 * (k + 1) for k in range(10))
TEST_RATIO = 0.1
VALID_RATIO = 0.1


def level_index(rating) -> np.ndarray:
    """The level index 0..9 of star ratings 0.5 .. 5.0."""
    idx = np.rint(np.asarray(rating, np.float64) * 2.0).astype(np.int64) - 1
    if idx.size and (idx.min() < 0 or idx.max() >= len(LEVELS)):
        raise ValueError("a rating is outside 0.5 .. 5.0")
    return idx


def read_ratings(path: str):
    """(users, movies, levels) of a ``ratings.dat``, the raw ids mapped to
    0.. in ascending order, and the (n_users, n_movies) counts."""
    with open(path, "rb") as f:
        text = f.read().replace(b"::", b" ").decode()
    raw = np.fromstring(text, dtype=np.float64, sep=" ").reshape(-1, 4)
    uid, users = np.unique(raw[:, 0].astype(np.int64), return_inverse=True)
    mid, movies = np.unique(raw[:, 1].astype(np.int64), return_inverse=True)
    return (users.astype(np.int64), movies.astype(np.int64),
            level_index(raw[:, 2]), len(uid), len(mid))


def split(n: int, seed: int):
    """(train, valid, test) index arrays of ``n`` ratings, as DGL's data.py
    splits them: the test set is the first ceil(0.1 n) of a permutation,
    the valid set the first ceil(0.1 m) of a permutation of the other m."""
    rng = np.random.default_rng(seed)
    n_test = int(np.ceil(n * TEST_RATIO))
    first = rng.permutation(n)
    test, rest = first[:n_test], first[n_test:]
    n_valid = int(np.ceil(rest.shape[0] * VALID_RATIO))
    second = rng.permutation(rest.shape[0])
    return rest[second[n_valid:]], rest[second[:n_valid]], test


def synthetic_ratings(seed: int, n_users: int = N_USERS,
                      n_movies: int = N_MOVIES, n_ratings: int = N_RATINGS):
    """(users, movies, levels) of ``n_ratings`` distinct (user, movie)
    pairs drawn uniformly from ``seed``, each with a uniform level, sorted
    by user and movie."""
    rng = np.random.default_rng(seed)
    key = np.sort(rng.choice(n_users * n_movies, n_ratings, replace=False))
    users, movies = np.divmod(key, n_movies)
    return users, movies, rng.integers(0, len(LEVELS), n_ratings)
