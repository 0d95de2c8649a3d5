"""Cross-validation splits with exact reference parity, without sklearn.

The reference KFold-splits positive and negative pairs *separately*
(10 folds, shuffle, random_state=1024 — data_loader.py:136-203) and
orders each fold's edge list as [positives..., negatives...] with
values [1...,0...].  Label vectors are matched to decoder-graph edges
by position, so this ordering is part of the data contract.

``kfold_indices`` reproduces ``sklearn.model_selection.KFold(n_splits,
shuffle=True, random_state=seed)``: the indices are shuffled once by
``np.random.RandomState(seed)``, cut into folds of ``n // k`` (the
first ``n % k`` folds one larger), and each fold's test indices are
returned *sorted*, as sklearn's boolean test mask gives them, with the
sorted complement as train indices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FoldSplit:
    train_pairs: np.ndarray     # (2, E_train) int64 [drug; disease]
    train_values: np.ndarray    # (E_train,) float32, positives first
    test_pairs: np.ndarray      # (2, E_test)
    test_values: np.ndarray     # (E_test,)


def kfold_indices(n: int, n_splits: int,
                  seed: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(train_idx, test_idx) per fold, as sklearn's shuffled KFold."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=np.int64)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        mask = np.zeros(n, dtype=bool)
        mask[idx[start:start + size]] = True
        start += size
        yield np.flatnonzero(~mask), np.flatnonzero(mask)


def make_cv_splits(association: np.ndarray, n_folds: int = 10,
                   seed: int = 1024) -> Dict[int, FoldSplit]:
    """Reference ``_create_cv_splits`` (data_loader.py:136-203)."""
    pos_row, pos_col = np.nonzero(association)
    neg_row, neg_col = np.nonzero(1 - association)

    splits: Dict[int, FoldSplit] = {}
    for cv, ((tr_p, te_p), (tr_n, te_n)) in enumerate(
            zip(kfold_indices(len(pos_row), n_folds, seed),
                kfold_indices(len(neg_row), n_folds, seed))):
        train_pairs = np.concatenate([
            np.stack([pos_row[tr_p], pos_col[tr_p]]),
            np.stack([neg_row[tr_n], neg_col[tr_n]])], axis=1)
        test_pairs = np.concatenate([
            np.stack([pos_row[te_p], pos_col[te_p]]),
            np.stack([neg_row[te_n], neg_col[te_n]])], axis=1)
        train_values = np.zeros(train_pairs.shape[1], np.float32)
        train_values[: len(tr_p)] = 1.0
        test_values = np.zeros(test_pairs.shape[1], np.float32)
        test_values[: len(te_p)] = 1.0
        splits[cv] = FoldSplit(train_pairs, train_values,
                               test_pairs, test_values)
    return splits
