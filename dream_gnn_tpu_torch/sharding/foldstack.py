"""Fold stacking: identical-shape folds -> one batched set of inputs.

Port of ``dream_gnn_tpu/sharding/foldstack.py``.  Folds of a KFold split
differ in edge count by at most one element per class, so stacking pads
every fold's decoder edge list to a common budget and carries a per-edge
weight (1 real / 0 pad).  Every tensor of the fold's ``ModelInputs``
gains a leading fold axis F, the fold-invariant similarity graphs and
features included, so that each fold's augmentation can drop its own
entries.  The reference runs the folds strictly sequentially
(train.py:500); train/stacked.py trains the stack as one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.kernels.edge_decoder import edge_order
from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs
from dream_gnn_tpu_torch.train.loop import fold_inputs


@dataclasses.dataclass(frozen=True)
class StackedFolds:
    """Fold-stacked arrays: every tensor has leading axis F."""

    inputs: ModelInputs
    labels: torch.Tensor         # (F, E_pad)
    edge_weight: torch.Tensor    # (F, E_pad), 0 on padding

    @property
    def n_folds(self) -> int:
        return self.labels.shape[0]


def tree_map(fn, *trees):
    """``fn`` over the tensors of matching trees of dataclasses, dicts,
    lists and tensors; None stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    raise TypeError(f"cannot map over {type(first).__name__}")


def tile(stacked: StackedFolds, n: int) -> StackedFolds:
    """The stack repeated ``n`` times along the fold axis (seed-major)."""
    if n == 1:
        return stacked
    return tree_map(lambda a: torch.cat([a] * n), stacked)


def _pad_1d(x: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,), dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def stack_folds(dataset: DreamDataset, folds: Sequence[int],
                pad_multiple: int = 128, side: str = "train") -> StackedFolds:
    """Stack the train (default) or test side of the given folds.

    ``side='test'`` stacks the evaluation inputs: the *test* encoder
    graph with the test candidate pairs (parity trap SURVEY §7.3.1 —
    test evaluation runs the encoder on the test enc graph).
    """
    if side not in ("train", "test"):
        raise ValueError(f"side must be 'train' or 'test', got {side!r}")
    sel = []
    for cv in folds:
        train_in, test_in, *_ = fold_inputs(dataset, cv)
        fold = dataset.fold(cv)
        if side == "train":
            sel.append((train_in, fold.train_labels, fold.train_w))
        else:
            sel.append((test_in, fold.test_labels, fold.test_w))
    e_max = max(int(t[0].dec_src.shape[0]) for t in sel)
    e_pad = -(-e_max // pad_multiple) * pad_multiple

    stacked_inputs, labels, weights = [], [], []
    for fold_in, fold_lab, w_in in sel:
        e = int(fold_in.dec_src.shape[0])
        # Padding edges point at node 0 (gathers stay in bounds) and get
        # zero loss weight; the loader's own padding carries its weights.
        src = _pad_1d(fold_in.dec_src, e_pad)
        dst = _pad_1d(fold_in.dec_dst, e_pad)
        stacked_inputs.append(dataclasses.replace(
            fold_in, dec_src=src, dec_dst=dst,
            dec_order=edge_order(src, dst, dataset.n_drug, dataset.n_dis)))
        labels.append(_pad_1d(fold_lab, e_pad))
        w = torch.zeros((e_pad,), dtype=torch.float32,
                        device=fold_lab.device)
        w[:e] = 1.0 if w_in is None else w_in[:e]
        weights.append(w)

    return StackedFolds(
        inputs=tree_map(lambda *xs: torch.stack(xs), *stacked_inputs),
        labels=torch.stack(labels), edge_weight=torch.stack(weights))
