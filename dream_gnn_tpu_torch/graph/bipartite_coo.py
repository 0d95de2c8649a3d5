"""Sparse (padded-COO) bipartite encoder graph for large-scale configs.

Port of ``dream_gnn_tpu/graph/bipartite_coo.py``: one dst-sorted, padded
``CooGraph`` per (rating, direction), so edge dropout is a per-edge mask on
``val`` (augment/masks.py:edge_dropout_masks_coo) and never a rebuild.  The
GCMC layer aggregates over it with ``spmm_coo`` (nn/gcmc.py), a weighted
``index_add``: the JAX package leaves this layout to XLA's ``segment_sum``,
with no Pallas kernel.  The graphs are made on the host with numpy, with
the JAX builder's draws in the same order, and moved to the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
from dream_gnn_tpu_torch.graph.norms import inv_sqrt_norm
from dream_gnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BipartiteCoo:
    """Relation-typed bipartite graph, padded-COO layout.

    ``fwd[r]``: drug -> disease edges of rating r (dst = disease);
    ``rev[r]``: disease -> drug edges (dst = drug).  Norm vectors follow
    data_loader.py:453-488 (degree summed over all relations).
    """

    fwd: tuple        # tuple[CooGraph], len R
    rev: tuple        # tuple[CooGraph], len R
    ci_drug: torch.Tensor
    cj_drug: torch.Tensor
    ci_dis: torch.Tensor
    cj_dis: torch.Tensor

    @property
    def n_drug(self) -> int:
        return self.rev[0].n_dst

    @property
    def n_dis(self) -> int:
        return self.fwd[0].n_dst

    @property
    def num_ratings(self) -> int:
        return len(self.fwd)

    def num_edges(self) -> float:
        return float(sum(int((g.val != 0).sum()) for g in self.fwd)
                     + sum(int((g.val != 0).sum()) for g in self.rev))


def build_enc_graph_coo(pairs, values, n_drug: int, n_dis: int,
                        symm: bool = True, ratings: Sequence[int] = (0, 1),
                        pad_multiple: int = 512, device=None) -> BipartiteCoo:
    """The padded-COO encoder graph from (2, E) host ``pairs`` and their
    rating ``values`` (bipartite_coo.py:60-88), on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device("cuda" if device is None else device)
    pairs = np.asarray(pairs)
    values = np.asarray(values)
    fwd, rev = [], []
    for r in ratings:
        idx = np.where(values == r)[0]
        dr, di = pairs[0][idx], pairs[1][idx]
        ones = np.ones(len(idx), np.float32)
        fwd.append(coo_from_arrays(dr, di, ones, n_drug, n_dis,
                                   pad_multiple=pad_multiple, device=dev))
        rev.append(coo_from_arrays(di, dr, ones, n_dis, n_drug,
                                   pad_multiple=pad_multiple, device=dev))

    def norm(ids, n):
        deg = np.bincount(ids, minlength=n).astype(np.float32)
        return torch.from_numpy(inv_sqrt_norm(deg)).to(dev)

    ci_drug, ci_dis = norm(pairs[0], n_drug), norm(pairs[1], n_dis)
    cj_drug = ci_drug if symm else torch.ones_like(ci_drug)
    cj_dis = ci_dis if symm else torch.ones_like(ci_dis)
    return BipartiteCoo(fwd=tuple(fwd), rev=tuple(rev), ci_drug=ci_drug,
                        cj_drug=cj_drug, ci_dis=ci_dis, cj_dis=cj_dis)


def synthetic_bipartite_coo(n_drug: int, n_dis: int, n_edges: int,
                            seed: int = 0, pos_rate: float = 0.3,
                            pad_multiple: int = 512,
                            device=None) -> BipartiteCoo:
    """Random large bipartite graph of the scaling benchmark, the JAX
    builder's draws from ``default_rng(seed)`` in its order
    (bipartite_coo.py:91-105); ``pos_rate`` of the edges carry rating 1."""
    rng = np.random.default_rng(seed)
    dr = rng.integers(0, n_drug, n_edges).astype(np.int64)
    di = rng.integers(0, n_dis, n_edges).astype(np.int64)
    vals = (rng.random(n_edges) < pos_rate).astype(np.float32)
    return build_enc_graph_coo(np.stack([dr, di]), vals, n_drug, n_dis,
                               pad_multiple=pad_multiple, device=device)
