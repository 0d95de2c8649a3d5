"""Device-resident bipartite encoder graph, dense-mask layout.

The reference builds a DGL heterograph with one edge type per rating
value plus reverse types (data_loader.py:400-490): both observed
(label-1) and unobserved (label-0) drug-disease pairs are typed edges,
so the rating-0 relation covers ~99% of all pairs.  That density makes
the whole graph a pair of dense masks over the (n_drug, n_disease)
grid, and per-relation message passing a dense matrix product —

    A_r = a1                      (rating 1)
    A_0 = mask - a1               (rating 0: in-fold pairs that are not
                                   associations)

Degree normalisation follows data_loader.py:453-488: ``ci``/``cj`` are
1/sqrt of the node degree *summed over all rating types*; zero-degree
nodes get 0 (1/sqrt(inf)).  With ``symm`` off, ``cj`` is all-ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dream_gnn_tpu_torch.graph.norms import inv_sqrt_norm


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Dense-mask bipartite graph with GCMC degree norms.

    Every field may carry a leading fold axis (sharding/foldstack.py).

    Attributes:
      a1:   (n_drug, n_dis) float — 1.0 where an observed association
            (rating-1 pair) of this fold exists.
      mask: (n_drug, n_dis) float — 1.0 where the pair belongs to this
            fold's edge set (rating 0 or 1).
      ci_drug, cj_drug: (n_drug, 1) float — dst/src degree norms.
      ci_dis,  cj_dis:  (n_dis, 1)  float.
    """

    a1: torch.Tensor
    mask: torch.Tensor
    ci_drug: torch.Tensor
    cj_drug: torch.Tensor
    ci_dis: torch.Tensor
    cj_dis: torch.Tensor

    @property
    def n_drug(self) -> int:
        return self.a1.shape[-2]

    @property
    def n_dis(self) -> int:
        return self.a1.shape[-1]

    def a0(self) -> torch.Tensor:
        return self.mask - self.a1


def build_enc_graph(pairs: np.ndarray, values: np.ndarray,
                    n_drug: int, n_dis: int, symm: bool = True, *,
                    device="cuda") -> BipartiteGraph:
    """Build the encoder graph from fold pairs.

    Args:
      pairs: (2, E) int array of (drug_id, disease_id) pairs.
      values: (E,) float/int array of ratings in {0, 1}.
      symm: symmetric normalisation (reference ``gcn_agg_norm_symm``).

    Follows data_loader.py:400-490: degrees for ci/cj sum over *all*
    rating relations (a node's degree is simply the number of in-fold
    pairs incident on it).
    """
    pairs = np.asarray(pairs)
    values = np.asarray(values)
    a1 = np.zeros((n_drug, n_dis), np.float32)
    mask = np.zeros((n_drug, n_dis), np.float32)
    mask[pairs[0], pairs[1]] = 1.0
    pos = values > 0.5
    a1[pairs[0][pos], pairs[1][pos]] = 1.0

    ci_drug = inv_sqrt_norm(mask.sum(axis=1))
    ci_dis = inv_sqrt_norm(mask.sum(axis=0))
    if symm:
        cj_drug, cj_dis = ci_drug, ci_dis
    else:
        cj_drug = np.ones((n_drug, 1), np.float32)
        cj_dis = np.ones((n_dis, 1), np.float32)

    def t(x):
        return torch.as_tensor(x, device=device)

    return BipartiteGraph(a1=t(a1), mask=t(mask), ci_drug=t(ci_drug),
                          cj_drug=t(cj_drug), ci_dis=t(ci_dis),
                          cj_dis=t(cj_dis))
