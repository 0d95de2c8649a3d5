"""The encoder graph of the single-device scale path, in a GPU layout.

Port of ``dream_gnn_tpu/graph/slabbed.py``, with its builder entry points
and their arguments.  The JAX package streams each relation through the
TPU in slabs, panels and windows sized to the TPU's scoped VMEM
(slabbed.py:52-106); that geometry has no counterpart on the card, and the
geometry arguments (``tile``, ``span``, ``window``, ``cs``, ``k``, ``d``)
are accepted and unused.  Here each relation and direction is the
dst-sorted CSR of graph/csr.py, whose ``edge_id`` counts the relation's
live input edges as the JAX builder does (slabbed.py:176-181), so the
forward layout and its transposed partner of a ``SlabbedCooPair`` carry the
same ids, and the PRF edge dropout (augment/masks.py:prf_mask_pair) drops
the same edges in both.
"""

from __future__ import annotations

import dataclasses

import torch

from dream_gnn_tpu_torch.graph.csr import (CsrLayout, bipartite_relations,
                                           csr_fields)


@dataclasses.dataclass(frozen=True)
class SlabbedCoo(CsrLayout):
    """One direction of one relation: a dst-sorted CSR (graph/csr.py)."""


@dataclasses.dataclass(frozen=True)
class SlabbedCooPair:
    """A relation's forward layout and its transpose (the backward's)."""

    fwd: SlabbedCoo
    bwd: SlabbedCoo


def slabbed_from_arrays(src, dst, val, n_src: int, n_dst: int,
                        tile=None, span=None, window=None, cs=None, k=None,
                        d: int = 128, device=None) -> SlabbedCoo:
    """The dst-sorted CSR of edges (src, dst, val); zero-weight edges are
    dropped.  The geometry arguments are the JAX signature's and unused."""
    return SlabbedCoo(**csr_fields(src, dst, val, n_src, n_dst, device))


def slabbed_pair_from_arrays(src, dst, val, n_src: int, n_dst: int,
                             tile=None, span=None, window=None,
                             d: int = 128, device=None) -> SlabbedCooPair:
    return SlabbedCooPair(
        fwd=slabbed_from_arrays(src, dst, val, n_src, n_dst, device=device),
        bwd=slabbed_from_arrays(dst, src, val, n_dst, n_src, device=device))


@dataclasses.dataclass(frozen=True)
class BipartiteSlabbed:
    """Relation-typed bipartite encoder graph of the scale path: per
    rating, the drug -> disease (``fwd``) and disease -> drug (``rev``)
    relations as ``SlabbedCooPair``s, with the norms of the dense layout
    (degree summed over relations, slabbed.py:361-368)."""

    fwd: tuple
    rev: tuple
    ci_drug: torch.Tensor
    cj_drug: torch.Tensor
    ci_dis: torch.Tensor
    cj_dis: torch.Tensor

    @property
    def num_ratings(self) -> int:
        return len(self.fwd)


def build_enc_graph_slabbed(pairs, values, n_drug: int, n_dis: int,
                            symm: bool = True, ratings=(0, 1), d: int = 128,
                            device=None) -> BipartiteSlabbed:
    """The scale path's encoder graph from (2, E) drug/disease ``pairs``
    and their rating ``values`` (slabbed.py:339-371).  ``d`` is the JAX
    signature's and unused."""
    return BipartiteSlabbed(**bipartite_relations(
        pairs, values, n_drug, n_dis, slabbed_pair_from_arrays, symm=symm,
        ratings=ratings, device=device))
