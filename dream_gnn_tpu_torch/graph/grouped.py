"""The grouped encoder layout, in a GPU layout.

Port of ``dream_gnn_tpu/graph/grouped.py``, with its builder entry points,
their arguments and its constants.  The JAX package packs each relation
into groups of at most 128 edges whose sources fall in a window of 128-row
sub-tiles of a superblock, chunks of groups per 512-row destination tile,
and a packed DMA schedule (grouped.py:1-57): geometry for Mosaic's
one-vreg ``dynamic_gather``, the VMEM panel ring and the MXU scatter.  None
of it has a counterpart on the card.  Here each relation and direction is
the dst-sorted CSR of graph/csr.py; ``edge_id`` is the index among the
live input edges (grouped.py:239-241), so both layouts of a pair carry the
same ids and the PRF edge dropout equals the JAX one bit for bit.  There
are no padding slots: ``occupancy`` is 1.0 and ``n_live`` the live edge
count.

The geometry arguments (``span``, ``window``, ``tile_dst``) are accepted
and unused; ``gpc`` (groups per chunk) is kept on the layout, where
kernels/spmm_gather.py validates a ``group_batch`` against it as the JAX
kernel does.  ``use_native`` (the JAX package's host C++ builder,
graph/native.py) is accepted and unused: the layout is built with torch on
the run's device.  The constants and helpers (``SUB`` .. ``LEAD``,
``p0_bits_for``, ``auto_gpc``, ``auto_span_window``) are kept because
callers import them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dream_gnn_tpu_torch.graph.csr import (CsrLayout, bipartite_relations,
                                           csr_fields)

SUB = 128                 # src rows per hardware gather (one vreg of lanes)
TILE_DST_G = 512          # dst rows per output block
GROUPS_PER_CHUNK = 16
SPAN = 16                 # src sub-tiles per superblock panel
WINDOW = 3                # consecutive sub-tiles addressable per group
NSLOTS = 4                # resident superblock panels (VMEM ring, pow2)
LEAD = 2                  # panel DMA issued LEAD transitions ahead


def p0_bits_for(span: int) -> int:
    """Bits of the base-sub-tile field of the JAX layout's packed meta."""
    return (span - 1).bit_length()


def auto_gpc(n_live: int, n_dst: int, tile_dst: int = TILE_DST_G) -> int:
    """Groups per chunk that the JAX builder picks for a layout's size
    (grouped.py:86-110)."""
    n_tiles = max(-(-n_dst // tile_dst), 1)
    est_slots_per_tile = n_live / n_tiles / (SUB * 0.9)
    if est_slots_per_tile >= 96:
        return 16
    if est_slots_per_tile >= 48:
        return 8
    if est_slots_per_tile >= 12:
        return 4
    return 2


def auto_span_window(n_live: int, n_src: int, n_dst: int,
                     tile_dst: int = TILE_DST_G):
    """The density-adaptive (span, window) of the JAX builder
    (grouped.py:113-137)."""
    density = n_live / max(float(n_src) * float(n_dst), 1.0)
    exp_per_subtile = density * tile_dst * SUB
    window = int(np.clip(np.ceil(180.0 / max(exp_per_subtile, 1e-12)),
                         3, 8))
    span = 16 if window <= 4 else 32
    return span, window


@dataclasses.dataclass(frozen=True)
class GroupedCoo(CsrLayout):
    """One direction of one relation: a dst-sorted CSR (graph/csr.py) and
    the JAX layout's groups per chunk."""

    gpc: int = GROUPS_PER_CHUNK

    @property
    def occupancy(self) -> float:
        """Live-edge fraction of the layout's slots: 1.0, as a CSR has no
        padding slots."""
        return 1.0


@dataclasses.dataclass(frozen=True)
class GroupedCooPair:
    """A relation's forward layout and its transpose (the backward's)."""

    fwd: GroupedCoo
    bwd: GroupedCoo


def grouped_from_arrays(src, dst, val, n_src: int, n_dst: int,
                        span: int | None = None, window: int | None = None,
                        use_native: bool = True, tile_dst: int = TILE_DST_G,
                        gpc: int | None = None, device=None) -> GroupedCoo:
    """The dst-sorted CSR of edges (src, dst, val); zero-weight edges are
    dropped.  ``gpc`` defaults to ``GROUPS_PER_CHUNK``, as in the JAX
    builder."""
    return GroupedCoo(**csr_fields(src, dst, val, n_src, n_dst, device),
                      gpc=GROUPS_PER_CHUNK if gpc is None else gpc)


def grouped_pair_from_arrays(src, dst, val, n_src: int, n_dst: int,
                             span: int | None = None,
                             window: int | None = None,
                             gpc: int | None = None,
                             device=None) -> GroupedCooPair:
    return GroupedCooPair(
        fwd=grouped_from_arrays(src, dst, val, n_src, n_dst, span=span,
                                window=window, gpc=gpc, device=device),
        bwd=grouped_from_arrays(dst, src, val, n_dst, n_src, span=span,
                                window=window, gpc=gpc, device=device))


@dataclasses.dataclass(frozen=True)
class BipartiteGrouped:
    """Relation-typed bipartite encoder graph in the grouped layout: per
    rating, the drug -> disease (``fwd``) and disease -> drug (``rev``)
    relations as ``GroupedCooPair``s for kernels/spmm_gather.py, with the
    norms of the COO layout (degree summed over relations)."""

    fwd: tuple
    rev: tuple
    ci_drug: torch.Tensor
    cj_drug: torch.Tensor
    ci_dis: torch.Tensor
    cj_dis: torch.Tensor

    @property
    def num_ratings(self) -> int:
        return len(self.fwd)


def build_enc_graph_grouped(pairs, values, n_drug: int, n_dis: int,
                            symm: bool = True, ratings=(0, 1),
                            device=None) -> BipartiteGrouped:
    """The grouped encoder graph from (2, E) drug/disease ``pairs`` and
    their rating ``values`` (grouped.py:401-424)."""
    return BipartiteGrouped(**bipartite_relations(
        pairs, values, n_drug, n_dis, grouped_pair_from_arrays, symm=symm,
        ratings=ratings, device=device))
