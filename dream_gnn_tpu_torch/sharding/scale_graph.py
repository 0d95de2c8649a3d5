"""Rank-sharded bipartite encoder graphs: the edge-partitioned encoder.

Port of ``dream_gnn_tpu/sharding/scale_graph.py``.  For graphs too large
for one device, every (rating, direction) relation of the encoder
heterograph is partitioned by destination row over the ranks of one mesh
axis: each rank owns a contiguous block of ``ceil(n / S)`` destination rows
and the edges into it, and source features reach it through a halo
exchange.  Three layouts:

- ``BipartiteSharded``: each rank's block a padded COO
  (sharding/edge_partition.py), aggregated by ``index_add``, the halo an
  all-gather;
- ``BipartiteShardedGrouped``: each rank's block a grouped layout pair
  (graph/grouped.py, the port's CSR) aggregated by the grouped SpMM kernel
  (kernels/spmm_gather.py), the halo an all-gather
  (``spmm_gather_sharded``);
- the same with ``ring=True``: each rank's block split into S sub-blocks by
  source block, in ring order, so that the halo is S - 1 ring shifts of one
  source block each, every sub-block aggregated while its source block is
  resident (``spmm_gather_sharded_ring``).  Sub-blocks index their sources
  within their source block.

The GCMC layer (nn/gcmc.py) runs its whole per-node computation on row
blocks over these graphs; model/dream_gnn.py shards the features into the
encoder and gathers its outputs (sharding/collectives.py, ``RowBlock``).

Edge ids.  A grouped layout's ``edge_id`` keys the PRF edge dropout
(augment/masks.py:prf_mask_pair).  Here it is the edge's index among the
relation's live input edges, the id the unsharded layout gives it, so the
sharded layouts draw the unsharded layout's masks bit for bit at every rank
count.  (The JAX package numbers each shard's edges from a per-shard base,
scale_graph.py:221-225 and 271-276, which equals this only where the input
edges come sorted by destination shard.)

JAX's ``_pad_chunks`` (scale_graph.py:117-148) pads every shard's layout
to common chunk counts so that the shards can be stacked leaf-wise on one
controller.  Ranks share no shapes, so it has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
from dream_gnn_tpu_torch.graph.grouped import (GroupedCooPair, auto_gpc,
                                               auto_span_window,
                                               grouped_pair_from_arrays)
from dream_gnn_tpu_torch.graph.norms import inv_sqrt_norm
from dream_gnn_tpu_torch.kernels.spmm_gather import spmm_gather
from dream_gnn_tpu_torch.sharding.collectives import (RowBlock,
                                                       all_gather_rows,
                                                       ring_shift)
from dream_gnn_tpu_torch.sharding.edge_partition import (pad_rows,
                                                         put_sharded_coo,
                                                         shard_coo_by_dst)
from dream_gnn_tpu_torch.utils.device import as_tensor


@dataclasses.dataclass(frozen=True)
class _ShardedEncoder:
    """What both sharded layouts share: the norms (full, (n, 1), on every
    rank), the mesh axis and the node counts."""

    fwd: tuple
    rev: tuple
    ci_drug: torch.Tensor
    cj_drug: torch.Tensor
    ci_dis: torch.Tensor
    cj_dis: torch.Tensor
    mesh: object
    axis: str
    n_drug: int
    n_dis: int

    @property
    def num_ratings(self) -> int:
        return len(self.fwd)

    @property
    def group(self):
        return self.mesh.group(self.axis)

    @property
    def drug_rows(self) -> RowBlock:
        """This rank's block of drug rows (the rev relations' dst)."""
        return RowBlock(self.n_drug, self.group)

    @property
    def dis_rows(self) -> RowBlock:
        """This rank's block of disease rows (the fwd relations' dst)."""
        return RowBlock(self.n_dis, self.group)


@dataclasses.dataclass(frozen=True)
class BipartiteSharded(_ShardedEncoder):
    """``fwd[r]``: this rank's block of the drug -> disease edges of rating
    r (dst = disease rows); ``rev[r]``: disease -> drug.  Placed
    ``ShardedCoo``s.  Norms follow data_loader.py:453-488 (degree summed
    over all relations)."""

    n_edges: int = 0

    def num_edges(self) -> float:
        return float(self.n_edges)


@dataclasses.dataclass(frozen=True)
class BipartiteShardedGrouped(_ShardedEncoder):
    """``fwd[r]`` and ``rev[r]``: this rank's ``GroupedCooPair`` of each
    relation, or with ``ring`` a tuple of S sub-block pairs, sub-block j
    holding the edges whose sources lie in source block (rank + j) % S."""

    ring: bool = False


def _norms(pairs: torch.Tensor, n_drug: int, n_dis: int, symm: bool):
    def norm(ids, n):
        deg = torch.bincount(ids, minlength=n).to(torch.float32).cpu().numpy()
        return torch.from_numpy(inv_sqrt_norm(deg)).to(pairs.device)

    ci_drug, ci_dis = norm(pairs[0], n_drug), norm(pairs[1], n_dis)
    return dict(ci_drug=ci_drug, ci_dis=ci_dis,
                cj_drug=ci_drug if symm else torch.ones_like(ci_drug),
                cj_dis=ci_dis if symm else torch.ones_like(ci_dis))


def _relations(pairs, values, ratings, device):
    """(pairs (2, E) int64, and per rating its (drug, disease) ids) on
    ``device``."""
    pairs = as_tensor(pairs, torch.int64, device)
    values = as_tensor(values, torch.int64, pairs.device)
    return pairs, [(pairs[0][values == r], pairs[1][values == r])
                   for r in ratings]


def build_enc_graph_sharded(pairs, values, n_drug: int, n_dis: int, mesh,
                            axis: str, symm: bool = True, ratings=(0, 1),
                            pad_multiple: int = 512,
                            device=None) -> BipartiteSharded:
    """Plan the encoder heterograph over ``mesh[axis]`` and keep this
    rank's edge blocks on ``device`` (scale_graph.py:72-108 of the JAX
    package)."""
    pairs, rels = _relations(pairs, values, ratings, device)
    n_shards = mesh.shape[axis]
    fwd, rev = [], []
    for dr, di in rels:
        ones = torch.ones(dr.shape[0])
        for out, s, d, ns, nd in ((fwd, dr, di, n_drug, n_dis),
                                  (rev, di, dr, n_dis, n_drug)):
            plan = shard_coo_by_dst(
                coo_from_arrays(s.cpu().numpy(), d.cpu().numpy(),
                                ones.numpy(), ns, nd, device="cpu"),
                n_shards, pad_multiple)
            out.append(put_sharded_coo(mesh, axis, plan, pairs.device))
    return BipartiteSharded(
        fwd=tuple(fwd), rev=tuple(rev), mesh=mesh, axis=axis, n_drug=n_drug,
        n_dis=n_dis, n_edges=2 * sum(int(dr.shape[0]) for dr, _ in rels),
        **_norms(pairs, n_drug, n_dis, symm))


def _shard_pair(src, dst, live_id, n_src: int, n_dst: int, gpc: int,
                span: int, window: int) -> GroupedCooPair:
    """The grouped layout pair of the edges (src, dst) (ones as weights)
    whose ids among the relation's live edges are ``live_id``."""
    p = grouped_pair_from_arrays(src, dst, torch.ones(src.shape[0],
                                                      device=src.device),
                                 n_src, n_dst, span=span, window=window,
                                 gpc=gpc)
    return GroupedCooPair(
        fwd=dataclasses.replace(p.fwd, edge_id=live_id[p.fwd.edge_id.long()]
                                .int()),
        bwd=dataclasses.replace(p.bwd, edge_id=live_id[p.bwd.edge_id.long()]
                                .int()))


def _sharded_grouped_pair(src, dst, n_src: int, n_dst: int, n_shards: int,
                          shard: int) -> GroupedCooPair:
    """This shard's GroupedCooPair: the edges into its dst rows, dst made
    shard-local (scale_graph.py:196-234 of the JAX package)."""
    rps = -(-n_dst // n_shards)
    # The density-adaptive geometry from the full relation, as JAX resolves
    # it (the CSR keeps only gpc).
    n_live_shard = src.shape[0] // n_shards
    span, window = auto_span_window(n_live_shard, n_src, rps)
    gpc = auto_gpc(n_live_shard, rps)
    m = (dst // rps) == shard
    live_id = torch.nonzero(m).flatten()
    return _shard_pair(src[m], dst[m] - shard * rps, live_id, n_src, rps, gpc,
                       span, window)


def _sharded_grouped_ring(src, dst, n_src: int, n_dst: int, n_shards: int,
                          shard: int) -> tuple:
    """This shard's S sub-block pairs for the ring: sub-block j holds the
    edges whose src lies in block (shard + j) % S, with block-local src
    (scale_graph.py:237-287 of the JAX package)."""
    rps_dst = -(-n_dst // n_shards)
    rps_src = -(-n_src // n_shards)
    # One geometry for every sub-block, resolved from the sub-block size.
    n_live_sub = src.shape[0] // (n_shards * n_shards)
    span, window = auto_span_window(n_live_sub, rps_src, rps_dst)
    gpc = auto_gpc(n_live_sub, rps_dst)
    mine = (dst // rps_dst) == shard
    row = []
    for j in range(n_shards):
        b = (shard + j) % n_shards
        m = mine & ((src // rps_src) == b)
        live_id = torch.nonzero(m).flatten()
        row.append(_shard_pair(src[m] - b * rps_src, dst[m] - shard * rps_dst,
                               live_id, rps_src, rps_dst, gpc, span, window))
    return tuple(row)


def build_enc_graph_sharded_grouped(pairs, values, n_drug: int, n_dis: int,
                                    mesh, axis: str, symm: bool = True,
                                    ratings=(0, 1), ring: bool = False,
                                    device=None) -> BipartiteShardedGrouped:
    """This rank's grouped blocks of the encoder heterograph over
    ``mesh[axis]``, on ``device``; with ``ring`` each block split by source
    block in ring order (scale_graph.py:373-411 of the JAX package)."""
    pairs, rels = _relations(pairs, values, ratings, device)
    n_shards, shard = mesh.shape[axis], mesh.index(axis)
    build = _sharded_grouped_ring if ring else _sharded_grouped_pair
    fwd = tuple(build(dr, di, n_drug, n_dis, n_shards, shard)
                for dr, di in rels)
    rev = tuple(build(di, dr, n_dis, n_drug, n_shards, shard)
                for dr, di in rels)
    return BipartiteShardedGrouped(
        fwd=fwd, rev=rev, mesh=mesh, axis=axis, n_drug=n_drug, n_dis=n_dis,
        ring=ring, **_norms(pairs, n_drug, n_dis, symm))


def spmm_gather_sharded(mesh, axis: str, pair: GroupedCooPair,
                        x: torch.Tensor, n_dst: int,
                        rows_per_shard: int) -> torch.Tensor:
    """This rank's (rows_per_shard, d) f32 block of a dst-sharded SpMM: the
    halo all-gather of every rank's block of x (this rank's at most
    ceil(n_src / S) rows), then the grouped SpMM kernel over this rank's
    pair (scale_graph.py:336-370 of the JAX package).  ``n_dst`` is the
    relation's destination count."""
    group = mesh.group(axis)
    n_src = pair.fwd.n_src
    x_full = all_gather_rows(pad_rows(x, -(-n_src // mesh.shape[axis])),
                             group)
    out = spmm_gather(pair, x_full[:n_src])
    if out.shape[0] != rows_per_shard or \
            rows_per_shard != -(-n_dst // mesh.shape[axis]):
        raise ValueError(f"local SpMM rows {out.shape[0]} != rows_per_shard "
                         f"{rows_per_shard}")
    return out


def spmm_gather_sharded_ring(mesh, axis: str, pairs: tuple, x: torch.Tensor,
                             n_dst: int, rows_per_shard: int) -> torch.Tensor:
    """The same block with the halo as a ring (scale_graph.py:290-333 of
    the JAX package): at step j this rank aggregates sub-block j against
    the source block it holds, then passes that block to rank - 1 and takes
    rank + 1's.  Only two source blocks are ever resident; the backward
    runs the ring the other way (sharding/collectives.py)."""
    group = mesh.group(axis)
    n_shards = mesh.shape[axis]
    buf = pad_rows(x, pairs[0].fwd.n_src)
    acc = None
    for j in range(n_shards):
        out = spmm_gather(pairs[j], buf)
        acc = out if acc is None else acc + out
        if j < n_shards - 1:
            buf = ring_shift(buf, group)
    if acc.shape[0] != rows_per_shard or \
            rows_per_shard != -(-n_dst // n_shards):
        raise ValueError(f"local SpMM rows {acc.shape[0]} != rows_per_shard "
                         f"{rows_per_shard}")
    return acc
