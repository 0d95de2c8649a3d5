"""The grid and per-edge decoders on a dp x mp mesh.

Port of the three JAX kernel functions that run an already-ported decoder
kernel under ``jax.shard_map``:

- ``fused_grid_decoder_batched_spmd`` (pallas_grid_decoder.py:622 there):
  the fold-batched grid decoder (rows 3 and 4) on the rank's (F/dp, Nd,
  Nv/mp) block;
- ``fused_decoder_batched_spmd`` (pallas_decoder_batched.py:256): the
  fold-batched per-edge decoder (rows 7 and 8) on the rank's (F/dp, E/mp)
  edge block;
- ``fused_grid_decoder_spmd2d`` (pallas_grid_decoder.py:356): one fold's
  grid (rows 1 and 2), drug rows over one mesh axis and disease rows over
  the other.

The port runs one process a rank, so each wrapper takes this rank's blocks
and returns what the rank needs.  The fold axis is already the rank's: the
inputs carry its F/dp folds (sharding/partition.py).  Within the rank's
``mp`` group the node projections and the MLP weights are replicated; they
enter the sharded region through ``replicated_in``, whose backward
all-reduces the rank's partial gradient over the group, and a
replicated tensor of which the rank decodes one block becomes that block
through ``RowBlock.shard_rows``, whose backward all-gathers the blocks'
gradients.  The logits are gathered back over the group
(``RowBlock.gather``), so the loss code sees the whole grid or edge list of
the rank's folds.  These are the collectives of JAX's ``shard_map``
transpose, written out: dPd, db1, dW2, db2 and dw3 summed over ``mp``, dPv
the blocks' own.

Padding is to divisibility only (``RowBlock``: ceil(n / S) rows a rank;
the JAX wrappers' ``_ROWS`` x 128 tiles are TPU geometry); pad cells and
pad edges (0, 0) are computed and sliced away, and their cotangent is zero.

Dropout.  JAX offsets each shard's seed by its mesh index x 1000003, a
stream that differs from one device's.  Here the grid kernels hash each
cell by its global row and column (the launch's ``row_base`` and
``col_base``, csrc/grid_decoder.cu), and the per-edge kernels by the edge's
node ids, so every block draws the unsharded masks bit for bit: S ranks
give one rank's result.
"""

from __future__ import annotations

import dataclasses

import torch

from dream_gnn_tpu_torch.kernels.edge_decoder import (EdgeCSR, edge_csr,
                                                      fused_decoder_batched)
from dream_gnn_tpu_torch.kernels.grid_decoder import (
    fused_grid_decoder, fused_grid_decoder_batched)
from dream_gnn_tpu_torch.sharding.collectives import RowBlock, replicated_in


def _shard(rows: RowBlock, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``rows.shard_rows`` along axis ``dim`` of ``x``."""
    return rows.shard_rows(x.movedim(dim, 0)).movedim(0, dim)


def _gather(rows: RowBlock, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``rows.gather`` along axis ``dim`` of ``x``, laid out as ``x`` (the
    loss then sums the logits in the order it sums them without a mesh)."""
    return rows.gather(x.movedim(dim, 0).contiguous()).movedim(
        0, dim).contiguous()


def fused_grid_decoder_batched_spmd(mesh, proj_drug, proj_dis, b1, w2, b2,
                                    w3, seed, rate: float, train: bool,
                                    dtype=torch.bfloat16):
    """The fold-batched grid decoder MLP with the disease columns over the
    mesh's ``mp`` axis.

    Args are this rank's folds, replicated over the axis: proj_drug (F',
    Nd, 128), proj_dis (F', Nv, 128), b1 (F', 128), w2 (F', 128, 64), b2
    (F', 64), w3 (F', 64), all f32, and seed (F',) int32.  The rank runs
    one launch of rows 3 and 4 on its ceil(Nv / mp) columns, hashed from
    their first global column.  Returns the (F', Nd, Nv) logits without b3,
    gathered over the axis.
    """
    group = mesh.group("mp")
    cols = RowBlock(proj_dis.shape[-2], group)
    b1, w2, b2, w3 = (replicated_in(x, group) for x in (b1, w2, b2, w3))
    logits = fused_grid_decoder_batched(
        replicated_in(proj_drug, group), _shard(cols, proj_dis, -2), b1, w2,
        b2, w3, seed, rate, train, dtype, col_base=cols.lo)
    return _gather(cols, logits, -1)


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """This rank's block of a fold stack's edge list over the mesh's
    ``mp`` axis: edges (F', 2, ceil(E / mp)) int32 [src; dst], padded with
    (0, 0), and the block's CSR orderings, built once for the list
    (``shard_edges``)."""

    edges: torch.Tensor
    csr: EdgeCSR
    n_edges: int


def shard_edges(mesh, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                n_drug: int, n_dis: int) -> EdgeShard:
    """The ``EdgeShard`` of edges (F', E) over the mesh's ``mp`` axis."""
    rows = RowBlock(edge_src.shape[-1], mesh.group("mp"))
    edges = torch.stack([rows.block(edge_src.int().T).T,
                         rows.block(edge_dst.int().T).T], dim=1).contiguous()
    return EdgeShard(edges=edges,
                     csr=edge_csr(edges[:, 0], edges[:, 1], n_drug, n_dis),
                     n_edges=edge_src.shape[-1])


def fused_decoder_batched_spmd(mesh, proj_drug, proj_dis, b1, w2, b2, w3, b3,
                               shard: EdgeShard, seed, rate: float,
                               train: bool, dtype=torch.bfloat16):
    """The fold-batched per-edge decoder MLP with the edges over the
    mesh's ``mp`` axis.

    Args are this rank's folds, replicated over the axis: proj_drug (F',
    Nd, 128), proj_dis (F', Nv, 128), b1, w2, b2, w3, b3 (F', 1), all f32,
    seed (F',) int32, and the rank's ``EdgeShard``.  The rank runs one
    launch of rows 7 and 8 on its edge block.  Returns the (F', E) logits,
    gathered over the axis.
    """
    group = mesh.group("mp")
    tables = (replicated_in(x, group)
              for x in (proj_drug, proj_dis, b1, w2, b2, w3, b3))
    logits = fused_decoder_batched(*tables, shard.edges, seed, rate, train,
                                   dtype, shard.csr)
    return _gather(RowBlock(shard.n_edges, group), logits, -1)


def fused_grid_decoder_spmd2d(mesh, drug_axis, dis_axis, proj_drug, proj_dis,
                              b1, w2, b2, w3, seed, rate: float, train: bool,
                              dtype=torch.bfloat16):
    """One fold's grid decoder MLP on a 2-D mesh: drug rows over
    ``drug_axis``, disease rows over ``dis_axis``.

    Args are replicated on every rank of the mesh: proj_drug (Nd, 128),
    proj_dis (Nv, 128), b1 (128,), w2 (128, 64), b2 (64,), w3 (64,), seed
    (1,) int32.  The rank runs one launch of rows 1 and 2 on its (ceil(Nd /
    D), ceil(Nv / M)) block, hashed from the block's first global row and
    column.  Pd's gradient is summed over ``dis_axis``, Pv's over
    ``drug_axis``, the weights' over both.  Returns the (Nd, Nv) logits
    without b3, gathered on every rank.
    """
    drug_g, dis_g = mesh.group(drug_axis), mesh.group(dis_axis)
    rows = RowBlock(proj_drug.shape[0], drug_g)
    cols = RowBlock(proj_dis.shape[0], dis_g)
    b1, w2, b2, w3 = (replicated_in(replicated_in(x, drug_g), dis_g)
                      for x in (b1, w2, b2, w3))
    logits = fused_grid_decoder(
        rows.shard_rows(replicated_in(proj_drug, dis_g)),
        cols.shard_rows(replicated_in(proj_dis, drug_g)), b1, w2, b2, w3,
        seed, rate, train, dtype, row_base=rows.lo, col_base=cols.lo)
    return rows.gather(_gather(cols, logits, -1))
