"""Edge-partitioned SpMM across ranks.

Port of ``dream_gnn_tpu/sharding/edge_partition.py``.  For graphs too
large for one device, destination nodes are partitioned into contiguous
shards of ``ceil(n_dst / S)`` rows, each rank owns the edge block whose
destinations are its rows, and source-node features are exchanged before
the local segment sum: the halo exchange, an all-gather whose backward is
a reduce-scatter (sharding/collectives.py).

``shard_coo_by_dst`` plans every shard, the same way on every rank from the
same arrays; ``put_sharded_coo`` keeps this rank's block on its device.
Blocks are padded to a common ``E_shard`` (a multiple of ``pad_multiple``)
with zero-weight edges, as in JAX.  Each edge also carries ``edge_id``, its
index among the relation's live edges, so that an edge-dropout mask drawn
over the whole relation gives every rank count the same masks
(augment/masks.py, ``edge_dropout_masks_sharded``); padding edges carry 0.

The local aggregation is a weighted ``index_add``, as the JAX package leaves
it to XLA's ``segment_sum``: no kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dream_gnn_tpu_torch.graph.coo import CooGraph
from dream_gnn_tpu_torch.sharding.collectives import (all_gather_rows,
                                                       replicated_in)


@dataclasses.dataclass(frozen=True)
class ShardedCoo:
    """Dst-partitioned COO.  As planned (``shard`` None) every tensor is
    (S, E_shard) on the host; as placed, this rank's (E_shard,) block on
    its device.  ``dst_local`` is the destination within the shard's rows
    [shard * rows_per_shard, ...)."""

    src: torch.Tensor          # int32
    dst_local: torch.Tensor    # int32
    val: torch.Tensor          # float32 (0 = padding)
    edge_id: torch.Tensor      # int64, index among the relation's live edges
    n_live: int                # the relation's live edges, all shards
    n_src: int
    n_dst: int
    rows_per_shard: int
    n_shards: int
    shard: Optional[int] = None


def shard_coo_by_dst(g: CooGraph, n_shards: int,
                     pad_multiple: int = 512) -> ShardedCoo:
    """Partition a dst-sorted CooGraph into contiguous dst ranges
    (edge_partition.py:52-80 of the JAX package)."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    val = g.val.cpu().numpy()
    live = val != 0
    src, dst, val = src[live], dst[live], val[live]
    eid = np.arange(src.shape[0], dtype=np.int64)

    rows_per_shard = -(-g.n_dst // n_shards)
    shard_of = dst // rows_per_shard
    order = np.argsort(shard_of, kind="stable")
    src, dst, val, eid, shard_of = (src[order], dst[order], val[order],
                                    eid[order], shard_of[order])

    counts = np.bincount(shard_of, minlength=n_shards)
    e_shard = -(-max(int(counts.max()), 1) // pad_multiple) * pad_multiple
    s_src = np.zeros((n_shards, e_shard), np.int32)
    s_dst = np.zeros((n_shards, e_shard), np.int32)
    s_val = np.zeros((n_shards, e_shard), np.float32)
    s_eid = np.zeros((n_shards, e_shard), np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        a, b = offsets[s], offsets[s + 1]
        s_src[s, : b - a] = src[a:b]
        s_dst[s, : b - a] = dst[a:b] - s * rows_per_shard
        s_val[s, : b - a] = val[a:b]
        s_eid[s, : b - a] = eid[a:b]
    return ShardedCoo(src=torch.from_numpy(s_src),
                      dst_local=torch.from_numpy(s_dst),
                      val=torch.from_numpy(s_val),
                      edge_id=torch.from_numpy(s_eid),
                      n_live=int(src.shape[0]), n_src=g.n_src,
                      n_dst=g.n_dst, rows_per_shard=rows_per_shard,
                      n_shards=n_shards)


def put_sharded_coo(mesh, axis: str, g: ShardedCoo, device) -> ShardedCoo:
    """This rank's block of a planned ShardedCoo, on ``device``."""
    if mesh.shape[axis] != g.n_shards:
        raise ValueError(f"a {g.n_shards}-shard plan on a mesh axis of "
                         f"{mesh.shape[axis]} ranks")
    s = mesh.index(axis)
    return dataclasses.replace(
        g, src=g.src[s].to(device), dst_local=g.dst_local[s].to(device),
        val=g.val[s].to(device), edge_id=g.edge_id[s].to(device), shard=s)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if x.shape[0] > rows:
        raise ValueError(f"a block of {x.shape[0]} rows exceeds {rows}")
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


def spmm_sharded(mesh, axis: str, g: ShardedCoo, x: torch.Tensor,
                 x_sharded: bool = True) -> torch.Tensor:
    """This rank's block of out[d] = sum val_e * x[src_e], (rows_per_shard,
    d) f32 (edge_partition.py:91-124 of the JAX package; trailing pad rows
    are zero).

    Args:
      x: with ``x_sharded``, this rank's block of source rows (at most
        ceil(n_src / S), zero-padded to it), all-gathered into the whole
        padded x (the halo exchange); otherwise the replicated (n_src, d)
        x, whose cotangent each rank holds a part of.
    """
    if g.shard is None:
        raise ValueError("spmm_sharded takes a placed ShardedCoo "
                         "(put_sharded_coo)")
    group = mesh.group(axis)
    if x_sharded:
        x_full = all_gather_rows(pad_rows(x, -(-g.n_src // g.n_shards)),
                                 group)
    else:
        x_full = replicated_in(x, group)
    msg = x_full[g.src.long()] * g.val[:, None]
    out = torch.zeros((g.rows_per_shard, x.shape[1]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add(0, g.dst_local.long(), msg)
