"""Scatter-add of a node-sorted slot stream: the scale decoder's table
gradients, on the segmented-sum kernel of ``csrc/spmm.cu``.

Replaces the Pallas TPU kernel ``_seq_scatter_kernel`` of
``dream_gnn_tpu/kernels/pallas_seq_scatter.py`` (``seq_scatter``)::

    out[n] = sum over the slots k with node_of_slot[k] = n of val_k * x[k]

for a stream of slots sorted by node (kernels/scale_decoder.py emits its
da1 rows in drug- and in disease-sorted slot order).  Each node's slots are
one contiguous run, so the layout is per-node offsets into the stream plus
the slot weights: no gather and no atomics.  The TPU kernel's batching
(``SEQ_BATCH``/``SEQ_TILE``), its clamped-window masking (:108-134) and its
stub batches are TPU geometry with no counterpart here.

Padding slots (``live`` False) keep their place in the stream and get weight
0.  In bf16 mode a message is rnd(rnd(x) * rnd(val)) summed in f32, as the
Pallas kernel multiplies in bf16 (:170-183); in fp32 mode x * val.  A
stream without padding whose slots all weigh 1 (the scale decoder's, whose
candidate lists have no padding slots) carries no ``val``: the kernel then
reads no weights, and its messages rnd(x) are the same bits as with val 1.

Dispatch.  ``seq_scatter`` launches the kernel for CUDA tensors and runs
the plain version only for CPU tensors; ``LAUNCHES`` counts the launches.
Not differentiable: it is a backward-pass primitive.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.csr import SegmentPieces, segment_pieces
from dream_gnn_tpu_torch.kernels.grid_decoder import round_to
from dream_gnn_tpu_torch.kernels.spmm_slab import (launch_segment_sum,
                                                    segment_sum_plain)
from dream_gnn_tpu_torch.utils.device import as_tensor

LAUNCHES = {"seq_scatter": 0}


@dataclasses.dataclass(frozen=True)
class SeqScatter:
    """The slots of node n are ``offsets[n] .. offsets[n+1]-1`` of the
    stream (int32); ``val`` is each slot's weight, 0 on padding slots, or
    None when every slot weighs 1; ``pieces`` cut the nodes' runs for the
    kernel at a width that is not a multiple of 8."""

    offsets: torch.Tensor             # (n_dst + 1,) int32
    val: Optional[torch.Tensor]       # (n_slots,) f32, or None
    n_dst: int
    n_slots: int
    pieces: SegmentPieces


def build_seq_scatter(node_of_slot, live, val, n_dst: int,
                      device=None) -> SeqScatter:
    """Layout of a node-sorted slot stream (pallas_seq_scatter.py:76-141):
    ``node_of_slot`` ascends over the live slots; padding slots take the
    node of the live slot before them, so that every node's slots stay one
    run.  ``live`` None: every slot is live; ``val`` None: every live slot
    weighs 1 (and with ``live`` None too, the layout has no weights)."""
    node = as_tensor(node_of_slot, torch.int64, device)
    n = node.shape[0]
    filled = node
    if val is not None:
        val = as_tensor(val, torch.float32, node.device)
    if live is not None:
        live = as_tensor(live, torch.bool, node.device)
        idx = torch.where(live, torch.arange(n, device=node.device), -1)
        idx = torch.cummax(idx, 0).values
        filled = torch.where(idx >= 0, node[idx.clamp_min(0)], 0)
        val = torch.where(live, 1.0 if val is None else val, 0.0)
    if n and (bool((filled[1:] < filled[:-1]).any()) or int(filled[0]) < 0
              or int(filled[-1]) >= n_dst):
        raise ValueError("build_seq_scatter: the live slots' nodes must "
                         f"ascend and lie in [0, {n_dst})")
    offsets = torch.searchsorted(
        filled, torch.arange(n_dst + 1, device=node.device))
    offsets = offsets.int()
    return SeqScatter(offsets=offsets,
                      val=None if val is None else val.float().contiguous(),
                      n_dst=n_dst, n_slots=n, pieces=segment_pieces(offsets))


def seq_scatter(g: SeqScatter, x: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """(n_dst, d) f32 scatter-add of the slot stream x (n_slots, d), bf16
    or f32; the contract of the JAX ``seq_scatter``
    (pallas_seq_scatter.py:186)."""
    if x.dim() != 2 or x.shape[0] != g.n_slots:
        raise ValueError(f"seq_scatter: x must be ({g.n_slots}, d), got "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"seq_scatter: dtype {dtype} unsupported")
    rounded = dtype == torch.bfloat16
    val = None if g.val is None else round_to(g.val, dtype).contiguous()
    x = x.contiguous()
    if x.is_cuda:
        out = launch_segment_sum(g.offsets, None, val, x, rounded,
                                 pieces=g.pieces)
        LAUNCHES["seq_scatter"] += 1
        return out
    return segment_sum_plain(g.offsets, None, val, x, rounded)
