"""The GPU layout behind the port's sparse encoder layouts.

The JAX package lays each relation out three ways for three TPU kernels:
slabs (graph/slabbed.py), groups of 128 edges confined to source windows
(graph/grouped.py) and (dst tile, src tile) chunks (graph/blocked.py).  Each
geometry fits the TPU's VMEM and MXU; none has a counterpart on the card.
Here every one of them is the same thing, a CSR ordering of the relation's
edges by destination:

    row_ptr (n_dst + 1,)   the slots of dst row n are row_ptr[n] .. row_ptr[n+1]-1
    src     (n_live,)      source node of each slot
    val     (n_live,)      edge weight
    edge_id (n_live,)      the edge's index among the relation's live input edges

Within a row the slots keep the input order (a stable sort), so a sum over
a row runs in a fixed order.  As in every JAX builder, zero-weight input
edges are dropped first and ``edge_id`` counts the remaining ones, so the
forward layout and its transposed partner carry the same ids, and the PRF
edge dropout (augment/masks.py:prf_mask_pair) drops the same edges in both.
There are no padding slots.

Each layout also carries its rows cut into pieces (``SegmentPieces``), which
the segment sum of kernels/spmm_slab.py reads at a width that is not a
multiple of 8: one warp a piece, so that a row of thousands of entries is
summed by many warps.

Everything is built with torch ops on the target device: stable sorts and
a bincount, no host loop over edges.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from dream_gnn_tpu_torch.graph.norms import inv_sqrt_norm
from dream_gnn_tpu_torch.utils.device import as_tensor


PIECE = 128         # entries of a row a piece at most


@dataclasses.dataclass(frozen=True)
class SegmentPieces:
    """The rows of a CSR cut into pieces of at most ``k`` consecutive
    entries.  Each row's first piece, the whole of a row of at most k
    entries (an empty one too), writes the row's output; a longer (split)
    row's further pieces each write a partial row, and the row's partial
    rows are then added to its output in piece order.  Only the further
    pieces are listed, in row order.  Index tensors are int32."""

    extra_beg: torch.Tensor   # (n_extra,) first entry of each further piece
    extra_row: torch.Tensor   # (n_extra,) its row
    split_row: torch.Tensor   # (n_split,) the split rows, ascending
    split_ptr: torch.Tensor   # (n_split + 1,) each split row's further pieces
    k: int
    n_rows: int
    nnz: int
    n_split: int              # rows split
    n_extra: int              # further pieces: the partial rows

    @functools.cached_property
    def c_args(self) -> tuple:
        """The segment sum entry point's piece arguments (csrc/spmm.cu:
        struct Pieces) but the partial rows: extra_beg, extra_row, n_extra,
        split_row, split_ptr, n_split and k."""
        return (self.extra_beg.data_ptr(), self.extra_row.data_ptr(),
                self.n_extra, self.split_row.data_ptr(),
                self.split_ptr.data_ptr(), self.n_split, self.k)


def cut_runs(ptr: torch.Tensor, k: int):
    """(run, beg, tptr) int64 of the runs ``ptr[n] .. ptr[n+1]-1`` each cut
    into ceil(len / k) pieces of at most ``k`` consecutive positions: each
    piece's run, its first position (then ``ptr[-1]``), and each run's
    pieces."""
    ptr = ptr.long()
    n, dev = ptr.shape[0] - 1, ptr.device
    per = (ptr[1:] - ptr[:-1] + k - 1) // k
    tptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per, 0, out=tptr[1:])
    run = torch.repeat_interleave(torch.arange(n, device=dev), per)
    j = torch.arange(run.shape[0], device=dev) - tptr[run]
    return run, torch.cat([ptr[run] + j * k, ptr[-1:]]), tptr


def segment_pieces(row_ptr: torch.Tensor, k: int = PIECE) -> SegmentPieces:
    """The pieces of the rows of ``row_ptr`` (see ``SegmentPieces``)."""
    run, beg, tptr = cut_runs(row_ptr, k)
    extra = beg[:-1] != row_ptr.long()[run]
    per = tptr[1:] - tptr[:-1]
    split_row = torch.nonzero(per > 1).flatten()
    split_ptr = torch.zeros(split_row.shape[0] + 1, dtype=torch.int64,
                            device=run.device)
    torch.cumsum(per[split_row] - 1, 0, out=split_ptr[1:])
    extra_beg = beg[:-1][extra].int()
    return SegmentPieces(extra_beg=extra_beg, extra_row=run[extra].int(),
                         split_row=split_row.int(), split_ptr=split_ptr.int(),
                         k=k, n_rows=row_ptr.shape[0] - 1,
                         nnz=int(row_ptr[-1]), n_split=split_row.shape[0],
                         n_extra=extra_beg.shape[0])


@dataclasses.dataclass(frozen=True)
class CsrLayout:
    """One direction of one relation: a dst-sorted CSR (see the module
    doc) and its rows' pieces.  Indices are int32."""

    row_ptr: torch.Tensor
    src: torch.Tensor
    val: torch.Tensor
    edge_id: torch.Tensor
    n_src: int
    n_dst: int
    pieces: SegmentPieces

    @property
    def n_live(self) -> int:
        return self.src.shape[0]


def _check_ids(ids: torch.Tensor, n: int, name: str) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{name} ids must lie in [0, {n})")


def csr_fields(src, dst, val, n_src: int, n_dst: int, device=None) -> dict:
    """The fields of ``CsrLayout`` for edges (src, dst, val): the dst-sorted
    CSR of the edges whose weight is not zero, and its pieces."""
    val = as_tensor(val, torch.float32, device)
    src = as_tensor(src, torch.int64, val.device)
    dst = as_tensor(dst, torch.int64, val.device)
    live = val != 0
    src, dst, val = src[live], dst[live], val[live]
    _check_ids(src, n_src, "src")
    _check_ids(dst, n_dst, "dst")
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst, minlength=n_dst)
    row_ptr = torch.zeros(n_dst + 1, dtype=torch.int64, device=val.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return dict(row_ptr=row_ptr.int(), src=src[order].int(),
                val=val[order].contiguous(), edge_id=order.int(),
                n_src=n_src, n_dst=n_dst, pieces=segment_pieces(row_ptr))


def bipartite_relations(pairs, values, n_drug: int, n_dis: int,
                        pair_from_arrays, symm: bool = True, ratings=(0, 1),
                        device=None) -> dict:
    """The fields of a relation-typed bipartite encoder graph from (2, E)
    drug/disease ``pairs`` and their rating ``values``: per rating the
    drug -> disease (``fwd``) and disease -> drug (``rev``) layout pairs of
    ``pair_from_arrays(src, dst, val, n_src, n_dst)``, and the norms of the
    dense layout (degree summed over relations)."""
    pairs = as_tensor(pairs, torch.int64, device)
    values = as_tensor(values, torch.int64, pairs.device)
    fwd, rev = [], []
    for r in ratings:
        idx = values == r
        dr, di = pairs[0][idx], pairs[1][idx]
        ones = torch.ones(dr.shape[0], dtype=torch.float32, device=dr.device)
        fwd.append(pair_from_arrays(dr, di, ones, n_drug, n_dis))
        rev.append(pair_from_arrays(di, dr, ones, n_dis, n_drug))

    def norm(ids, n):
        deg = torch.bincount(ids, minlength=n).to(torch.float32).cpu().numpy()
        return torch.from_numpy(inv_sqrt_norm(deg)).to(pairs.device)

    ci_drug, ci_dis = norm(pairs[0], n_drug), norm(pairs[1], n_dis)
    cj_drug = ci_drug if symm else torch.ones_like(ci_drug)
    cj_dis = ci_dis if symm else torch.ones_like(ci_dis)
    return dict(fwd=tuple(fwd), rev=tuple(rev), ci_drug=ci_drug,
                cj_drug=cj_drug, ci_dis=ci_dis, cj_dis=cj_dis)
