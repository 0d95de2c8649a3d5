"""The encoder graph of the single-device scale path, in a GPU layout.

Port of ``dream_gnn_tpu/graph/slabbed.py``, with its builder entry points
and their arguments.  The JAX package streams each relation through the
TPU in slabs, panels and windows sized to the TPU's scoped VMEM
(slabbed.py:52-106); that geometry has no counterpart on the card, and the
geometry arguments (``tile``, ``span``, ``window``, ``cs``, ``k``, ``d``)
are accepted and unused.  Here each relation and direction is a CSR
ordering of its edges by destination:

    row_ptr (n_dst + 1,)   the slots of dst row n are row_ptr[n] .. row_ptr[n+1]-1
    src     (n_live,)      source node of each slot
    val     (n_live,)      edge weight
    edge_id (n_live,)      the edge's index among the relation's live input edges

Within a row the slots keep the input order (a stable sort), so a sum over
a row runs in a fixed order.  As in the JAX builder, zero-weight input
edges are dropped first and ``edge_id`` counts the remaining ones
(slabbed.py:176-181), so the forward layout and its transposed partner of a
``SlabbedCooPair`` carry the same ids, and the PRF edge dropout
(augment/masks.py:prf_mask_pair) drops the same edges in both.

Everything is built with torch ops on the target device: stable sorts and
a bincount, no host loop over edges.
"""

from __future__ import annotations

import dataclasses

import torch

from dream_gnn_tpu_torch.graph.norms import inv_sqrt_norm
from dream_gnn_tpu_torch.utils.device import as_tensor


@dataclasses.dataclass(frozen=True)
class SlabbedCoo:
    """One direction of one relation: a dst-sorted CSR (see the module
    doc).  Indices are int32."""

    row_ptr: torch.Tensor
    src: torch.Tensor
    val: torch.Tensor
    edge_id: torch.Tensor
    n_src: int
    n_dst: int

    @property
    def n_live(self) -> int:
        return self.src.shape[0]


@dataclasses.dataclass(frozen=True)
class SlabbedCooPair:
    """A relation's forward layout and its transpose (the backward's)."""

    fwd: SlabbedCoo
    bwd: SlabbedCoo


def _check_ids(ids: torch.Tensor, n: int, name: str) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{name} ids must lie in [0, {n})")


def slabbed_from_arrays(src, dst, val, n_src: int, n_dst: int,
                        tile=None, span=None, window=None, cs=None, k=None,
                        d: int = 128, device=None) -> SlabbedCoo:
    """The dst-sorted CSR of edges (src, dst, val); zero-weight edges are
    dropped.  The geometry arguments are the JAX signature's and unused."""
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
    return SlabbedCoo(row_ptr=row_ptr.int(), src=src[order].int(),
                      val=val[order].contiguous(), edge_id=order.int(),
                      n_src=n_src, n_dst=n_dst)


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
    pairs = as_tensor(pairs, torch.int64, device)
    values = as_tensor(values, torch.int64, pairs.device)
    fwd, rev = [], []
    for r in ratings:
        idx = values == r
        dr, di = pairs[0][idx], pairs[1][idx]
        ones = torch.ones(dr.shape[0], dtype=torch.float32, device=dr.device)
        fwd.append(slabbed_pair_from_arrays(dr, di, ones, n_drug, n_dis))
        rev.append(slabbed_pair_from_arrays(di, dr, ones, n_dis, n_drug))

    def norm(ids, n):
        deg = torch.bincount(ids, minlength=n).to(torch.float32).cpu().numpy()
        return torch.from_numpy(inv_sqrt_norm(deg)).to(pairs.device)

    ci_drug, ci_dis = norm(pairs[0], n_drug), norm(pairs[1], n_dis)
    cj_drug = ci_drug if symm else torch.ones_like(ci_drug)
    cj_dis = ci_dis if symm else torch.ones_like(ci_dis)
    return BipartiteSlabbed(fwd=tuple(fwd), rev=tuple(rev), ci_drug=ci_drug,
                            cj_drug=cj_drug, ci_dis=ci_dis, cj_dis=cj_dis)
