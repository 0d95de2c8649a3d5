"""Aggregation over the dense (``NormAdj``) and padded-COO (``CooGraph``)
graph layouts.

Port of ``dream_gnn_tpu/kernels/spmm.py``, one contract for both:
``out[d] = sum_e val_e * x[src_e]``.  The reference's graphs (hundreds of
nodes) are stored dense, so the aggregation is one matrix product; the COO
layout is a weighted segment sum.  The JAX package leaves both to XLA
(``jnp.dot``, ``segment_sum``), and the port to plain PyTorch
(``torch.matmul``, ``index_add``).  The scale path's encoder SpMM is a
kernel of its own (kernels/spmm_slab.py).
"""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.graph.coo import CooGraph
from dream_gnn_tpu_torch.graph.knn import NormAdj


def spmm_dense(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense aggregation: ``a`` (n_dst, n_src) @ ``x`` (n_src, d)."""
    return torch.matmul(a, x)


def spmm_coo(g: CooGraph, x: torch.Tensor) -> torch.Tensor:
    """Padded-COO aggregation as a weighted segment sum (spmm.py:39-48 of
    the JAX package); padding edges carry ``val == 0``."""
    msg = x[g.src] * g.val[:, None]
    out = torch.zeros((g.n_dst, x.shape[1]), dtype=msg.dtype, device=x.device)
    return out.index_add(0, g.dst, msg)


def spmm(g, x: torch.Tensor) -> torch.Tensor:
    """Layout-dispatching aggregation."""
    if isinstance(g, CooGraph):
        return spmm_coo(g, x)
    if isinstance(g, NormAdj):
        return spmm_dense(g.a, x)
    raise NotImplementedError(
        f"graph layout {type(g).__name__} is not ported yet (ROADMAP.md "
        f"queue A, item 8: the grouped and blocked layouts)")
