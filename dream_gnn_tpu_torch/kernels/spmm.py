"""Aggregation over the dense (a matrix, or ``NormAdj``) and padded-COO
(``CooGraph``) graph layouts.

Port of ``dream_gnn_tpu/kernels/spmm.py``, one contract for all:
``out[d] = sum_e val_e * x[src_e]``.  The reference's graphs (hundreds of
nodes) are stored dense, so the aggregation is one matrix product; the COO
layout (the scale path's identity graphs, and the padded-COO encoder of
graph/bipartite_coo.py) is a weighted segment sum.  The JAX package leaves
both to XLA (``jnp.dot``, ``segment_sum``), and the port to plain PyTorch
(``torch.matmul``, ``index_add``).  The slabbed, grouped and blocked
encoder layouts have kernels of their own (kernels/spmm_slab.py,
kernels/spmm_gather.py, kernels/spmm_blocked.py).
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
    """Layout-dispatching aggregation: a ``CooGraph``, a ``NormAdj``, or a
    plain (n_dst, n_src) matrix, as the JAX ``spmm`` (spmm.py:51-57)."""
    if isinstance(g, CooGraph):
        return spmm_coo(g, x)
    if isinstance(g, NormAdj):
        return spmm_dense(g.a, x)
    return spmm_dense(g, x)
