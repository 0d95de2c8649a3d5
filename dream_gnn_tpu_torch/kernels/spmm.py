"""Aggregation over the dense graph layout (``NormAdj``).

Port of the dense branch of ``dream_gnn_tpu/kernels/spmm.py``.  The
reference's graphs (hundreds of nodes) are stored dense, so the
aggregation ``out[d] = sum_s a[d, s] * x[s]`` is one matrix product; the
JAX package leaves it to XLA and the port to ``torch.matmul``.  The COO
layout is still to be ported (ROADMAP.md queue A, item 7).
"""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.graph.knn import NormAdj


def spmm_dense(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dense aggregation: ``a`` (n_dst, n_src) @ ``x`` (n_src, d)."""
    return torch.matmul(a, x)


def spmm(g: NormAdj, x: torch.Tensor) -> torch.Tensor:
    """Layout-dispatching aggregation (the dense layout only)."""
    if isinstance(g, NormAdj):
        return spmm_dense(g.a, x)
    raise NotImplementedError(
        f"graph layout {type(g).__name__} is not ported yet (ROADMAP.md "
        f"queue A, item 7: the sparse COO encoder)")
