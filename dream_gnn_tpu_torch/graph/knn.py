"""kNN similarity graphs for the FGCN route.

Reference construction (data_loader.py:278-344):
  1. top-k per row via ``argpartition`` on the similarity matrix
     (self-similarity is usually 1.0, so the self edge is in the top-k);
  2. symmetrise ``A + A^T`` and keep positive values — entries become
     1.0 or 2.0 (mutual neighbours), and those *values matter*;
  3. add the identity, row-normalise ``D^-1 (A + I)`` (utils.py:11-17).

The feature-similarity variant (data_loader.py:312-344) first builds a
cosine-similarity matrix from L2-normalised embeddings.

The construction is host numpy, as in the JAX package; the normalised
adjacency of these small fixed graphs is stored dense on the device, so
the FGCN aggregation is one matrix product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NormAdj:
    """Row-normalised weighted adjacency, dense layout: (N, N) float."""

    a: torch.Tensor

    @property
    def n(self) -> int:
        return self.a.shape[-1]


def _knn_adjacency(sim_matrix: np.ndarray, k: int, symm: bool) -> np.ndarray:
    """Steps 1-2 above: binary top-k adjacency, symmetrised with values."""
    sim_matrix = np.asarray(sim_matrix, np.float64)
    n = sim_matrix.shape[0]
    k_actual = min(k, n - 1)
    neighbor = np.argpartition(-sim_matrix, kth=k_actual, axis=1)[:, :k_actual]
    adj = np.zeros((n, n), np.float32)
    adj[np.repeat(np.arange(n), k_actual), neighbor.reshape(-1)] = 1.0
    if symm:
        adj = adj + adj.T       # values 1.0 / 2.0, all positive -> kept as-is
    return adj


def row_normalize(a: np.ndarray) -> np.ndarray:
    """D^-1 A with zero rows left zero (reference utils.py:11-17)."""
    rowsum = a.sum(axis=1)
    inv = np.zeros_like(rowsum)
    nz = rowsum != 0
    inv[nz] = 1.0 / rowsum[nz]
    return (a * inv[:, None]).astype(np.float32)


def knn_sim_graph(sim_matrix: np.ndarray, k: int, symm: bool = True, *,
                  device="cuda") -> NormAdj:
    """Reference ``_create_similarity_graph`` (data_loader.py:278-310)."""
    adj = _knn_adjacency(sim_matrix, k, symm)
    adj = adj + np.eye(adj.shape[0], dtype=np.float32)
    return NormAdj(a=torch.as_tensor(row_normalize(adj), device=device))


def feature_knn_graph(features: np.ndarray, k: int, symm: bool = True, *,
                      device="cuda") -> NormAdj:
    """Reference ``_create_feature_similarity_graph`` (data_loader.py:312-344).

    Cosine similarity of row-normalised features, then the same kNN path.
    """
    features = np.asarray(features, np.float64)
    if features.ndim > 1:
        norms = np.linalg.norm(features, axis=1, keepdims=True)
        norms[norms == 0] = 1e-10
        nf = features / norms
        sim = nf @ nf.T
    else:
        sim = features
    return knn_sim_graph(sim, k, symm, device=device)
