"""The numeric core of the embedding pipeline (reference embedding.py).

Port of ``combine_embeddings`` and ``fuzzy_name_map`` of
``dream_gnn_tpu/data/embedding.py``.  Its ChemBERTa, BioBERT and ESM-2
encoders need model weights from outside the repository and are not
ported.

``combine_embeddings`` needs a PCA without sklearn: an exact SVD of the
centred stack in float64, each component's sign fixed as sklearn's
``svd_flip(u_based_decision=False)`` fixes it (the entry of largest
magnitude in each row of Vt is positive).  The port is exact at every size.
sklearn's ``PCA(svd_solver="auto")``, which the JAX package calls, is exact
where it picks its "full" or "covariance_eigh" solver; where it picks
"randomized" (max(shape) > 500 and n_components < 0.8 * min(shape), as at
Gdataset's 593 drugs x 768-1280 widths) it draws with no fixed
random_state, so the JAX result is not reproducible there.
"""

from __future__ import annotations

import difflib
from typing import Dict, List, Optional, Sequence

import numpy as np


def pca_transform(x: np.ndarray, n_components: int) -> np.ndarray:
    """The first ``n_components`` principal components' scores of ``x``
    (rows are samples), by an exact SVD of the centred matrix in float64,
    with sklearn's sign convention."""
    xc = np.asarray(x, np.float64)
    xc = xc - xc.mean(axis=0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    signs[signs == 0] = 1.0
    return (u * s * signs)[:, :n_components]


def combine_embeddings(parts: Sequence[np.ndarray],
                       target_dim: int = 768) -> np.ndarray:
    """Pad embedding spaces to a common width, stack, joint-PCA to
    ``target_dim`` (embedding.py:107-198).

    With fewer samples than components, the PCA yields rank < target_dim;
    the missing columns are zero-padded (the reference's fallback)."""
    parts = [np.asarray(p, np.float64) for p in parts]
    width = max(p.shape[1] for p in parts)
    padded = [np.pad(p, ((0, 0), (0, width - p.shape[1]))) for p in parts]
    stacked = np.concatenate(padded, axis=0)

    if width <= target_dim and len(parts) == 1:
        out = np.pad(stacked, ((0, 0), (0, target_dim - width)))
        return out.astype(np.float32)

    n_comp = min(target_dim, stacked.shape[0], stacked.shape[1])
    reduced = pca_transform(stacked, n_comp)
    if n_comp < target_dim:
        reduced = np.pad(reduced, ((0, 0), (0, target_dim - n_comp)))
    return reduced.astype(np.float32)


def fuzzy_name_map(names: Sequence[str], candidates: Dict[str, str],
                   cutoff: float = 0.8) -> Dict[str, Optional[str]]:
    """Fuzzy drug-name -> DrugBank-ID mapping (embedding.py:341-358):
    difflib best match with ratio >= cutoff."""
    keys: List[str] = list(candidates)
    lowered = [k.lower() for k in keys]
    out: Dict[str, Optional[str]] = {}
    for name in names:
        match = difflib.get_close_matches(name.lower(), lowered, n=1,
                                          cutoff=cutoff)
        out[name] = candidates[keys[lowered.index(match[0])]] if match \
            else None
    return out
