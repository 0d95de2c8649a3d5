"""Shared degree-normalisation helper.

One home for the GCMC norm rule (data_loader.py:454-457): 1/sqrt(deg)
with zero-degree nodes mapped to 0 (the reference maps 0 -> inf ->
1/sqrt(inf) = 0), returned as an (N, 1) column.
"""

from __future__ import annotations

import numpy as np


def inv_sqrt_norm(deg: np.ndarray) -> np.ndarray:
    deg = np.asarray(deg, np.float32)
    out = np.zeros_like(deg)
    nz = deg > 0
    out[nz] = 1.0 / np.sqrt(deg[nz])
    return out[:, None]
