"""Carry model parameters from the JAX package into the port.

``params_from_jax`` takes the JAX param tree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
param tree: the same keys (``tgcn[i]``, ``fgcn``, ``attention``,
``decoder``; dream_gnn_tpu/model/dream_gnn.py:82-92) and the same
(in, out) weight layout, as f32 tensors.  It imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)
