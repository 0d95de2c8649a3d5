"""Route-fusion attention (reference ``Attention``, layers.py:324-338).

One shared module fuses the GCMC (topology) and FGCN (feature) routes
per node: project to a scalar via Linear(d,16) -> tanh -> Linear(16,1,
no bias), softmax over the route axis, dropout **on the attention
weights** (parity quirk), weighted sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.dropout import dropout


def attention_init(gen, *, in_size: int, hidden_size: int = 16):
    w1, b1 = init_lib.torch_linear(gen, in_size, hidden_size)
    w2, _ = init_lib.torch_linear(gen, hidden_size, 1, bias=False)
    return {"w1": w1, "b1": b1, "w2": w2}


def attention_apply(params, z: torch.Tensor, *, dropout_rate: float,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None):
    """z: (..., N, routes, d) -> fused (..., N, d), beta (..., N, routes, 1).

    A leading fold axis on ``z`` and the params batches over folds: the
    projection runs over the flattened (N * routes) rows of each fold."""
    n, routes = z.shape[-3:-1]
    h = torch.tanh(z.flatten(-3, -2) @ params["w1"]
                   + params["b1"][..., None, :])
    w = (h @ params["w2"]).unflatten(-2, (n, routes))
    beta = torch.softmax(w, dim=-2)
    if train:
        beta = dropout(generator, beta, dropout_rate, train)
    return torch.sum(beta * z, dim=-2), beta
