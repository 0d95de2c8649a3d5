"""Parameter initialisers matching the reference's *distributions*.

Port of ``dream_gnn_tpu/nn/init.py``: the same distributions, drawn from
a ``torch.Generator``.  Metric parity needs matching init statistics,
not identical draws.  Three distributions appear in the reference:

- ``xavier_uniform`` — GCMC att/basis/fc weights (layers.py:112-115);
- torch ``nn.Linear`` default — U(+-1/sqrt(fan_in)) for weight and bias
  (attention / decoder / fusion linears);
- U(+-1/sqrt(out_features)) — ``GraphConvolution`` weight & bias
  (layers.py:300-304).

All weights use the (in, out) layout of the JAX package (``y = x @ w + b``).
"""

from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return (u * 2.0 - 1.0) * bound


def xavier_uniform(gen, shape) -> torch.Tensor:
    """torch ``xavier_uniform_`` fans: for ndim>2, fan_in/out use
    dims[1]/dims[0] times the trailing receptive field."""
    if len(shape) < 2:
        raise ValueError("xavier needs >=2 dims")
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    return uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def xavier_linear(gen, in_features, out_features) -> torch.Tensor:
    """(in, out) weight with xavier bounds (symmetric in fan order)."""
    bound = math.sqrt(6.0 / (in_features + out_features))
    return uniform(gen, (in_features, out_features), bound)


def torch_linear(gen, in_features, out_features, bias=True):
    """torch ``nn.Linear`` default init: U(+-1/sqrt(fan_in)) for both."""
    bound = 1.0 / math.sqrt(in_features)
    w = uniform(gen, (in_features, out_features), bound)
    return w, (uniform(gen, (out_features,), bound) if bias else None)


def gcn_linear(gen, in_features, out_features, bias=True):
    """Reference ``GraphConvolution.reset_parameters``: U(+-1/sqrt(out))."""
    bound = 1.0 / math.sqrt(out_features)
    w = uniform(gen, (in_features, out_features), bound)
    return w, (uniform(gen, (out_features,), bound) if bias else None)
