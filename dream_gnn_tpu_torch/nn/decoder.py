"""MLP decoder (reference ``MLPDecoder``, layers.py:341-379): init and the
plain decoders, per edge and over the dense grid.

The reference runs a 256 -> 128 -> 64 -> 1 MLP on ``concat(src_h,
dst_h)`` per candidate edge and emits **logits** (its Sigmoid member is
never applied, layers.py:347).  The first Linear splits across the
concat — ``lin1(concat(u, v)) = u @ W1[:d] + v @ W1[d:] + b1`` — so the
decoders gather rows of two node projections per candidate edge
(``decoder_apply``) or score every (drug, disease) cell from their outer
sum (``decoder_apply_grid``), with out-of-fold cells masked by the loss
and metric weights.

Both are the plain references of ``dream_gnn_tpu/nn/decoder.py`` and run
for ``decoder_backend='xla'``; the 'pallas' backend runs the fused
kernels (kernels/edge_decoder.py, kernels/grid_decoder.py).  Matrix
operands round to ``dtype`` with f32 accumulation; dropout draws from the
generator.  Params, features and edge lists may carry a leading fold axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.kernels.grid_decoder import (node_projections,
                                                     round_to)
from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.dropout import dropout


def decoder_init(gen, *, in_units: int, hidden1: int = 128,
                 hidden2: int = 64):
    w1, b1 = init_lib.torch_linear(gen, 2 * in_units, hidden1)
    w2, b2 = init_lib.torch_linear(gen, hidden1, hidden2)
    w3, b3 = init_lib.torch_linear(gen, hidden2, 1)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}


def decoder_apply(params, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                  drug_feat: torch.Tensor, dis_feat: torch.Tensor, *,
                  dropout_rate: float, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """Score candidate edges: edge_src (..., E) drug ids, edge_dst (..., E)
    disease ids, in candidate-pair order.  Returns (..., E) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    h = torch.relu(
        torch.take_along_dim(proj_drug, edge_src.long()[..., None], dim=-2)
        + torch.take_along_dim(proj_dis, edge_dst.long()[..., None], dim=-2)
        + params["b1"][..., None, :])
    if train:
        h = dropout(generator, h, dropout_rate, train)
    h = torch.relu(torch.matmul(round_to(h, dtype),
                                round_to(params["w2"], dtype))
                   + params["b2"][..., None, :])
    if train:
        h = dropout(generator, h, dropout_rate, train)
    out = torch.matmul(round_to(h, dtype), round_to(params["w3"], dtype)) \
        + params["b3"][..., None, :]
    return out[..., 0]


def decoder_apply_grid(params, drug_feat: torch.Tensor,
                       dis_feat: torch.Tensor, *, dropout_rate: float,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Score EVERY (drug, disease) cell; returns (..., n_drug, n_disease)
    logits.  Matrix operands round to ``dtype`` with f32 accumulation.
    Params and features may carry a leading fold axis; the per-cell
    products run over each fold's flattened grid."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    nd, nv = proj_drug.shape[-2], proj_dis.shape[-2]
    h = torch.relu(proj_drug[..., :, None, :] + proj_dis[..., None, :, :]
                   + params["b1"][..., None, None, :])
    if train:
        h = dropout(generator, h, dropout_rate, train)
    h = h.flatten(-3, -2)
    h = torch.relu(torch.matmul(round_to(h, dtype),
                                round_to(params["w2"], dtype))
                   + params["b2"][..., None, :])
    if train:
        h = dropout(generator, h, dropout_rate, train)
    out = torch.matmul(round_to(h, dtype), round_to(params["w3"], dtype)) \
        + params["b3"][..., None, :]
    return out[..., 0].unflatten(-1, (nd, nv))
