"""GCMC layer: relation-typed bipartite graph convolution, dense layout.

Port of the dense branch of ``dream_gnn_tpu/nn/gcmc.py`` (reference
``GCMCLayer`` + ``GCMCGraphConv``, layers.py:18-236).  Per rating r and
direction: ``feat @ W_r``, times a *node-dropped* source norm
``dropout(cj)`` (layers.py:224-225), aggregation over the dense
adjacency mask (one matrix product), then the dst norm ``ci``.  Outputs
are summed over relations ('sum' accumulation), activated, dropped out
and projected by a shared Linear (layers.py:133-141).

Weight parity notes:
- basis decomposition ``W = att @ basis`` ties the relations' weights
  (layers.py:70-71,120-121); the reverse direction reuses the forward
  ``W[r]`` (layers.py:126-127);
- under ``share_param`` the drug/disease output projections are one
  module (``ufc is ifc``, layers.py:61-64).

The COO, grouped, slabbed and sharded layouts are still to be ported
(ROADMAP.md queue A, items 7, 8 and 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.dropout import dropout
from dream_gnn_tpu_torch.utils.activations import get_activation


def gcmc_layer_init(gen, *, in_units: int, msg_units: int, out_units: int,
                    num_ratings: int = 2, basis_units: int = 2,
                    share_param: bool = True):
    """Init one GCMC layer's params: xavier for every >1-dim weight,
    Linear biases with the torch default U(+-1/sqrt(fan_in))."""
    params = {
        "att": init_lib.xavier_uniform(gen, (num_ratings, basis_units)),
        "basis": init_lib.xavier_uniform(
            gen, (basis_units, in_units, msg_units)),
        "fc_w": init_lib.xavier_linear(gen, msg_units, out_units),
        "fc_b": init_lib.torch_linear(gen, msg_units, out_units)[1],
    }
    if not share_param:
        params["ifc_w"] = init_lib.xavier_linear(gen, msg_units, out_units)
        params["ifc_b"] = init_lib.torch_linear(gen, msg_units, out_units)[1]
        # Non-shared convs own per-(rating, direction) weights
        # (layers.py:86-97) instead of the basis decomposition.
        params["conv_w"] = init_lib.xavier_uniform(
            gen, (num_ratings, 2, in_units, msg_units))
    return params


def _relation_weights(params, num_ratings: int, share_param: bool):
    if share_param:
        basis = params["basis"]
        b, in_units, msg_units = basis.shape
        w = torch.matmul(params["att"], basis.reshape(b, -1))
        w = w.reshape(num_ratings, in_units, msg_units)
        return w, w  # same W for forward and reverse etypes
    return params["conv_w"][:, 0], params["conv_w"][:, 1]


def gcmc_layer_apply(params, graph: BipartiteGraph,
                     drug_feat: torch.Tensor, dis_feat: torch.Tensor, *,
                     dropout_rate: float, agg_act: str = "leaky",
                     share_param: bool = True, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     edge_masks=None):
    """One GCMC layer forward.

    Args:
      edge_masks: optional dict with 'fwd'/'rev' tensors of shape
        (R, n_drug, n_dis) — per-etype edge keep-masks from augmentation.
        The graph's ci/cj stay *stale* by construction (parity trap,
        SURVEY.md §7.3.3).
    Returns (drug_out, dis_out), each (N, out_units).
    """
    if not isinstance(graph, BipartiteGraph):
        raise NotImplementedError(
            f"encoder layout {type(graph).__name__} is not ported yet "
            f"(ROADMAP.md queue A, items 7, 8 and 10)")
    if edge_masks is not None and "fwd_add" in edge_masks:
        raise NotImplementedError(
            "add_random_edges masks are not ported yet (ROADMAP.md queue A, "
            "item 4: the other augment methods)")
    num_ratings = params["att"].shape[0]
    act = get_activation(agg_act)
    w_fwd, w_rev = _relation_weights(params, num_ratings, share_param)

    adjs = [graph.a0(), graph.a1]  # rating order = rating_vals [0, 1]
    msg_dis = 0.0
    msg_drug = 0.0
    for r in range(num_ratings):
        # drug -> disease (etype str(r)): node-dropout on the src norm cj
        # (layers.py:224-225), fresh mask per (rating, direction).
        cj_d = graph.cj_drug
        cj_v = graph.cj_dis
        if train:
            cj_d = dropout(generator, cj_d, dropout_rate, train)
            cj_v = dropout(generator, cj_v, dropout_rate, train)
        hd = torch.matmul(drug_feat, w_fwd[r])
        hv = torch.matmul(dis_feat, w_rev[r])
        a_f = adjs[r] if edge_masks is None else adjs[r] * edge_masks["fwd"][r]
        a_r = adjs[r] if edge_masks is None else adjs[r] * edge_masks["rev"][r]
        msg_dis = msg_dis + torch.matmul(a_f.T, hd * cj_d)
        # disease -> drug (etype rev-r) reuses W[r] (layers.py:126-127)
        msg_drug = msg_drug + torch.matmul(a_r, hv * cj_v)

    drug_h = act(msg_drug * graph.ci_drug)
    dis_h = act(msg_dis * graph.ci_dis)
    if train:
        drug_h = dropout(generator, drug_h, dropout_rate, train)
        dis_h = dropout(generator, dis_h, dropout_rate, train)

    # Output projections: drug through ifc, disease through ufc; one
    # shared module under share_param (layers.py:61-64,140-141).
    if share_param:
        drug_out = drug_h @ params["fc_w"] + params["fc_b"]
        dis_out = dis_h @ params["fc_w"] + params["fc_b"]
    else:
        drug_out = drug_h @ params["ifc_w"] + params["ifc_b"]
        dis_out = dis_h @ params["fc_w"] + params["fc_b"]
    return drug_out, dis_out
