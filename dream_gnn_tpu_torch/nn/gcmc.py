"""GCMC layer: relation-typed bipartite graph convolution.

Port of the dense and slabbed branches of ``dream_gnn_tpu/nn/gcmc.py``
(reference ``GCMCLayer`` + ``GCMCGraphConv``, layers.py:18-236).  Per rating
r and direction: ``feat @ W_r``, times a *node-dropped* source norm
``dropout(cj)`` (layers.py:224-225), aggregation over the graph, then the
dst norm ``ci``.  Outputs are summed over relations ('sum' accumulation),
activated, dropped out and projected by a shared Linear
(layers.py:133-141).

Aggregation by layout:
- dense (``BipartiteGraph``): one matrix product over the adjacency mask,
  times the per-etype edge keep masks of augmentation;
- slabbed (``BipartiteSlabbed``, the scale path): the SpMM kernel of
  kernels/spmm_slab.py over each relation's CSR layouts (gcmc.py:185-205 of
  the JAX package).  The PRF edge dropout is applied to the graph before
  the layer (augment/masks.py:prf_mask_graph, once for all layers in
  model/dream_gnn.py:_encode), so the layer takes no edge masks.

Weight parity notes:
- basis decomposition ``W = att @ basis`` ties the relations' weights
  (layers.py:70-71,120-121); the reverse direction reuses the forward
  ``W[r]`` (layers.py:126-127);
- under ``share_param`` the drug/disease output projections are one
  module (``ufc is ifc``, layers.py:61-64).

Params, features, graphs and masks may carry a leading fold axis F
(a stack of folds, train/stacked.py): every product is batched over it and
every bias broadcasts as ``b[..., None, :]``.

The COO, grouped and sharded encoder layouts are still to be ported
(ROADMAP.md queue A, items 7, 8 and 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.graph.slabbed import BipartiteSlabbed
from dream_gnn_tpu_torch.kernels.spmm_slab import spmm_slab
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
    """(W_fwd, W_rev), each (..., R, in, msg)."""
    if share_param:
        basis = params["basis"]
        *lead, b, in_units, msg_units = basis.shape
        w = torch.matmul(params["att"], basis.reshape(*lead, b, -1))
        w = w.reshape(*lead, num_ratings, in_units, msg_units)
        return w, w  # same W for forward and reverse etypes
    conv_w = params["conv_w"]
    return conv_w[..., 0, :, :], conv_w[..., 1, :, :]


def _aggregator(graph, edge_masks):
    """``aggregate(r, hd, hv)`` -> (messages into diseases, into drugs) of
    rating r over ``graph``'s layout, with the augmentation's edge masks."""
    if isinstance(graph, BipartiteGraph):
        if edge_masks is not None and "fwd_add" in edge_masks:
            raise NotImplementedError(
                "add_random_edges masks are not ported yet (ROADMAP.md "
                "queue A, item 4: the other augment methods)")
        adjs = [graph.a0(), graph.a1]  # rating order = rating_vals [0, 1]

        def aggregate(r, hd, hv):
            a_f, a_r = adjs[r], adjs[r]
            if edge_masks is not None:
                a_f = a_f * edge_masks["fwd"][..., r, :, :]
                a_r = a_r * edge_masks["rev"][..., r, :, :]
            return torch.matmul(a_f.mT, hd), torch.matmul(a_r, hv)
        return aggregate
    if isinstance(graph, BipartiteSlabbed):
        if edge_masks is not None:
            raise ValueError(
                "a slabbed graph comes with its PRF edge dropout applied: "
                "pass augment.masks.prf_mask_graph(graph, masks) and no "
                "edge_masks")

        def aggregate(r, hd, hv):
            # The JAX layer calls spmm_slab with its default bf16 dtype
            # whatever the compute dtype (gcmc.py:204-205).
            return spmm_slab(graph.fwd[r], hd), spmm_slab(graph.rev[r], hv)
        return aggregate
    raise NotImplementedError(
        f"encoder layout {type(graph).__name__} is not ported yet "
        f"(ROADMAP.md queue A, items 7, 8 and 10)")


def gcmc_layer_apply(params, graph,
                     drug_feat: torch.Tensor, dis_feat: torch.Tensor, *,
                     dropout_rate: float, agg_act: str = "leaky",
                     share_param: bool = True, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     edge_masks=None):
    """One GCMC layer forward.

    Args:
      graph: a ``BipartiteGraph`` or a ``BipartiteSlabbed``.
      edge_masks: optional augmentation masks of the dense layout, a dict
        with 'fwd'/'rev' tensors of shape (..., R, n_drug, n_dis), per-etype
        edge keep-masks; None for a slabbed graph, which arrives already
        masked.  The graph's ci/cj stay *stale* by construction (parity
        trap, SURVEY.md §7.3.3).
    Returns (drug_out, dis_out), each (..., N, out_units).
    """
    aggregate = _aggregator(graph, edge_masks)
    num_ratings = params["att"].shape[-2]
    act = get_activation(agg_act)
    w_fwd, w_rev = _relation_weights(params, num_ratings, share_param)

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
        hd = torch.matmul(drug_feat, w_fwd[..., r, :, :])
        # disease -> drug (etype rev-r) reuses W[r] (layers.py:126-127)
        hv = torch.matmul(dis_feat, w_rev[..., r, :, :])
        m_dis, m_drug = aggregate(r, hd * cj_d, hv * cj_v)
        msg_dis = msg_dis + m_dis
        msg_drug = msg_drug + m_drug

    drug_h = act(msg_drug * graph.ci_drug)
    dis_h = act(msg_dis * graph.ci_dis)
    if train:
        drug_h = dropout(generator, drug_h, dropout_rate, train)
        dis_h = dropout(generator, dis_h, dropout_rate, train)

    # Output projections: drug through ifc, disease through ufc; one
    # shared module under share_param (layers.py:61-64,140-141).
    drug_fc = "fc" if share_param else "ifc"
    drug_out = drug_h @ params[f"{drug_fc}_w"] \
        + params[f"{drug_fc}_b"][..., None, :]
    dis_out = dis_h @ params["fc_w"] + params["fc_b"][..., None, :]
    return drug_out, dis_out
