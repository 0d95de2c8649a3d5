"""GCMC layer: relation-typed bipartite graph convolution.

Port of ``dream_gnn_tpu/nn/gcmc.py`` (reference ``GCMCLayer`` +
``GCMCGraphConv``, layers.py:18-236).  Per rating r and direction:
``feat @ W_r``, times a *node-dropped* source norm ``dropout(cj)``
(layers.py:224-225), aggregation over the graph, then the dst norm ``ci``.
Outputs are summed over relations ('sum' accumulation), activated, dropped
out and projected by a shared Linear (layers.py:133-141).

Aggregation by layout:
- dense (``BipartiteGraph``): one matrix product over the adjacency mask,
  times the per-etype edge keep masks of augmentation, in union with its
  edge-add masks;
- padded COO (``BipartiteCoo``): ``spmm_coo``, a weighted ``index_add``,
  over each relation, with the per-edge keep masks multiplied into ``val``
  (gcmc.py:226-237 of the JAX package, which leaves it to XLA's
  ``segment_sum``: no kernel);
- slabbed (``BipartiteSlabbed``, the scale path) and grouped
  (``BipartiteGrouped``, the scale benchmark): the SpMM kernels of
  kernels/spmm_slab.py and kernels/spmm_gather.py over each relation's CSR
  layouts (gcmc.py:185-225).  The PRF edge dropout is applied to the graph
  before the layer (augment/masks.py:prf_mask_graph, once for all layers
  in model/dream_gnn.py:_encode), so the layer takes no edge masks;
- rank-sharded (sharding/scale_graph.py, gcmc.py:136-190):
  ``BipartiteShardedGrouped`` through ``spmm_gather_sharded`` or, with
  ``ring``, ``spmm_gather_sharded_ring`` (its PRF dropout applied before
  the layer, as above); ``BipartiteSharded`` through ``spmm_sharded``, with
  the per-edge keep masks multiplied into ``val``.  Over these the layer
  runs on row blocks: ``drug_feat`` and ``dis_feat`` are this rank's blocks
  of drug and disease rows (collectives.py ``RowBlock``), each aggregation
  takes a block of source rows to a block of destination rows through the
  halo exchange, the norms are sliced to the blocks, every dropout mask is
  drawn for all rows and sliced (so any rank count draws the same masks),
  and the weights enter through ``replicated_in``, whose backward sums the
  blocks' partial weight gradients over the ranks.

Weight parity notes:
- basis decomposition ``W = att @ basis`` ties the relations' weights
  (layers.py:70-71,120-121); the reverse direction reuses the forward
  ``W[r]`` (layers.py:126-127);
- under ``share_param`` the drug/disease output projections are one
  module (``ufc is ifc``, layers.py:61-64).

Params, features, graphs and masks may carry a leading fold axis F
(a stack of folds, train/stacked.py): every product is batched over it and
every bias broadcasts as ``b[..., None, :]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.graph.bipartite_coo import BipartiteCoo
from dream_gnn_tpu_torch.graph.grouped import BipartiteGrouped
from dream_gnn_tpu_torch.graph.slabbed import BipartiteSlabbed
from dream_gnn_tpu_torch.kernels.spmm import spmm_coo
from dream_gnn_tpu_torch.kernels.spmm_gather import spmm_gather
from dream_gnn_tpu_torch.kernels.spmm_slab import spmm_slab
from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.dropout import dropout
from dream_gnn_tpu_torch.sharding.collectives import replicated_in
from dream_gnn_tpu_torch.sharding.edge_partition import spmm_sharded
from dream_gnn_tpu_torch.sharding.scale_graph import (
    BipartiteSharded, BipartiteShardedGrouped, spmm_gather_sharded,
    spmm_gather_sharded_ring)
from dream_gnn_tpu_torch.utils.activations import get_activation

SHARDED_LAYOUTS = (BipartiteSharded, BipartiteShardedGrouped)


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
        adjs = [graph.a0(), graph.a1]  # rating order = rating_vals [0, 1]

        def aggregate(r, hd, hv):
            a_f, a_r = adjs[r], adjs[r]
            if edge_masks is not None:
                a_f = a_f * edge_masks["fwd"][..., r, :, :]
                a_r = a_r * edge_masks["rev"][..., r, :, :]
                if "fwd_add" in edge_masks:
                    # add_random_edges: the union with the add mask; a hit
                    # on an existing edge adds nothing (gcmc.py:123-127).
                    a_f = torch.maximum(
                        a_f, edge_masks["fwd_add"][..., r, :, :])
                    a_r = torch.maximum(
                        a_r, edge_masks["rev_add"][..., r, :, :])
            return torch.matmul(a_f.mT, hd), torch.matmul(a_r, hv)
        return aggregate
    if isinstance(graph, BipartiteCoo):
        def aggregate(r, hd, hv):
            g_f, g_r = graph.fwd[r], graph.rev[r]
            if edge_masks is not None:
                g_f = dataclasses.replace(
                    g_f, val=g_f.val * edge_masks["fwd"][r])
                g_r = dataclasses.replace(
                    g_r, val=g_r.val * edge_masks["rev"][r])
            return spmm_coo(g_f, hd), spmm_coo(g_r, hv)
        return aggregate
    if isinstance(graph, BipartiteSharded):
        def aggregate(r, hd, hv):
            g_f, g_r = graph.fwd[r], graph.rev[r]
            if edge_masks is not None:
                g_f = dataclasses.replace(
                    g_f, val=g_f.val * edge_masks["fwd"][r])
                g_r = dataclasses.replace(
                    g_r, val=g_r.val * edge_masks["rev"][r])
            return (spmm_sharded(graph.mesh, graph.axis, g_f, hd),
                    spmm_sharded(graph.mesh, graph.axis, g_r, hv))
        return aggregate
    if edge_masks is not None:
        raise ValueError(
            f"a {type(graph).__name__} comes with its PRF edge dropout "
            f"applied: pass augment.masks.prf_mask_graph(graph, masks) and "
            f"no edge_masks")
    if isinstance(graph, BipartiteShardedGrouped):
        sharded = spmm_gather_sharded_ring if graph.ring \
            else spmm_gather_sharded
        dis_rows, drug_rows = graph.dis_rows.rows, graph.drug_rows.rows

        def aggregate(r, hd, hv):
            return (sharded(graph.mesh, graph.axis, graph.fwd[r], hd,
                            graph.n_dis, dis_rows),
                    sharded(graph.mesh, graph.axis, graph.rev[r], hv,
                            graph.n_drug, drug_rows))
        return aggregate
    # The JAX layer calls spmm_slab and spmm_gather with their default bf16
    # dtype whatever the compute dtype (gcmc.py:204-205 and 224-225).
    spmm = {BipartiteSlabbed: spmm_slab,
            BipartiteGrouped: spmm_gather}.get(type(graph))
    if spmm is None:
        raise ValueError(f"no GCMC aggregation over a {type(graph).__name__}")

    def aggregate(r, hd, hv):
        return spmm(graph.fwd[r], hd), spmm(graph.rev[r], hv)
    return aggregate


def gcmc_layer_apply(params, graph,
                     drug_feat: torch.Tensor, dis_feat: torch.Tensor, *,
                     dropout_rate: float, agg_act: str = "leaky",
                     share_param: bool = True, train: bool = False,
                     generator: Optional[torch.Generator] = None,
                     edge_masks=None):
    """One GCMC layer forward.

    Args:
      graph: a ``BipartiteGraph``, ``BipartiteCoo``, ``BipartiteSlabbed``,
        ``BipartiteGrouped``, ``BipartiteSharded`` or
        ``BipartiteShardedGrouped`` (then the features are this rank's row
        blocks, and so are the outputs).
      edge_masks: optional augmentation masks, a dict with 'fwd'/'rev'
        per-etype edge keep-masks: tensors of shape (..., R, n_drug, n_dis)
        for the dense layout, with optional 'fwd_add'/'rev_add' edge-add
        masks of the same shape (add_random_edges); tuples of (E_pad,)
        tensors per relation for the COO layout, of (E_shard,) tensors for
        this rank's blocks of the sharded COO layout; None for a slabbed
        or grouped graph, sharded or not, which arrives already masked.
        The graph's ci/cj stay *stale* by construction (parity trap,
        SURVEY.md §7.3.3).
    Returns (drug_out, dis_out), each (..., N, out_units).
    """
    aggregate = _aggregator(graph, edge_masks)
    num_ratings = params["att"].shape[-2]
    act = get_activation(agg_act)
    ci_d, cj_d0, ci_v, cj_v0 = (graph.ci_drug, graph.cj_drug, graph.ci_dis,
                                graph.cj_dis)
    drop_d = drop_v = dropout
    if isinstance(graph, SHARDED_LAYOUTS):
        # Row blocks: see the module doc.
        rows_d, rows_v = graph.drug_rows, graph.dis_rows
        ci_d, cj_d0 = rows_d.block(ci_d), rows_d.block(cj_d0)
        ci_v, cj_v0 = rows_v.block(ci_v), rows_v.block(cj_v0)
        drop_d, drop_v = rows_d.dropout, rows_v.dropout
        params = {k: replicated_in(v, graph.group) for k, v in params.items()}
    w_fwd, w_rev = _relation_weights(params, num_ratings, share_param)

    msg_dis = 0.0
    msg_drug = 0.0
    for r in range(num_ratings):
        # drug -> disease (etype str(r)): node-dropout on the src norm cj
        # (layers.py:224-225), fresh mask per (rating, direction).
        cj_d, cj_v = cj_d0, cj_v0
        if train:
            cj_d = drop_d(generator, cj_d, dropout_rate, train)
            cj_v = drop_v(generator, cj_v, dropout_rate, train)
        hd = torch.matmul(drug_feat, w_fwd[..., r, :, :])
        # disease -> drug (etype rev-r) reuses W[r] (layers.py:126-127)
        hv = torch.matmul(dis_feat, w_rev[..., r, :, :])
        m_dis, m_drug = aggregate(r, hd * cj_d, hv * cj_v)
        msg_dis = msg_dis + m_dis
        msg_drug = msg_drug + m_drug

    drug_h = act(msg_drug * ci_d)
    dis_h = act(msg_dis * ci_v)
    if train:
        drug_h = drop_d(generator, drug_h, dropout_rate, train)
        dis_h = drop_v(generator, dis_h, dropout_rate, train)

    # Output projections: drug through ifc, disease through ufc; one
    # shared module under share_param (layers.py:61-64,140-141).
    drug_fc = "fc" if share_param else "ifc"
    drug_out = drug_h @ params[f"{drug_fc}_w"] \
        + params[f"{drug_fc}_b"][..., None, :]
    dis_out = dis_h @ params["fc_w"] + params["fc_b"][..., None, :]
    return drug_out, dis_out
