"""FGCN: the feature (similarity-graph) route.

Port of ``dream_gnn_tpu/nn/fgcn.py`` (reference ``FGCN``/``GCN``/
``GraphConvolution``, layers.py:238-321).  Two 2-layer GCNs — drug and
disease — each run on the kNN *similarity* graph and on the kNN
*feature* graph with the **same** parameters and the same input (the raw
similarity-matrix rows, so the input dim is the node count,
train.py:174-175), fused per node by ``relu(Linear(2*nhid2 -> nhid2))``
+ dropout (layers.py:268-278).

Params, features and graphs may carry a leading fold axis F; products
batch over it and biases broadcast as ``b[..., None, :]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.kernels.spmm import spmm
from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.dropout import dropout


def _gcn_init(gen, fdim, nhid1, nhid2):
    w1, b1 = init_lib.gcn_linear(gen, fdim, nhid1)
    w2, b2 = init_lib.gcn_linear(gen, nhid1, nhid2)
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


def _gcn_apply(p, x, adj, *, dropout_rate, train, generator):
    """relu(gc1) -> dropout -> gc2 (layers.py:245-249)."""
    h = spmm(adj, torch.matmul(x, p["w1"]))
    h = torch.relu(h + p["b1"][..., None, :])
    if train:
        h = dropout(generator, h, dropout_rate, train)
    h = spmm(adj, torch.matmul(h, p["w2"]))
    return h + p["b2"][..., None, :]


def fgcn_init(gen, *, fdim_drug: int, fdim_disease: int,
              nhid1: int, nhid2: int):
    params = {
        "drug_gcn": _gcn_init(gen, fdim_drug, nhid1, nhid2),
        "dis_gcn": _gcn_init(gen, fdim_disease, nhid1, nhid2),
    }
    params["drug_fusion_w"], params["drug_fusion_b"] = init_lib.torch_linear(
        gen, nhid2 * 2, nhid2)
    params["dis_fusion_w"], params["dis_fusion_b"] = init_lib.torch_linear(
        gen, nhid2 * 2, nhid2)
    return params


def fgcn_apply(params, drug_graph, drug_sim_feat, dis_graph, dis_sim_feat,
               drug_feature_graph=None, dis_feature_graph=None, *,
               dropout_rate: float, train: bool = False,
               generator: Optional[torch.Generator] = None):
    """Returns (emb1, emb2, emb1_sim, emb1_feat, emb2_sim, emb2_feat)
    exactly like reference FGCN.forward (layers.py:260-285)."""
    kw = dict(dropout_rate=dropout_rate, train=train, generator=generator)
    emb1_sim = _gcn_apply(params["drug_gcn"], drug_sim_feat, drug_graph, **kw)
    emb2_sim = _gcn_apply(params["dis_gcn"], dis_sim_feat, dis_graph, **kw)

    if drug_feature_graph is None or dis_feature_graph is None:
        return emb1_sim, emb2_sim, emb1_sim, None, emb2_sim, None

    emb1_feat = _gcn_apply(params["drug_gcn"], drug_sim_feat,
                           drug_feature_graph, **kw)
    emb2_feat = _gcn_apply(params["dis_gcn"], dis_sim_feat,
                           dis_feature_graph, **kw)

    fused_drug = torch.relu(
        torch.cat([emb1_sim, emb1_feat], dim=-1) @ params["drug_fusion_w"]
        + params["drug_fusion_b"][..., None, :])
    fused_dis = torch.relu(
        torch.cat([emb2_sim, emb2_feat], dim=-1) @ params["dis_fusion_w"]
        + params["dis_fusion_b"][..., None, :])
    if train:
        fused_drug = dropout(generator, fused_drug, dropout_rate, train)
        fused_dis = dropout(generator, fused_dis, dropout_rate, train)
    return fused_drug, fused_dis, emb1_sim, emb1_feat, emb2_sim, emb2_feat
