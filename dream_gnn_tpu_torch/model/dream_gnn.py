"""DREAM-GNN dual-route model composition.

Port of ``dream_gnn_tpu/model/dream_gnn.py`` (reference ``Net``,
model.py:4-103):

- **GCMC route**: L stacked relation-typed bipartite conv layers with
  decayed residual accumulation ``out = h1 + h2/2 + h3/3``
  (model.py:67-76) while features chain layer to layer;
- **FGCN route**: two 2-layer GCNs per entity over the kNN similarity
  and feature-kNN graphs (model.py:79-83);
- one **shared** attention module fuses the two routes for drugs and
  diseases alike (model.py:55,93-97 — parity trap §7.3.7);
- the decoder returns logits, with no sigmoid.  ``decode_mode='edges'``
  scores the candidate edge list (``dec_src``, ``dec_dst``), 'grid' every
  (drug, disease) cell; ``decoder_backend='pallas'`` runs the fused CUDA
  kernels (kernels/edge_decoder.py, kernels/grid_decoder.py), 'xla' the
  plain decoders of nn/decoder.py.  The kernels gather node rows, so unlike
  the JAX package's one-hot gathers they take any node count.  With a
  ``dec_layout`` (the scale path, scripts/train_scale.py of the JAX package)
  the 'pallas' backend runs the scale decoder (kernels/scale_decoder.py),
  whose logits come in the layout's slot order.

The encoder graph is dense (``BipartiteGraph``) or, at scale, padded COO
(``BipartiteCoo``), slabbed (``BipartiteSlabbed``) or grouped
(``BipartiteGrouped``); a slabbed or grouped graph's PRF edge dropout is
applied once per forward, since every layer draws the same masks from the
same salts.  Over the ranks of a process group the encoder graph may be
rank-sharded (``BipartiteSharded``, ``BipartiteShardedGrouped``,
sharding/scale_graph.py) and the scale decoder's layout candidate-sharded
(``ShardedScaleDecoderLayout``, sharding/scale_decoder_spmd.py).  Then the
GCMC route runs on this rank's row blocks of the features, and its outputs
are gathered; the FGCN route, the attention and the node projections run
replicated, the same on every rank; and the decoder scores this rank's
candidates only (train/step.py says where each gradient is summed).

This module is the model kind 'dream'; GCMC alone, the kind 'gcmc', is
model/gcmc_alone.py, and model/kinds.py maps ``ModelConfig.model_kind`` to
either.

Parameters are plain dicts of tensors with the JAX package's keys
(``tgcn[i]``, ``fgcn``, ``attention``, ``decoder``) and its (in, out)
weight layout, so ``convert.params_from_jax`` carries weights across.
Randomness comes from one ``torch.Generator``, drawn in a fixed order.

``forward_stacked`` runs a stack of F folds: every param leaf, input and
mask carries a leading fold axis, the encoder runs each op once over it,
and the decoder is one launch of the fold-batched kernel (or one plain
decode over the fold axis).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from dream_gnn_tpu_torch.augment.masks import PRF_LAYOUTS, prf_mask_graph
from dream_gnn_tpu_torch.config import ModelConfig
from dream_gnn_tpu_torch.kernels.edge_decoder import (
    EdgeOrder, decoder_apply_fused, decoder_apply_fused_batched)
from dream_gnn_tpu_torch.kernels.grid_decoder import (
    decoder_apply_grid_fused, decoder_apply_grid_fused_batched)
from dream_gnn_tpu_torch.kernels.scale_decoder import (ScaleDecoderLayout,
                                                        decoder_apply_scale)
from dream_gnn_tpu_torch.nn.attention import attention_apply, attention_init
from dream_gnn_tpu_torch.nn.decoder import (decoder_apply, decoder_apply_grid,
                                            decoder_init)
from dream_gnn_tpu_torch.nn.fgcn import fgcn_apply, fgcn_init
from dream_gnn_tpu_torch.nn.gcmc import (SHARDED_LAYOUTS, gcmc_layer_apply,
                                         gcmc_layer_init)
from dream_gnn_tpu_torch.sharding.decoder_spmd import EdgeShard
from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import (
    ShardedScaleDecoderLayout, decoder_apply_scale_spmd)
from dream_gnn_tpu_torch.utils.profiling import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (decode_mode, decoder_backend) -> (decoder of one fold, of a fold stack).
_DECODERS = {
    ("grid", "pallas"): (decoder_apply_grid_fused,
                         decoder_apply_grid_fused_batched),
    ("grid", "xla"): (decoder_apply_grid, decoder_apply_grid),
    ("edges", "pallas"): (decoder_apply_fused, decoder_apply_fused_batched),
    ("edges", "xla"): (decoder_apply, decoder_apply),
}


@dataclasses.dataclass(frozen=True)
class ModelInputs:
    """One forward pass's graph and feature inputs (Net.forward's
    argument list, model.py:60-64)."""

    enc_graph: Any                     # BipartiteGraph or a sparse layout
    dec_src: torch.Tensor              # (E,) drug ids, candidate-pair order
    dec_dst: torch.Tensor              # (E,) disease ids
    drug_graph: Any                    # NormAdj | CooGraph
    drug_sim_feat: torch.Tensor        # (n_drug, fdim_drug) similarity rows
    drug_feat: torch.Tensor            # (n_drug, src_in_units) embeddings
    dis_graph: Any
    dis_sim_feat: torch.Tensor
    dis_feat: torch.Tensor
    drug_feature_graph: Any = None
    dis_feature_graph: Any = None
    # The edge list's ordering for the fused edge decoder's backward, built
    # once per list (train/loop.py:fold_inputs); the counterpart of the JAX
    # package's dec_layout.  Built in each backward when None.
    dec_order: Optional[EdgeOrder] = None
    # On a dp x mp mesh, this rank's block of the edge list over mp and its
    # ordering for the fused edge decoder
    # (sharding/partition.py:shard_stacked), built once per list; None
    # without a mesh and in grid mode.
    dec_shard: Optional[EdgeShard] = None
    # The scale decoder's ScaleDecoderLayout of the candidate list
    # (kernels/scale_decoder.py), static per list like the reference's dec
    # graph (data_loader.py:492-509).
    dec_layout: Any = None


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random params drawn from ``gen``, on the generator's device."""
    if cfg.gcn_agg_accum != "sum":
        # 'stack' is incoherent in the reference itself (its (N, R, eff)
        # stack cannot feed Linear(eff, out)) and the default is 'sum'.
        raise NotImplementedError(
            f"gcn_agg_accum={cfg.gcn_agg_accum!r}: only 'sum' is supported")
    tgcn = [gcmc_layer_init(
        gen, in_units=cfg.layer_in_units(i),
        msg_units=cfg.effective_msg_units(i), out_units=cfg.gcn_out_units,
        num_ratings=cfg.num_ratings, basis_units=cfg.basis_units,
        share_param=cfg.share_param) for i in range(cfg.layers)]
    return {
        "tgcn": tgcn,
        "fgcn": fgcn_init(gen, fdim_drug=cfg.fdim_drug,
                          fdim_disease=cfg.fdim_disease,
                          nhid1=cfg.nhid1, nhid2=cfg.nhid2),
        "attention": attention_init(gen, in_size=cfg.gcn_out_units,
                                    hidden_size=cfg.attention_hidden),
        "decoder": decoder_init(gen, in_units=cfg.gcn_out_units,
                                hidden1=cfg.decoder_hidden1,
                                hidden2=cfg.decoder_hidden2),
    }


def map_params(fn, params):
    """Apply ``fn`` to every tensor of a param tree (dicts and lists)."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, list):
        return [map_params(fn, v) for v in params]
    return fn(params)


def param_leaves(params):
    """The tree's tensors in a fixed order (dict keys sorted), which is
    ``jax.tree.flatten``'s order over the JAX package's param tree."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in param_leaves(params[k])]
    if isinstance(params, list):
        return [x for v in params for x in param_leaves(v)]
    return [params]


def named_leaves(tree, path=""):
    """(name, tensor) of a param tree in ``param_leaves`` order, named as
    ``tgcn[0].weight``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}.{k}".lstrip("."))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def params_from_leaves(template, leaves):
    """The tree of ``template`` with its tensors replaced, in
    ``param_leaves`` order, by ``leaves``; the inverse of
    ``param_leaves``."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            built = {k: build(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("params_from_leaves: more leaves than the template "
                         "has tensors")
    return out


def _encode(params, inputs: ModelInputs, cfg: ModelConfig, *, train: bool,
            generator, edge_masks):
    """GCMC route, FGCN route, attention fusion.

    Returns (drug_feats, dis_feats, drug_out, drug_sim_out, dis_out,
    dis_sim_out).
    """
    enc_graph = inputs.enc_graph
    with span("gcmc"):
        # The salts are per relation, not per layer: one masked graph serves
        # every layer (the JAX layer masks it anew in each).
        if isinstance(enc_graph, PRF_LAYOUTS) and edge_masks is not None:
            enc_graph = prf_mask_graph(enc_graph, edge_masks)
            edge_masks = None
        drug_feat, dis_feat = inputs.drug_feat, inputs.dis_feat
        sharded = isinstance(enc_graph, SHARDED_LAYOUTS)
        if sharded:
            # The GCMC route runs on this rank's row blocks (nn/gcmc.py).
            drug_feat = enc_graph.drug_rows.shard_rows(drug_feat)
            dis_feat = enc_graph.dis_rows.shard_rows(dis_feat)
        drug_out = dis_out = 0.0
        for i in range(cfg.layers):
            drug_o, dis_o = gcmc_layer_apply(
                params["tgcn"][i], enc_graph, drug_feat, dis_feat,
                dropout_rate=cfg.dropout, agg_act=cfg.model_activation,
                share_param=cfg.share_param, train=train, generator=generator,
                edge_masks=edge_masks)
            # Decayed residual accumulation (model.py:67-76).
            drug_out = drug_o if i == 0 else drug_out + drug_o / float(i + 1)
            dis_out = dis_o if i == 0 else dis_out + dis_o / float(i + 1)
            drug_feat, dis_feat = drug_o, dis_o
        if sharded:
            drug_out = enc_graph.drug_rows.gather(drug_out)
            dis_out = enc_graph.dis_rows.gather(dis_out)

    with span("fgcn"):
        drug_sim_out, dis_sim_out, *_ = fgcn_apply(
            params["fgcn"], inputs.drug_graph, inputs.drug_sim_feat,
            inputs.dis_graph, inputs.dis_sim_feat,
            inputs.drug_feature_graph, inputs.dis_feature_graph,
            dropout_rate=cfg.dropout, train=train, generator=generator)

    with span("attention"):
        drug_feats, _ = attention_apply(
            params["attention"],
            torch.stack([drug_out, drug_sim_out], dim=-2),
            dropout_rate=cfg.attention_dropout, train=train,
            generator=generator)
        dis_feats, _ = attention_apply(
            params["attention"], torch.stack([dis_out, dis_sim_out], dim=-2),
            dropout_rate=cfg.attention_dropout, train=train,
            generator=generator)
    return drug_feats, dis_feats, drug_out, drug_sim_out, dis_out, dis_sim_out


def forward(params, inputs: ModelInputs, cfg: ModelConfig, *,
            train: bool = False, generator: Optional[torch.Generator] = None,
            edge_masks=None):
    """Full dual-route forward.

    Returns (pred_logits, drug_out, drug_sim_out, dis_out, dis_sim_out):
    pred is (E,) in edges mode, (n_drug, n_dis) in grid mode; the
    intermediates feed the covariance common loss (train.py:289).
    """
    return _forward(params, inputs, cfg, stacked=False, train=train,
                    generator=generator, edge_masks=edge_masks)


def forward_stacked(params, inputs: ModelInputs, cfg: ModelConfig, *,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    edge_masks=None, mesh=None):
    """Fold-batched forward, the counterpart of the JAX ``forward_stacked``
    (dream_gnn.py:224-308): every param leaf, input leaf and
    ``edge_masks`` leaf carries a leading fold axis F.  Each op runs once
    over the stack; the fused decoder is one fold-batched kernel launch
    with one dropout seed per fold, all F drawn at once from ``generator``.

    ``mesh``: the dp x mp mesh of the fold-parallel step
    (sharding/partition.py).  The leaves are then this rank's folds of the
    stack (the fold axis over ``dp``); the encoder runs whole on every rank
    of the ``mp`` group, and the fused decoders on the rank's block of the
    disease columns or of the edges (sharding/decoder_spmd.py; in edges
    mode ``inputs.dec_shard``), their logits gathered over ``mp``.  The
    plain decoders ('xla') run whole on every rank.  A training forward
    draws one rank's masks when it runs under ``mesh.fold_draws``, as
    ``stacked_loss`` runs it (utils/draws.py).

    Returns (pred (F, E) or (F, n_drug, n_dis), drug_out, drug_sim_out,
    dis_out, dis_sim_out) with leading fold axes.
    """
    return _forward(params, inputs, cfg, stacked=True, train=train,
                    generator=generator, edge_masks=edge_masks, mesh=mesh)


def _forward(params, inputs, cfg, *, stacked, train, generator, edge_masks,
             mesh=None):
    decoders = _DECODERS.get((cfg.decode_mode, cfg.decoder_backend))
    if decoders is None:
        raise ValueError(
            f"decode_mode={cfg.decode_mode!r} with decoder_backend="
            f"{cfg.decoder_backend!r}: the modes are 'edges' and 'grid', the "
            f"backends 'pallas' and 'xla'")
    if train and generator is None:
        raise ValueError("a training forward needs a generator")
    (drug_feats, dis_feats, drug_out, drug_sim_out, dis_out,
     dis_sim_out) = _encode(params, inputs, cfg, train=train,
                            generator=generator, edge_masks=edge_masks)
    kw = dict(dropout_rate=cfg.dropout, train=train, generator=generator,
              dtype=DTYPES[cfg.compute_dtype])
    decode = decoders[stacked]
    if mesh is not None and cfg.decoder_backend == "pallas":
        kw["mesh"] = mesh
    with span("decoder"):
        if cfg.decode_mode == "grid":
            # pred is the (..., n_drug, n_dis) logit grid; the loss/metrics
            # mask out-of-fold cells with enc_graph.mask (labels =
            # enc_graph.a1).
            pred = decode(params["decoder"], drug_feats, dis_feats, **kw)
        elif cfg.decoder_backend == "pallas" and inputs.dec_layout is not None:
            layout = inputs.dec_layout
            if stacked:
                raise ValueError("the scale decoder takes one candidate list, "
                                 "not a fold stack")
            if isinstance(layout, ShardedScaleDecoderLayout):
                # Candidate-sharded (dream_gnn.py:182-200 of the JAX package):
                # pred is this rank's slots, in its slot order.
                if layout.mesh is None or layout.axis is None:
                    raise ValueError(
                        "ShardedScaleDecoderLayout routed through the model "
                        "needs mesh+axis captured at build time — pass "
                        "mesh=/axis= to build_scale_decoder_layout_sharded "
                        "(a mesh-less layout only works with the explicit "
                        "decoder_apply_scale_spmd(..., mesh, axis) call)")
                pred = decoder_apply_scale_spmd(
                    params["decoder"], layout, drug_feats, dis_feats,
                    layout.mesh, layout.axis, **kw)
            elif isinstance(layout, ScaleDecoderLayout):
                pred = decoder_apply_scale(params["decoder"], layout,
                                           drug_feats, dis_feats, **kw)
            else:
                raise ValueError(f"no scale decoder over a "
                                 f"{type(layout).__name__}")
        else:
            if cfg.decoder_backend == "pallas":
                if mesh is None:
                    kw["order"] = inputs.dec_order
                else:
                    kw["shard"] = inputs.dec_shard
            pred = decode(params["decoder"], inputs.dec_src, inputs.dec_dst,
                          drug_feats, dis_feats, **kw)
    return pred, drug_out, drug_sim_out, dis_out, dis_sim_out
