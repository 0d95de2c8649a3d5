"""GCMC alone, the model kind 'gcmc' (model/kinds.py), as DGL's
``examples/pytorch/gcmc`` trains it with ``--use_one_hot_fea``: one GCMC
layer ('stack' over the relations, one-hot inputs, each side with its own
weights; nn/gcmc.py), then the bilinear decoder with a basis
(kernels/bilinear_decoder.py).  No FGCN, no attention, no common loss, no
decoder dropout.  The inputs' feature and FGCN fields are None
(train/scale.py:build_gcmc_inputs).
"""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.config import ModelConfig
from dream_gnn_tpu_torch.kernels.bilinear_decoder import bilinear_decoder
from dream_gnn_tpu_torch.model.dream_gnn import DTYPES
from dream_gnn_tpu_torch.nn import init as init_lib
from dream_gnn_tpu_torch.nn.gcmc import gcmc_layer_apply, gcmc_stack_layer_init
from dream_gnn_tpu_torch.utils.profiling import span


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """GCMC alone's params: one layer (``tgcn[0]``,
    nn/gcmc.py:gcmc_stack_layer_init) whose messages are DGL's
    ``gcn_agg_units // num_ratings`` wide a relation (DREAM-GNN's first
    layer divides them by 3 too, GCMC alone does not), and the bilinear
    decoder's basis ``P`` (B, D, D) and combination ``a`` (R, B), each
    xavier as DGL's ``BiDecoder`` initialises them."""
    if cfg.layers != 1 or cfg.share_param or cfg.gcn_agg_accum != "stack":
        raise NotImplementedError("GCMC alone runs DGL's one 'stack' layer "
                                  "with share_param off")
    b, d, r = cfg.gen_r_num_basis_func, cfg.gcn_out_units, cfg.num_ratings
    layer = gcmc_stack_layer_init(
        gen, drug_in=cfg.src_in_units, dis_in=cfg.dst_in_units,
        msg_units=cfg.gcn_agg_units // r, out_units=d, num_ratings=r)
    return {"tgcn": [layer],
            "decoder": {"P": init_lib.uniform(gen, (b, d, d),
                                              (3.0 / d) ** 0.5),
                        "a": init_lib.xavier_uniform(gen, (r, b))}}


def forward(params, inputs, cfg: ModelConfig, *, train: bool = False,
            generator=None, edge_masks=None):
    """(logits (R, E) in ``inputs.dec_layout``'s slot order, user out,
    None, item out, None): the tuple of DREAM-GNN's forward, without its
    similarity routes."""
    if train and generator is None:
        raise ValueError("a training forward needs a generator")
    if edge_masks is not None:
        raise ValueError("GCMC alone trains without augmentation")
    with span("gcmc"):
        drug_out, dis_out = gcmc_layer_apply(
            params["tgcn"][0], inputs.enc_graph, None, None,
            dropout_rate=cfg.dropout, agg_act=cfg.model_activation,
            share_param=False, train=train, generator=generator,
            accum="stack", msg_dtype=DTYPES[cfg.compute_dtype])
    with span("decoder"):
        dec = params["decoder"]
        pred = bilinear_decoder(drug_out, dis_out, dec["P"], dec["a"],
                                inputs.dec_layout)
    return pred, drug_out, None, dis_out, None
