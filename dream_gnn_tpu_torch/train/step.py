"""Training and evaluation steps.

Port of ``dream_gnn_tpu/train/step.py``.  The JAX package compiles a
whole eval interval into one ``lax.scan``; here an interval is a Python
loop of eager steps: augment -> dual-route forward -> loss -> backward
-> clip -> Adam, with the learning rate held by the optimizer so the
host-side plateau scheduler can change it between intervals.

Targets.  Edges decode mode: pred is the (E,) logit list of the fold's
candidate edges; the BCE targets and the metrics take the fold's edge
labels weighted by its 1/0 edge weights (padding edges weigh 0).  Grid
decode mode: pred is the (n_drug, n_dis) logit grid; the targets are the
association grid (``enc_graph.a1``) weighted by the in-fold cell mask
(``enc_graph.mask``) — the same cells and the same mean as the candidate
edge list.  On the scale path (a ``dec_layout``) pred is in the layout's
slot order, and the labels and weights passed in are the slot-order ones of
``ScaleDecoderLayout.slot_labels``.

Ranks.  Over a process group (a rank-sharded encoder graph or a
candidate-sharded decoder layout, model/dream_gnn.py) every rank runs this
same step, and every parameter gradient it ends with is the one-rank
gradient, the same on every rank, so the clip norm and Adam see identical
gradients.  Replicated compute (the FGCN route, the attention, the node
projections, the plain decoder, the common loss) runs on every rank on the
full arrays, the same ops on the same inputs.  Sharded compute (the GCMC
route on row blocks, the scale decoder on candidate chunks) gives each rank
part of the gradient of the weights it uses; they enter through
``replicated_in``, whose backward all-reduces that part.  With a
candidate-sharded decoder, the loss is the global weighted mean: this
rank's weighted sum and weight mass, each summed over the ranks
(train/losses.py), whose backward hands each rank the gradient of its own
logits.  The generator is seeded alike on every rank and every draw is made
for the whole problem, so all ranks hold the same draws.

Replicated compute is not bit for bit the same on every rank on a card:
the plain edge decoder's gathers take their backward through atomic adds
(``take_along_dim``), whose order changes from run to run, and the FGCN's
and the attention's gradients follow them.  Measured on an H100 over two
ranks, ``bench_scale --sharded-grouped`` left 17 of its 33 parameters
apart after three steps, by up to 3.2e-4 (PERF.md §5).  So after the
backward, before the clip, the step broadcasts the group's first rank's
gradients to the others (``broadcast_first_``, one flattened broadcast a
step): every rank then clips and steps with the same bits, as JAX's one
logical array does.  A broadcast keeps the first rank's arithmetic, which
is the one-rank run's; an all-reduce mean would move bits that are
already equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dream_gnn_tpu_torch.augment.masks import augment_inputs
from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.model.dream_gnn import (ModelInputs, forward,
                                                 param_leaves)
from dream_gnn_tpu_torch.nn.gcmc import SHARDED_LAYOUTS
from dream_gnn_tpu_torch.sharding.collectives import broadcast_first_
from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import \
    ShardedScaleDecoderLayout
from dream_gnn_tpu_torch.train.losses import total_loss
from dream_gnn_tpu_torch.train.optim import clip_by_global_norm_
from dream_gnn_tpu_torch.utils.metrics import aupr_masked, auroc_masked


@dataclasses.dataclass
class TrainState:
    params: Any                    # param tree; leaves require grad
    opt: torch.optim.Optimizer     # Adam over param_leaves(params)
    generator: torch.Generator     # every random draw of training


def init_state(params, generator: torch.Generator,
               train_cfg: TrainConfig) -> TrainState:
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    # L2 in the gradient after the clip, eps 1e-8: the optax chain of the
    # JAX package (train/optim.py); the loop sets the plateau lr.
    opt = torch.optim.Adam(leaves, lr=train_cfg.train_lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=train_cfg.weight_decay)
    return TrainState(params=params, opt=opt, generator=generator)


def decoder_targets(pred, inputs: ModelInputs, model_cfg: ModelConfig,
                    labels=None, weight=None):
    """(logits, labels, weights) of the loss and the metrics, flat per fold
    (an optional leading fold axis stays).  Grid mode takes the grid's
    targets from ``inputs.enc_graph``; edges mode needs the edge list's
    ``labels`` and ``weight``."""
    if model_cfg.decode_mode == "grid":
        if not hasattr(inputs.enc_graph, "mask"):
            raise ValueError(
                "decode_mode='grid' takes its targets from the dense encoder "
                f"graph; a {type(inputs.enc_graph).__name__} has none")
        return (pred.flatten(-2), inputs.enc_graph.a1.flatten(-2),
                inputs.enc_graph.mask.flatten(-2))
    if labels is None or weight is None:
        raise ValueError("decode_mode='edges' needs the edge labels and "
                         "weights")
    return pred, labels, weight


def _candidate_group(inputs: ModelInputs):
    """The process group over which the candidates are sharded, or None."""
    layout = inputs.dec_layout
    return layout.group if isinstance(layout, ShardedScaleDecoderLayout) \
        else None


def _replica_group(inputs: ModelInputs):
    """The process group whose ranks each hold a replica of every
    parameter (that of a rank-sharded encoder graph or a candidate-sharded
    decoder), or None on one rank."""
    if isinstance(inputs.enc_graph, SHARDED_LAYOUTS):
        return inputs.enc_graph.drug_rows.group
    return _candidate_group(inputs)


def make_one_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Single iteration: augment -> forward -> loss -> grads -> Adam.
    ``one_step(state, inputs, labels, weight)`` returns the loss (a device
    scalar); ``labels`` and ``weight`` are the edge list's, which grid mode
    does not need."""
    augment = train_cfg.augment

    def one_step(state: TrainState, inputs: ModelInputs, labels=None,
                 weight=None) -> torch.Tensor:
        aug_inputs, edge_masks = augment_inputs(
            state.generator, inputs, augment,
            num_ratings=model_cfg.num_ratings)
        pred, drug_out, drug_sim_out, dis_out, dis_sim_out = forward(
            state.params, aug_inputs, model_cfg, train=True,
            generator=state.generator, edge_masks=edge_masks)
        pred, labels, weight = decoder_targets(pred, aug_inputs, model_cfg,
                                               labels, weight)
        loss, _ = total_loss(
            pred, labels, drug_out, drug_sim_out, dis_out,
            dis_sim_out, beta=train_cfg.beta,
            smoothing=train_cfg.label_smoothing, weight=weight,
            group=_candidate_group(aug_inputs))
        state.opt.zero_grad()
        loss.backward()
        grads = [p.grad for p in param_leaves(state.params)
                 if p.grad is not None]
        group = _replica_group(aug_inputs)
        if group is not None:
            broadcast_first_(grads, group)
        if train_cfg.train_grad_clip and train_cfg.train_grad_clip > 0:
            clip_by_global_norm_(grads, train_cfg.train_grad_clip)
        state.opt.step()
        return loss.detach()

    return one_step


@torch.no_grad()
def evaluate(params, inputs: ModelInputs, model_cfg: ModelConfig,
             labels=None, weight=None):
    """Eval forward (dropout off) and on-device (AUROC, AUPR) over the
    weighted edges (edges mode) or the in-fold cells of ``inputs.enc_graph``
    (grid mode).  Parity trap §7.3.1: the caller passes the *test* encoder
    graph for test-set evaluation.  With a candidate-sharded decoder the
    labels and weights are this rank's slot-order ones, and the metrics run
    over every rank's candidates."""
    pred, *_ = forward(params, inputs, model_cfg, train=False)
    pred, labels, weight = decoder_targets(pred, inputs, model_cfg, labels,
                                           weight)
    if _candidate_group(inputs) is not None:
        # Every rank's slots, in candidate order, on every rank.
        pred, labels, weight = (inputs.dec_layout.gather(x)
                                for x in (pred, labels, weight))
    return auroc_masked(labels, pred, weight), aupr_masked(labels, pred,
                                                           weight)


def run_steps(one_step, state, n_steps: int, *args) -> torch.Tensor:
    """``n_steps`` iterations of ``one_step(state, *args)``; returns their
    losses stacked on a leading axis."""
    return torch.stack([one_step(state, *args) for _ in range(n_steps)])

