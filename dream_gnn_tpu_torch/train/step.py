"""Training and evaluation steps.

Port of ``dream_gnn_tpu/train/step.py``.  The JAX package compiles a
whole eval interval into one ``lax.scan``; here an interval is a Python
loop of eager steps: augment -> dual-route forward -> loss -> backward
-> clip -> Adam, with the learning rate held by the optimizer so the
host-side plateau scheduler can change it between intervals.

Grid decode mode: pred is the (n_drug, n_dis) logit grid; the BCE
targets are the association grid (``enc_graph.a1``) weighted by the
in-fold cell mask (``enc_graph.mask``) — the same cells and the same
mean as the candidate edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from dream_gnn_tpu_torch.augment.masks import augment_inputs
from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.model.dream_gnn import (ModelInputs, forward,
                                                 param_leaves)
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


def _grid_targets(inputs: ModelInputs):
    return (inputs.enc_graph.a1.reshape(-1),
            inputs.enc_graph.mask.reshape(-1))


def make_one_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """Single iteration: augment -> forward -> loss -> grads -> Adam.
    ``one_step(state, inputs)`` returns the loss (a device scalar)."""
    augment = train_cfg.augment

    def one_step(state: TrainState, inputs: ModelInputs) -> torch.Tensor:
        aug_inputs, edge_masks = augment_inputs(
            state.generator, inputs, augment,
            num_ratings=model_cfg.num_ratings)
        pred, drug_out, drug_sim_out, dis_out, dis_sim_out = forward(
            state.params, aug_inputs, model_cfg, train=True,
            generator=state.generator, edge_masks=edge_masks)
        labels, weight = _grid_targets(aug_inputs)
        loss, _ = total_loss(
            pred.reshape(-1), labels, drug_out, drug_sim_out, dis_out,
            dis_sim_out, beta=train_cfg.beta,
            smoothing=train_cfg.label_smoothing, weight=weight)
        state.opt.zero_grad()
        loss.backward()
        leaves = param_leaves(state.params)
        if train_cfg.train_grad_clip and train_cfg.train_grad_clip > 0:
            clip_by_global_norm_(
                [p.grad for p in leaves if p.grad is not None],
                train_cfg.train_grad_clip)
        state.opt.step()
        return loss.detach()

    return one_step


@torch.no_grad()
def evaluate(params, inputs: ModelInputs, model_cfg: ModelConfig):
    """Eval forward (dropout off) and on-device (AUROC, AUPR) over the
    in-fold cells of ``inputs.enc_graph``.  Parity trap §7.3.1: the
    caller passes the *test* encoder graph for test-set evaluation."""
    pred, *_ = forward(params, inputs, model_cfg, train=False)
    labels, weight = _grid_targets(inputs)
    pred = pred.reshape(-1)
    return auroc_masked(labels, pred, weight), aupr_masked(labels, pred,
                                                           weight)


def run_steps(one_step, state: TrainState, inputs: ModelInputs,
              n_steps: int) -> torch.Tensor:
    """``n_steps`` training iterations; returns their losses (n_steps,)."""
    return torch.stack([one_step(state, inputs) for _ in range(n_steps)])

