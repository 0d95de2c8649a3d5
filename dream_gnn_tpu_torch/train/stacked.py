"""Fold-parallel training on one card: all CV folds of a seed, or all
(seed, fold) items of the protocol, advance together as one stack.

Port of ``dream_gnn_tpu/train/stacked.py``.  The reference runs folds
strictly sequentially (train.py:500).  At reference dataset scale one
fold's step is a few hundred small kernels that leave the card mostly idle,
so a stack of F folds runs each op of the step once over a leading fold
axis: batched matrix products, one launch of the fold-batched decoder
kernel forward and one backward (or the plain decoder over the fold axis),
the per-fold clip and Adam over stacked leaves.  No Python loop over folds
runs inside the step.

Randomness.  Each item's params are drawn as the sequential path draws
them, from ``fold_generator(seed, cv)``.  Every training draw of the
stack (augmentation masks and noise, dropout masks, the F decoder seeds)
comes from one generator seeded with ``stack_seed(seeds, folds)``, one
call per draw for the whole (F, ...) tensor.  So with randomness off
(dropout 0, no augmentation) a stacked run is the sequential run up to
float reassociation; with it on, the two are equally distributed but not
sample for sample, as for the JAX package's default ``rbg`` run
(stacked.py:17-23 there).

Parity traps kept (train/loop.py:run_intervals): test evaluation runs
the encoder on the *test* encoder graph (SURVEY §7.3.1), the plateau LR
and best-by-test-AUPR selection are per fold, and the trailing partial
chunk of steps is not evaluated.  The stack trains DREAM-GNN only.

Failure recovery: with ``checkpoint_every`` the whole stack's train state
(params, Adam moments, lrs, the generator) with every item's plateau
scheduler and best-by-AUPR bookkeeping goes to one ``ckpt_stacked.npz``
under the first seed directory that is set; ``cfg.resume`` goes on from it,
and refuses a checkpoint of a stack of another size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Sequence

import torch

from dream_gnn_tpu_torch.augment.masks import augment_inputs
from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.model.dream_gnn import (ModelInputs, forward_stacked,
                                                 param_leaves)
from dream_gnn_tpu_torch.model.kinds import init_params, kind_of
from dream_gnn_tpu_torch.sharding.collectives import broadcast_first_
from dream_gnn_tpu_torch.sharding.foldstack import (StackedFolds, stack_folds,
                                                    tile, tree_map)
from dream_gnn_tpu_torch.train.checkpoint import checkpoint_items
from dream_gnn_tpu_torch.train.loop import (derive_model_cfg, fold_generator,
                                            fold_seed, run_intervals)
from dream_gnn_tpu_torch.train.losses import total_loss
from dream_gnn_tpu_torch.train.optim import (StackedAdam,
                                             clip_by_global_norm_per_fold_)
from dream_gnn_tpu_torch.train.step import decoder_targets
from dream_gnn_tpu_torch.utils.metrics import aupr_masked, auroc_masked
from dream_gnn_tpu_torch.utils.profiling import span


def stack_seed(seeds: Sequence[int], folds: Sequence[int]) -> int:
    """Seed of the generator of a stack's training draws: the items'
    ``fold_seed(seed, cv)``, seed-major, folded as
    ``h = (h * 1_000_003 + fold_seed) mod 2**63``.  A stack of one item
    gets that item's sequential seed."""
    h = 0
    for seed in seeds:
        for cv in folds:
            h = (h * 1_000_003 + fold_seed(seed, cv)) % 2 ** 63
    return h


@dataclasses.dataclass
class StackedState:
    params: dict                   # param tree; leaves (F, ...) require grad
    opt: StackedAdam               # holds the (F,) learning rates
    generator: torch.Generator     # every training draw of the stack


def init_params_stacked(model_cfg: ModelConfig, seeds: Sequence[int],
                        folds: Sequence[int], device):
    """Params of the (seed, fold) items, seed-major, each drawn as the
    sequential path draws it, stacked along a leading fold axis."""
    trees = [init_params(fold_generator(seed, cv, device), model_cfg)
             for seed in seeds for cv in folds]
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def init_state_stacked(params, generator: torch.Generator,
                       train_cfg: TrainConfig) -> StackedState:
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    n_folds = leaves[0].shape[0]
    lr = torch.full((n_folds,), train_cfg.train_lr, dtype=torch.float32,
                    device=leaves[0].device)
    return StackedState(params=params,
                        opt=StackedAdam(leaves, lr, train_cfg.weight_decay),
                        generator=generator)


def stacked_loss(params, inputs: ModelInputs, model_cfg: ModelConfig,
                 train_cfg: TrainConfig, generator: torch.Generator,
                 labels=None, weight=None, mesh=None) -> torch.Tensor:
    """Augment, stacked training forward and the (F,) per-fold losses on
    each fold's targets: its edge ``labels`` and ``weight``
    (``StackedFolds.labels``, ``.edge_weight``) in edges mode, its grid's
    (``enc_graph.a1``, ``enc_graph.mask``) in grid mode.  With a ``mesh``
    the folds are this rank's, and every draw, the augmentation's and the
    forward's, is made for the whole stack and cut to the rank's folds
    (utils/draws.py)."""
    block = mesh.fold_draws(inputs.drug_feat.shape[0]) if mesh \
        else contextlib.nullcontext()
    with span("forward"):
        with block:
            with span("augment"):
                aug, edge_masks = augment_inputs(
                    generator, inputs, train_cfg.augment,
                    num_ratings=model_cfg.num_ratings)
            pred, drug_out, drug_sim_out, dis_out, dis_sim_out = \
                forward_stacked(params, aug, model_cfg, train=True,
                                generator=generator, edge_masks=edge_masks,
                                mesh=mesh)
        pred, labels, weight = decoder_targets(pred, aug, model_cfg, labels,
                                               weight)
        with span("loss"):
            losses, _ = total_loss(
                pred, labels, drug_out, drug_sim_out, dis_out, dis_sim_out,
                beta=train_cfg.beta, smoothing=train_cfg.label_smoothing,
                weight=weight)
    return losses


def make_one_step_stacked(model_cfg: ModelConfig, train_cfg: TrainConfig,
                          mesh=None):
    """One iteration of every fold of the stack.  The folds are
    independent, so the gradient of the summed losses is each fold's own
    gradient (stacked.py:69-85 of the JAX package); then the per-fold clip
    and the per-fold-lr Adam.  ``one_step(state, inputs, labels, weight)``
    returns the (F,) losses.

    ``mesh``: the state and the inputs are this rank's folds
    (sharding/partition.py), and the folds never communicate: the clip and
    Adam run on the rank's folds alone.  Within the ``mp`` group every rank
    holds the same folds' parameters.  With the fused decoders the group's
    gradients are the same bits on every rank as they come: the encoder is
    dense products and the kernels sum in a fixed order (on an H100, 0 of
    33 leaves apart, PERF.md §5).  The plain decoders run whole on every
    rank, and the edge one's gathers take their backward through atomic
    adds on a card, so with them the gradients are made the group's first
    rank's bits before the clip, as train/step.py does over its replica
    group."""
    kind = kind_of(model_cfg)
    if not kind.stacks:
        raise ValueError(f"model kind {kind.name!r} trains one model at a "
                         f"time, not a fold stack")
    clip = train_cfg.train_grad_clip
    sync = mesh is not None and model_cfg.decoder_backend == "xla"

    def one_step(state: StackedState, inputs: ModelInputs, labels=None,
                 weight=None) -> torch.Tensor:
        losses = stacked_loss(state.params, inputs, model_cfg, train_cfg,
                              state.generator, labels, weight, mesh)
        for p in state.opt.params:
            p.grad = None
        with span("backward"):
            losses.sum().backward()
        with span("optimizer"):
            grads = [p.grad for p in state.opt.params]
            if sync:
                broadcast_first_(grads, mesh.group("mp"))
            if clip and clip > 0:
                clip_by_global_norm_per_fold_(grads, clip)
            with span("adam"):
                state.opt.step(grads)
        return losses.detach()

    return one_step


@torch.no_grad()
def evaluate_stacked(params, stacked: StackedFolds, model_cfg: ModelConfig,
                     mesh=None) -> torch.Tensor:
    """Eval forward of the stack and each fold's (AUROC, AUPR) over its
    weighted edges (edges mode) or in-fold cells (grid mode); returns
    (F, 2), with a ``mesh`` for this rank's folds.  The metrics loop over
    folds: eval runs once an interval, outside the step."""
    with span("eval"):
        pred, *_ = forward_stacked(params, stacked.inputs, model_cfg,
                                   train=False, mesh=mesh)
        pred, labels, weight = decoder_targets(
            pred, stacked.inputs, model_cfg, stacked.labels,
            stacked.edge_weight)
        return torch.stack([torch.stack([auroc_masked(y, p, w),
                                         aupr_masked(y, p, w)])
                            for y, p, w in zip(labels, pred, weight)])


def train_seed_foldparallel(dataset: DreamDataset, cfg: TrainConfig,
                            seed: int, folds: Sequence[int], *,
                            save_dir: Optional[str] = None,
                            verbose: bool = True):
    """Train every fold of one seed as one stack; returns the per-fold
    result dicts (the contract of ``loop.train_fold``)."""
    return train_stacked_protocol(dataset, cfg, [seed], folds,
                                  save_dirs=[save_dir], verbose=verbose)[0]


def train_stacked_protocol(dataset: DreamDataset, cfg: TrainConfig,
                           seeds: Sequence[int], folds: Sequence[int], *,
                           save_dirs: Optional[Sequence[Optional[str]]] = None,
                           verbose: bool = True):
    """Train S seeds x F folds as one (S*F)-item stack; returns per-seed
    lists of per-fold result dicts.

    Artifacts match the sequential path: per-fold ``test_metric{cv+1}.csv``
    and ``best_metric{cv+1}.csv`` (and ``best_model_fold{cv+1}.npz`` with
    ``save_model``) under each seed's ``save_dirs[s]``.  Every item of the
    stack shares the stacked graph data; only the params and the random
    draws differ between the S copies of a fold.

    ``cfg.resume``: go on from the ``ckpt_stacked.npz`` that
    ``cfg.checkpoint_every`` writes, when there is one; the CSV rows past
    it are dropped, so the resumed run's artifacts equal an uninterrupted
    run's.
    """
    seeds, folds = list(seeds), list(folds)
    save_dirs = list(save_dirs) if save_dirs is not None \
        else [None] * len(seeds)
    items = [(si, cv) for si in range(len(seeds)) for cv in folds]
    n_items = len(items)
    device = dataset.device
    model_cfg = derive_model_cfg(cfg, dataset)

    train_stacked = tile(stack_folds(dataset, folds, side="train"),
                         len(seeds))
    test_stacked = tile(stack_folds(dataset, folds, side="test"), len(seeds))
    generator = torch.Generator(device=device).manual_seed(
        stack_seed(seeds, folds))
    state = init_state_stacked(
        init_params_stacked(model_cfg, seeds, folds, device), generator, cfg)

    # The checkpoint's anchor: the first seed directory that is set.
    anchor = next((d for d in save_dirs if d), None)
    ckpt_path = os.path.join(anchor, "ckpt_stacked.npz") if anchor else None
    resume_from = None
    if cfg.resume and ckpt_path and os.path.exists(ckpt_path):
        n_ckpt = checkpoint_items(ckpt_path)
        if n_ckpt != n_items:
            raise ValueError(
                f"{ckpt_path} holds {n_ckpt} stacked items but this run "
                f"stacks {n_items} ({len(seeds)} seeds x {len(folds)} "
                f"folds): delete the stale checkpoint or match the stacking "
                f"it was written with")
        resume_from = ckpt_path

    def evaluate():
        return torch.cat([evaluate_stacked(state.params, s, model_cfg)
                          for s in (train_stacked, test_stacked)], dim=1)

    results, timer = run_intervals(
        cfg, kind_of(model_cfg), state, make_one_step_stacked(model_cfg, cfg),
        (train_stacked.inputs, train_stacked.labels,
         train_stacked.edge_weight), evaluate,
        lambda lrs: state.opt.lr.copy_(torch.tensor(lrs, dtype=torch.float32)),
        [(save_dirs[si], cv + 1) if save_dirs[si] else None
         for si, cv in items],
        ckpt_path=ckpt_path, resume_from=resume_from, verbose=verbose,
        line_tail=lambda ms: f"  [mean over {n_items} folds], {ms:.3f} "
                             f"ms/step, {ms / n_items:.3f} ms/fold-step")
    ms_per_step = timer.ms_per_step
    if verbose and ms_per_step is not None:
        print(f"Protocol timing: {ms_per_step:.3f} ms/step "
              f"({len(seeds)} seeds x {len(folds)} folds stacked), "
              f"{ms_per_step / n_items:.3f} ms/fold-step "
              f"({'CUDA events' if timer.cuda else 'host clock'}, "
              f"{timer.total_steps} steps), "
              f"{results[0]['elapsed_s']:.1f} s total")
    results = [dict(r, model_cfg=model_cfg) for r in results]
    nf = len(folds)
    return [results[si * nf:(si + 1) * nf] for si in range(len(seeds))]
