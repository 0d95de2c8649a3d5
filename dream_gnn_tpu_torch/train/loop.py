"""Per-fold training loop (reference ``train()``, train.py:154-395).

Port of ``dream_gnn_tpu/train/loop.py``.  Protocol parity kept: iteration
count ``range(1, train_max_iter)``, eval cadence, train-eval on the train
encoder graph vs test-eval on the test encoder graph (§7.3.1), plateau
LR on test AUPR, best-by-test-AUPR selection, and the CSV logging
contract.  With ``checkpoint_every`` the full train state is written
every that many steps (after an eval) to ``ckpt_fold{save_id}.npz``, and
``resume_from`` restores it (train/checkpoint.py): the reference can only
save final params, never resume (train.py:342-351).  Each interval's
training steps (not its evals) are timed with CUDA events on the card,
with the host clock on the CPU.  ``run_intervals`` is the port's one
interval loop, for one model and for train/stacked.py's fold stacks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import torch

from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.kernels.edge_decoder import edge_order
from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs
from dream_gnn_tpu_torch.model.kinds import ModelKind, kind_of
from dream_gnn_tpu_torch.train.checkpoint import (BEST_KEYS, item_params,
                                                  load_train_state,
                                                  save_params,
                                                  save_train_state)
from dream_gnn_tpu_torch.train.optim import PlateauScheduler
from dream_gnn_tpu_torch.train.step import (evaluate, init_state,
                                            make_one_step, run_steps)
from dream_gnn_tpu_torch.utils.logging import MetricLogger
from dream_gnn_tpu_torch.utils.profiling import StepTimer


def derive_model_cfg(cfg: TrainConfig, dataset: DreamDataset) -> ModelConfig:
    """Wire data-dependent dims (reference train.py:172-179)."""
    return dataclasses.replace(
        cfg.model,
        src_in_units=dataset.drug_feat.shape[1],
        dst_in_units=dataset.dis_feat.shape[1],
        fdim_drug=dataset.n_drug,
        fdim_disease=dataset.n_dis)


def fold_seed(seed: int, cv: int) -> int:
    """Seed of fold ``cv``'s generator under experiment seed ``seed``; the
    JAX package derives the fold's key as ``fold_in(key(seed), cv)``."""
    return seed * 1_000_003 + cv


def fold_generator(seed: int, cv: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_seed(seed, cv))


def fold_inputs(dataset: DreamDataset, cv: int):
    """(train_inputs, test_eval_inputs, train_labels, test_labels) of fold
    ``cv``, as the JAX package's; each side's inputs carry its edge list's
    ordering for the fused edge decoder's backward."""
    fold = dataset.fold(cv)
    common = dict(
        drug_graph=dataset.drug_graph,
        drug_sim_feat=dataset.drug_sim_feat,
        drug_feat=dataset.drug_feat,
        dis_graph=dataset.dis_graph,
        dis_sim_feat=dataset.dis_sim_feat,
        dis_feat=dataset.dis_feat,
        drug_feature_graph=dataset.drug_feature_graph,
        dis_feature_graph=dataset.dis_feature_graph)
    n = (dataset.n_drug, dataset.n_dis)
    train_inputs = ModelInputs(
        enc_graph=fold.train_enc, dec_src=fold.train_src,
        dec_dst=fold.train_dst,
        dec_order=edge_order(fold.train_src, fold.train_dst, *n), **common)
    test_inputs = ModelInputs(
        enc_graph=fold.test_enc, dec_src=fold.test_src,
        dec_dst=fold.test_dst,
        dec_order=edge_order(fold.test_src, fold.test_dst, *n), **common)
    return train_inputs, test_inputs, fold.train_labels, fold.test_labels


def train_fold(dataset: DreamDataset, cv: int, cfg: TrainConfig,
               generator: torch.Generator, *, save_dir: Optional[str] = None,
               save_id: int = 0, verbose: bool = True,
               resume_from: Optional[str] = None):
    """Train one fold; returns a result dict with best metrics.
    ``resume_from``: a train-state checkpoint of this fold to go on from."""
    model_cfg = derive_model_cfg(cfg, dataset)
    fold = dataset.fold(cv)
    return train_on_inputs(model_cfg, cfg, *fold_inputs(dataset, cv),
                           fold.train_w, fold.test_w, generator,
                           save_dir=save_dir, save_id=save_id,
                           verbose=verbose, resume_from=resume_from)


def train_on_inputs(model_cfg: ModelConfig, cfg: TrainConfig,
                    train_inputs: ModelInputs, test_inputs: ModelInputs,
                    train_labels, test_labels, train_w, test_w,
                    generator: torch.Generator, *,
                    save_dir: Optional[str] = None, save_id: int = 0,
                    verbose: bool = True, resume_from: Optional[str] = None,
                    valid=None):
    """One model through ``run_intervals``: a fold of the sequential
    protocol, the scale path or GCMC alone.  The model kind's sides are
    evaluated: DREAM-GNN's train and test sides, GCMC alone's ``valid`` =
    (inputs, labels, weights) and test side.  ``train_w``/``test_w`` (1/0
    per edge) weight the edges mode's loss and masked metrics with
    ``train_labels``/``test_labels``; grid mode scores the grid's cells.
    The scale path passes its layouts' slot-order labels and weights
    (dream_gnn_tpu/train/loop.py:90-104).  ``generator`` (on the inputs'
    device) draws the params and every training random number."""
    kind = kind_of(model_cfg)
    data = {"train": (train_inputs, train_labels, train_w), "valid": valid,
            "test": (test_inputs, test_labels, test_w)}
    sides = [data[side] for side in kind.sides]
    if None in sides:
        raise ValueError(f"model kind {kind.name!r} evaluates the sides "
                         f"{kind.sides}: pass valid=(inputs, labels, "
                         f"weights)")
    state = init_state(kind.init(generator, model_cfg), generator, cfg)

    def evaluate_sides():
        return torch.stack([v for x, y, w in sides for v in evaluate(
            state.params, x, model_cfg, y, w)])[None]

    (result,), timer = run_intervals(
        cfg, kind, state, make_one_step(model_cfg, cfg),
        (train_inputs, train_labels, train_w), evaluate_sides,
        lambda lrs: state.opt.param_groups[0].update(lr=lrs[0]),
        [(save_dir, save_id) if save_dir else None],
        ckpt_path=save_dir and os.path.join(save_dir,
                                            f"ckpt_fold{save_id}.npz"),
        resume_from=resume_from, verbose=verbose,
        line_tail=lambda ms: f", {ms:.3f} ms/step")
    if verbose and timer.ms_per_step is not None:
        print(f"Fold timing: {timer.ms_per_step:.3f} ms/step "
              f"({'CUDA events' if timer.cuda else 'host clock'}, "
              f"{timer.total_steps} steps)")
    return dict(result, final_state=state, model_cfg=model_cfg)


def _plain(col: str) -> str:
    """A CSV column's best-metric name (``checkpoint.BEST_KEYS``)."""
    return col[len("test_"):] if col.startswith("test_") else col


def run_intervals(cfg: TrainConfig, kind: ModelKind, state, one_step,
                  step_args, evaluate, set_lrs, outputs, *, line_tail,
                  ckpt_path=None, resume_from=None, verbose=True):
    """The interval loop over a state of N items (one model, or a fold
    stack): ``one_step(state, inputs, labels, weight)``, ``step_args`` the
    last three, in chunks of ``cfg.train_valid_interval`` steps, no eval
    after a trailing partial chunk.  Each eval's ``evaluate()`` is (N, C):
    ``kind.metric_names`` of each of ``kind.sides``.  Per item: a plateau
    LR on ``kind.score`` (``set_lrs`` writes the N rates), the best
    iteration (and params, under ``cfg.save_model``), and the CSVs and
    best params in ``outputs[i]`` = (directory, id), or none if None.
    ``ckpt_path`` gets the state every ``cfg.checkpoint_every`` steps;
    ``resume_from`` restores one.  Each interval prints the items' mean,
    then ``line_tail(ms per step)``.  Returns (results, timer)."""
    n = len(outputs)
    cols = [f"{side}_{m}" for side in kind.sides for m in kind.metric_names]
    score, sign = kind.score, 1.0 if kind.higher_is_better else -1.0
    plateaus = [PlateauScheduler(cfg.train_lr, patience=cfg.plateau_patience,
                                 factor=cfg.plateau_factor)
                for _ in range(n)]
    best = [dict(kind.unscored, iter=0) for _ in range(n)]
    best_params = [None] * n
    if (resume_from or cfg.checkpoint_every) and \
            set(best[0]) != set(BEST_KEYS):
        raise ValueError(f"a checkpoint keeps the bookkeeping {BEST_KEYS}, "
                         f"which model kind {kind.name!r} has not")
    start_iter = 0
    if resume_from:
        start_iter, best, kept = load_train_state(
            resume_from, state, plateaus, with_best_params=cfg.save_model)
        best_params = kept or best_params
        if verbose:
            print(f"Resumed from {resume_from} at iter {start_iter}")
    for out in filter(None, outputs):
        os.makedirs(out[0], exist_ok=True)
    loggers = [out and MetricLogger(
        ["iter", "loss", *cols], ["%d"] + ["%.4f"] * (1 + len(cols)),
        os.path.join(out[0], f"test_metric{out[1]}.csv"),
        resume_iter=start_iter or None) for out in outputs]

    total_iters = cfg.train_max_iter - 1      # range(1, max_iter)
    done = start_iter
    t0 = time.perf_counter()
    # Every encoder layout has the norms; only the dense one has a1.
    timer = StepTimer(step_args[0].enc_graph.ci_drug.device)
    while done < total_iters:
        chunk = min(cfg.train_valid_interval, total_iters - done)
        timer.start()
        losses = run_steps(one_step, state, chunk, *step_args)
        ms = timer.stop(chunk)
        done += chunk
        if chunk != cfg.train_valid_interval:
            break   # trailing partial chunk: the reference never evals there
        table = torch.cat([losses[-1].reshape(n, 1), evaluate()],
                          dim=1).cpu().numpy()          # (N, 1 + C)
        rows = [dict(zip(["loss", *cols], r)) for r in table.tolist()]
        set_lrs([p.step(sign * m[score]) for p, m in zip(plateaus, rows)])
        for i, m in enumerate(rows):
            if loggers[i]:
                loggers[i].log(iter=done, **m)
            if sign * m[score] > sign * best[i][_plain(score)]:
                best[i] = dict({_plain(c): m[c] for c in cols}, iter=done)
                if cfg.save_model:
                    best_params[i] = item_params(state, i)
        if verbose:
            mean = dict(zip(["loss", *cols], table.mean(axis=0)))
            text = ", ".join(f"{side.capitalize()}: " + ", ".join(
                f"{m.upper()}={mean[f'{side}_{m}']:.4f}"
                for m in kind.metric_names) for side in kind.sides)
            print(f"Iter={done:5d}, Loss={mean['loss']:.4f}, {text}"
                  f"{line_tail(ms)}")
        if cfg.checkpoint_every and ckpt_path \
                and done % cfg.checkpoint_every == 0:
            save_train_state(ckpt_path, state, done, plateaus, best,
                             best_params if cfg.save_model else None)

    elapsed = time.perf_counter() - t0
    for lg, out, b, bp in zip(loggers, outputs, best, best_params):
        if out is None:
            continue
        lg.close()
        with open(os.path.join(out[0], f"best_metric{out[1]}.csv"),
                  "w") as f:
            f.write(",".join(["iter", *cols]) + "\n")
            f.write(",".join([str(b["iter"])]
                             + [f"{b[_plain(c)]:.4f}" for c in cols]) + "\n")
        if cfg.save_model and bp is not None:
            save_params(os.path.join(out[0], f"best_model_fold{out[1]}.npz"),
                        bp)
    return [dict(best_iter=b["iter"], elapsed_s=elapsed, best_params=bp,
                 ms_per_step=timer.ms_per_step,
                 **{f"best_{k}": v for k, v in b.items() if k != "iter"})
            for b, bp in zip(best, best_params)], timer
