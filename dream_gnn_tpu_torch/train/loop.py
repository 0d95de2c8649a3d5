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
with the host clock on the CPU.
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
from dream_gnn_tpu_torch.model.dream_gnn import (ModelInputs, init_params,
                                                 map_params)
from dream_gnn_tpu_torch.train.checkpoint import (load_train_state,
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
    """The fold-training core on explicit inputs: interval loops, plateau
    LR, best-by-test-AUPR, the CSV contract, checkpoints and resume.
    GCMC alone (``model_kind='gcmc'``, train/scale.py's ``--model
    gcmc-ml10m``) evaluates the RMSE of ``valid`` = (inputs, labels,
    weights) and of the test side instead, takes the plateau LR and the best
    iteration by the lowest valid RMSE, as DGL's example does, and writes
    ``iter, loss, valid_rmse, test_rmse``; it keeps no checkpoints.
    ``train_w``/``test_w`` (1/0 per edge) weight the edges mode's loss and
    masked metrics with ``train_labels``/``test_labels``; grid mode scores
    the grid's cells.
    The scale path (train/scale.py) passes its layouts' slot-order labels
    and weights (dream_gnn_tpu/train/loop.py:90-104).
    ``generator`` (on the inputs' device) draws the params and every
    training random number.  ``resume_from`` restores the params, the Adam
    state, the generator, the lr, the plateau scheduler and the best-by-AUPR
    bookkeeping (best params included) of a ``checkpoint_every`` file, and
    the CSV keeps its rows up to the checkpoint's step."""
    gcmc = model_cfg.model_kind == "gcmc"
    if gcmc and (valid is None or resume_from or cfg.checkpoint_every):
        raise ValueError("GCMC alone trains with a valid side and without "
                         "checkpoints")
    # The sides evaluated at each interval and their metrics (the CSV's
    # columns); ``score`` picks the best iteration and drives the plateau
    # LR, the larger ``sign * score`` the better.  ``best`` names DREAM's
    # test metrics plainly, as its checkpoints do (``BEST_KEYS``).
    test_side = ("test", test_inputs, test_labels, test_w)
    if gcmc:
        sides, names = (("valid", *valid), test_side), ("rmse",)
        score, sign = "valid_rmse", -1.0
        best = dict(valid_rmse=float("inf"), test_rmse=float("inf"), iter=0)
    else:
        sides = (("train", train_inputs, train_labels, train_w), test_side)
        names, score, sign = ("auroc", "aupr"), "test_aupr", 1.0
        best = dict(aupr=-1.0, auroc=0.0, iter=0, train_aupr=0.0,
                    train_auroc=0.0)
    cols = [f"{side}_{n}" for side, *_ in sides for n in names]
    keep = {c: c[len("test_"):] if not gcmc and c.startswith("test_")
            else c for c in cols}
    # Every encoder layout has the norms; only the dense one has a1.
    device = train_inputs.enc_graph.ci_drug.device
    params = init_params(generator, model_cfg)
    state = init_state(params, generator, cfg)
    one_step = make_one_step(model_cfg, cfg)
    plateau = PlateauScheduler(cfg.train_lr, patience=cfg.plateau_patience,
                               factor=cfg.plateau_factor)
    best_params = None
    start_iter = 0
    if resume_from:
        start_iter, (best,), kept = load_train_state(
            resume_from, state, [plateau], with_best_params=cfg.save_model)
        best_params = kept[0] if kept else None

    logger = None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        logger = MetricLogger(
            ["iter", "loss", *cols], ["%d"] + ["%.4f"] * (1 + len(cols)),
            os.path.join(save_dir, f"test_metric{save_id}.csv"),
            resume_iter=start_iter if resume_from else None)

    total_iters = cfg.train_max_iter - 1      # range(1, max_iter)
    done = start_iter
    t0 = time.perf_counter()
    timer = StepTimer(device)

    while done < total_iters:
        chunk = min(cfg.train_valid_interval, total_iters - done)
        timer.start()
        losses = run_steps(one_step, state, chunk, train_inputs,
                           train_labels, train_w)
        ms = timer.stop(chunk)
        done += chunk
        if chunk != cfg.train_valid_interval:
            break   # trailing partial chunk: the reference never evals there
        outs = [(side, evaluate(state.params, x, model_cfg, y, w))
                for side, x, y, w in sides]
        loss = float(losses[-1])
        m = {f"{side}_{n}": float(v) for side, vals in outs
             for n, v in zip(names, vals)}

        new_lr = plateau.step(sign * m[score])
        for group in state.opt.param_groups:
            group["lr"] = new_lr

        if logger:
            logger.log(iter=done, loss=loss, **m)
        if verbose:
            text = ", ".join(
                f"{side.capitalize()}: " + ", ".join(
                    f"{n.upper()}={m[f'{side}_{n}']:.4f}" for n in names)
                for side, *_ in sides)
            print(f"Iter={done:5d}, Loss={loss:.4f}, {text}, "
                  f"{ms:.3f} ms/step")

        if sign * m[score] > sign * best[keep[score]]:
            best = dict({keep[c]: m[c] for c in cols}, iter=done)
            if cfg.save_model:
                best_params = map_params(lambda t: t.detach().cpu().clone(),
                                         state.params)

        if cfg.checkpoint_every and save_dir \
                and done % cfg.checkpoint_every == 0:
            save_train_state(
                os.path.join(save_dir, f"ckpt_fold{save_id}.npz"), state,
                done, [plateau], [best],
                [best_params] if cfg.save_model else None)

    elapsed = time.perf_counter() - t0
    if logger:
        logger.close()
    if save_dir:
        with open(os.path.join(save_dir, f"best_metric{save_id}.csv"),
                  "w") as f:
            f.write(",".join(["iter", *cols]) + "\n")
            f.write(",".join([str(best["iter"])]
                             + [f"{best[keep[c]]:.4f}" for c in cols])
                    + "\n")
        if cfg.save_model and best_params is not None:
            save_params(os.path.join(save_dir,
                                      f"best_model_fold{save_id}.npz"),
                         best_params)

    if verbose and timer.ms_per_step is not None:
        print(f"Fold timing: {timer.ms_per_step:.3f} ms/step "
              f"({'CUDA events' if timer.cuda else 'host clock'}, "
              f"{timer.total_steps} steps)")

    return dict(best_iter=best["iter"], elapsed_s=elapsed,
                final_state=state, best_params=best_params,
                model_cfg=model_cfg, ms_per_step=timer.ms_per_step,
                **{f"best_{k}": v for k, v in best.items() if k != "iter"})
