"""Experiment harness: fixed seeds x 10-fold CV (reference
train.py:456-556).

Port of ``dream_gnn_tpu/train/harness.py``.  Folds run one after another
by default; ``fold_parallel`` trains the folds of each seed as one stack
and ``seed_parallel`` all seeds' folds as one stack (train/stacked.py).
``cfg.resume`` goes on from the checkpoints that ``cfg.checkpoint_every``
writes; a fold that never checkpointed starts over.  With ``save_model``
and ``generate_top_predictions`` each fold's best params score the novel
pairs (eval/novel.py) in sequence and fold-parallel; as in the JAX
package, the seed-parallel path writes none.  ``profile_dir`` traces the
first fold, or the first stack (utils/profiling.py).
Artifact contract kept in all three modes: per-seed directories
``{save_dir}/seed_{seed}/`` with the per-fold CSVs and
``experiment_results.csv`` (per-fold AUROC/AUPR + average), and a global
``summary_results.csv`` with per-seed averages, overall mean and std.

Randomness: the JAX package derives each fold's key as
``fold_in(key(seed), cv)``.  Here each fold of the sequential path draws
from one ``torch.Generator`` on the dataset's device, seeded with
``loop.fold_seed(seed, cv) = seed * 1_000_003 + cv``; a stack draws from
one generator seeded with ``stacked.stack_seed(seeds, folds)``.  The
novel predictions' ``--use_augmentation`` draw of fold ``cv`` comes from
``fold_generator(seed, 1000 + cv)``, as the JAX package's comes from
``fold_in(key(seed), 1000 + cv)``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from dream_gnn_tpu_torch.config import TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.eval.novel import get_top_novel_predictions
from dream_gnn_tpu_torch.train.loop import fold_generator, train_fold
from dream_gnn_tpu_torch.train.stacked import (train_seed_foldparallel,
                                               train_stacked_protocol)
from dream_gnn_tpu_torch.utils.profiling import trace


def _seed_summary(seed: int, exp_dir: str, results) -> dict:
    """Write the seed's ``experiment_results.csv`` from its per-fold
    result dicts; returns the seed's entry of the summary."""
    fold_results = [(r["best_auroc"], r["best_aupr"]) for r in results]
    avg_auroc = float(np.mean([r[0] for r in fold_results]))
    avg_aupr = float(np.mean([r[1] for r in fold_results]))
    with open(os.path.join(exp_dir, "experiment_results.csv"), "w") as f:
        f.write("fold,auroc,aupr\n")
        for i, (a, p) in enumerate(fold_results):
            f.write(f"{i + 1},{a:.4f},{p:.4f}\n")
        f.write(f"average,{avg_auroc:.4f},{avg_aupr:.4f}\n")
    ms = [r["ms_per_step"] for r in results]
    return dict(seed=seed, avg_auroc=avg_auroc, avg_aupr=avg_aupr,
                fold_results=fold_results,
                ms_per_step=None if None in ms else float(np.mean(ms)))


def _novel_predictions(dataset: DreamDataset, cfg: TrainConfig, seed: int,
                       cv: int, result: dict, exp_dir: str) -> None:
    """The fold's top-k novel pairs (JAX harness.py:97-107, 133-144): only
    with ``save_model``, which keeps the best params."""
    if not (cfg.save_model and cfg.generate_top_predictions
            and result["best_params"] is not None):
        return
    get_top_novel_predictions(
        result["best_params"], result["model_cfg"], dataset, cv,
        top_k=cfg.top_k, use_augmentation=cfg.use_augmentation,
        augment_cfg=cfg.augment,
        augment_generator=fold_generator(seed, 1000 + cv, dataset.device),
        save_path=os.path.join(
            exp_dir, f"top{cfg.top_k}_novel_predictions_fold{cv + 1}.csv"))


def run_experiments(dataset: DreamDataset, cfg: TrainConfig, *,
                    seeds: Optional[Sequence[int]] = None,
                    folds: Optional[Sequence[int]] = None,
                    verbose: bool = True,
                    profile_dir: Optional[str] = None,
                    fold_parallel: bool = False,
                    seed_parallel: bool = False):
    """Run the protocol; returns the summary.  Each seed's entry carries
    ``ms_per_step``: the stacked step's time under ``fold_parallel`` or
    ``seed_parallel``, else the mean of its folds' step times.
    ``profile_dir``: write a trace of the first fold (or stack) there."""
    seeds = list(seeds if seeds is not None else cfg.seeds)
    folds = list(folds if folds is not None else range(cfg.n_folds))
    seed_dirs = [os.path.join(cfg.save_dir, f"seed_{seed}") for seed in seeds]

    if seed_parallel:
        with trace(profile_dir):
            per_seed = train_stacked_protocol(dataset, cfg, seeds, folds,
                                              save_dirs=seed_dirs,
                                              verbose=verbose)
        all_results = [_seed_summary(seed, d, res)
                       for seed, d, res in zip(seeds, seed_dirs, per_seed)]
        return _summarize(cfg, seeds, all_results, verbose)

    all_results = []
    first = True
    for exp_idx, (seed, exp_dir) in enumerate(zip(seeds, seed_dirs)):
        if verbose:
            print(f"======== Experiment {exp_idx + 1}/{len(seeds)} "
                  f"with seed {seed} ========")
        os.makedirs(exp_dir, exist_ok=True)
        if fold_parallel:
            with trace(profile_dir if first else None):
                results = train_seed_foldparallel(dataset, cfg, seed, folds,
                                                  save_dir=exp_dir,
                                                  verbose=verbose)
            first = False
            for cv, res in zip(folds, results):
                _novel_predictions(dataset, cfg, seed, cv, res, exp_dir)
        else:
            results = []
            for cv in folds:
                if verbose:
                    print(f"============== Fold {cv + 1} ==============")
                resume_from = None
                if cfg.resume:
                    cand = os.path.join(exp_dir, f"ckpt_fold{cv + 1}.npz")
                    if os.path.exists(cand):
                        resume_from = cand
                with trace(profile_dir if first else None):
                    res = train_fold(
                        dataset, cv, cfg,
                        fold_generator(seed, cv, dataset.device),
                        save_dir=exp_dir, save_id=cv + 1, verbose=verbose,
                        resume_from=resume_from)
                first = False
                results.append(res)
                _novel_predictions(dataset, cfg, seed, cv, res, exp_dir)
        entry = _seed_summary(seed, exp_dir, results)
        all_results.append(entry)
        if verbose:
            print(f"Experiment {exp_idx + 1} (Seed {seed}) - "
                  f"Avg AUROC: {entry['avg_auroc']:.4f}, "
                  f"Avg AUPR: {entry['avg_aupr']:.4f}")

    return _summarize(cfg, seeds, all_results, verbose)


def _summarize(cfg: TrainConfig, seeds, all_results, verbose: bool):
    aurocs = [r["avg_auroc"] for r in all_results]
    auprs = [r["avg_aupr"] for r in all_results]
    summary = dict(
        mean_auroc=float(np.mean(aurocs)), std_auroc=float(np.std(aurocs)),
        mean_aupr=float(np.mean(auprs)), std_aupr=float(np.std(auprs)),
        best_seed=seeds[int(np.argmax(aurocs))],
        worst_seed=seeds[int(np.argmin(aurocs))],
        results=all_results)

    os.makedirs(cfg.save_dir, exist_ok=True)
    with open(os.path.join(cfg.save_dir, "summary_results.csv"), "w") as f:
        f.write("experiment,seed,avg_auroc,avg_aupr\n")
        for i, r in enumerate(all_results):
            f.write(f"{i + 1},{r['seed']},{r['avg_auroc']:.4f},"
                    f"{r['avg_aupr']:.4f}\n")
        f.write(f"overall,NA,{summary['mean_auroc']:.4f},"
                f"{summary['mean_aupr']:.4f}\n")
        f.write(f"std,NA,{summary['std_auroc']:.4f},"
                f"{summary['std_aupr']:.4f}\n")

    if verbose:
        print("\n===== OVERALL RESULTS =====")
        print(f"Overall Average - AUROC: {summary['mean_auroc']:.4f} "
              f"± {summary['std_auroc']:.4f}, "
              f"AUPR: {summary['mean_aupr']:.4f} "
              f"± {summary['std_aupr']:.4f}")
    return summary
