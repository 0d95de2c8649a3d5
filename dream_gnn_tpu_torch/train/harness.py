"""Experiment harness: fixed seeds x 10-fold CV, folds in sequence
(reference train.py:456-556).

Port of the sequential loop of ``dream_gnn_tpu/train/harness.py``.
Artifact contract kept: per-seed directories ``{save_dir}/seed_{seed}/``
with ``experiment_results.csv`` (per-fold AUROC/AUPR + average), and a
global ``summary_results.csv`` with per-seed averages, overall mean and
std.

Randomness: the JAX package derives each fold's key as
``fold_in(key(seed), cv)``.  Here each fold draws from one
``torch.Generator`` on the dataset's device, seeded with
``fold_seed(seed, cv) = seed * 1_000_003 + cv``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from dream_gnn_tpu_torch.config import TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.train.loop import train_fold


def fold_seed(seed: int, cv: int) -> int:
    return seed * 1_000_003 + cv


def fold_generator(seed: int, cv: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_seed(seed, cv))


def run_experiments(dataset: DreamDataset, cfg: TrainConfig, *,
                    seeds: Optional[Sequence[int]] = None,
                    folds: Optional[Sequence[int]] = None,
                    verbose: bool = True):
    """Run the protocol, folds one after another; returns the summary."""
    seeds = list(seeds if seeds is not None else cfg.seeds)
    folds = list(folds if folds is not None else range(cfg.n_folds))

    all_results = []
    for exp_idx, seed in enumerate(seeds):
        if verbose:
            print(f"======== Experiment {exp_idx + 1}/{len(seeds)} "
                  f"with seed {seed} ========")
        exp_dir = os.path.join(cfg.save_dir, f"seed_{seed}")
        os.makedirs(exp_dir, exist_ok=True)

        fold_results = []
        for cv in folds:
            if verbose:
                print(f"============== Fold {cv + 1} ==============")
            res = train_fold(dataset, cv, cfg,
                             fold_generator(seed, cv, dataset.device),
                             save_dir=exp_dir, save_id=cv + 1,
                             verbose=verbose)
            fold_results.append((res["best_auroc"], res["best_aupr"]))

        avg_auroc = float(np.mean([r[0] for r in fold_results]))
        avg_aupr = float(np.mean([r[1] for r in fold_results]))
        with open(os.path.join(exp_dir, "experiment_results.csv"), "w") as f:
            f.write("fold,auroc,aupr\n")
            for i, (a, p) in enumerate(fold_results):
                f.write(f"{i + 1},{a:.4f},{p:.4f}\n")
            f.write(f"average,{avg_auroc:.4f},{avg_aupr:.4f}\n")
        all_results.append(dict(seed=seed, avg_auroc=avg_auroc,
                                avg_aupr=avg_aupr,
                                fold_results=fold_results))
        if verbose:
            print(f"Experiment {exp_idx + 1} (Seed {seed}) - "
                  f"Avg AUROC: {avg_auroc:.4f}, Avg AUPR: {avg_aupr:.4f}")

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
