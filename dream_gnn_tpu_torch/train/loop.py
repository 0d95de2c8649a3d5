"""Per-fold training loop (reference ``train()``, train.py:154-395).

Port of ``dream_gnn_tpu/train/loop.py`` without checkpoint and resume
(ROADMAP.md queue A, item 5).  Protocol parity kept: iteration count
``range(1, train_max_iter)``, eval cadence, train-eval on the train
encoder graph vs test-eval on the test encoder graph (§7.3.1), plateau
LR on test AUPR, best-by-test-AUPR selection, and the CSV logging
contract.  Each interval's training steps (not its evals) are timed with
CUDA events on the card, with the host clock on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.kernels.edge_decoder import edge_csr
from dream_gnn_tpu_torch.model.dream_gnn import (ModelInputs, init_params,
                                                 map_params)
from dream_gnn_tpu_torch.train.optim import PlateauScheduler
from dream_gnn_tpu_torch.train.step import (evaluate, init_state,
                                            make_one_step, run_steps)
from dream_gnn_tpu_torch.utils.logging import MetricLogger


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
    CSR orderings for the fused edge decoder."""
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
        dec_csr=edge_csr(fold.train_src, fold.train_dst, *n), **common)
    test_inputs = ModelInputs(
        enc_graph=fold.test_enc, dec_src=fold.test_src,
        dec_dst=fold.test_dst,
        dec_csr=edge_csr(fold.test_src, fold.test_dst, *n), **common)
    return train_inputs, test_inputs, fold.train_labels, fold.test_labels


class IntervalTimer:
    """Time of a run of steps: CUDA events on the card, else the host
    clock.  ``ms_per_step`` is the mean over every timed step."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.total_ms = 0.0
        self.total_steps = 0

    def start(self):
        if self.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float:
        if self.cuda:
            self._ev[1].record()
            self._ev[1].synchronize()
            ms = self._ev[0].elapsed_time(self._ev[1])
        else:
            ms = (time.perf_counter() - self._t0) * 1e3
        self.total_ms += ms
        self.total_steps += n_steps
        return ms / max(n_steps, 1)

    @property
    def ms_per_step(self) -> Optional[float]:
        return self.total_ms / self.total_steps if self.total_steps else None


def train_fold(dataset: DreamDataset, cv: int, cfg: TrainConfig,
               generator: torch.Generator, *, save_dir: Optional[str] = None,
               save_id: int = 0, verbose: bool = True):
    """Train one fold; returns a result dict with best metrics."""
    model_cfg = derive_model_cfg(cfg, dataset)
    fold = dataset.fold(cv)
    return train_on_inputs(model_cfg, cfg, *fold_inputs(dataset, cv),
                           fold.train_w, fold.test_w, generator,
                           save_dir=save_dir, save_id=save_id,
                           verbose=verbose)


def save_params(path: str, params) -> None:
    """Flat npz of the param tree, keys like ``tgcn.0.basis``."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(f"{prefix}{i}.", v)
        else:
            flat[prefix[:-1]] = tree.numpy()

    walk("", params)
    np.savez(path, **flat)


def train_on_inputs(model_cfg: ModelConfig, cfg: TrainConfig,
                    train_inputs: ModelInputs, test_inputs: ModelInputs,
                    train_labels, test_labels, train_w, test_w,
                    generator: torch.Generator, *,
                    save_dir: Optional[str] = None, save_id: int = 0,
                    verbose: bool = True):
    """The fold-training core on explicit inputs: interval loops, plateau
    LR, best-by-test-AUPR and the CSV contract.  ``train_w``/``test_w``
    (1/0 per edge) weight the edges mode's loss and masked metrics with
    ``train_labels``/``test_labels``; grid mode scores the grid's cells.
    The scale path (train/scale.py) passes its layouts' slot-order labels
    and weights (dream_gnn_tpu/train/loop.py:90-104).
    ``generator`` (on the inputs' device) draws the params and every
    training random number."""
    # Every encoder layout has the norms; only the dense one has a1.
    device = train_inputs.enc_graph.ci_drug.device
    params = init_params(generator, model_cfg)
    state = init_state(params, generator, cfg)
    one_step = make_one_step(model_cfg, cfg)
    plateau = PlateauScheduler(cfg.train_lr, patience=cfg.plateau_patience,
                               factor=cfg.plateau_factor)

    logger = None
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        logger = MetricLogger(
            ["iter", "loss", "train_auroc", "train_aupr",
             "test_auroc", "test_aupr"],
            ["%d", "%.4f", "%.4f", "%.4f", "%.4f", "%.4f"],
            os.path.join(save_dir, f"test_metric{save_id}.csv"))

    best = dict(aupr=-1.0, auroc=0.0, iter=0, train_aupr=0.0,
                train_auroc=0.0)
    best_params = None
    total_iters = cfg.train_max_iter - 1      # range(1, max_iter)
    done = 0
    t0 = time.perf_counter()
    timer = IntervalTimer(device)

    while done < total_iters:
        chunk = min(cfg.train_valid_interval, total_iters - done)
        timer.start()
        losses = run_steps(one_step, state, chunk, train_inputs,
                           train_labels, train_w)
        ms = timer.stop(chunk)
        done += chunk
        if chunk != cfg.train_valid_interval:
            break   # trailing partial chunk: the reference never evals there
        loss, tr_auroc, tr_aupr, te_auroc, te_aupr = [float(x) for x in (
            losses[-1],
            *evaluate(state.params, train_inputs, model_cfg, train_labels,
                      train_w),
            *evaluate(state.params, test_inputs, model_cfg, test_labels,
                      test_w))]

        new_lr = plateau.step(te_aupr)
        for group in state.opt.param_groups:
            group["lr"] = new_lr

        if logger:
            logger.log(iter=done, loss=loss, train_auroc=tr_auroc,
                       train_aupr=tr_aupr, test_auroc=te_auroc,
                       test_aupr=te_aupr)
        if verbose:
            print(f"Iter={done:5d}, Loss={loss:.4f}, "
                  f"Train: AUROC={tr_auroc:.4f}, AUPR={tr_aupr:.4f}, "
                  f"Test: AUROC={te_auroc:.4f}, AUPR={te_aupr:.4f}, "
                  f"{ms:.3f} ms/step")

        if te_aupr > best["aupr"]:
            best = dict(aupr=te_aupr, auroc=te_auroc, iter=done,
                        train_aupr=tr_aupr, train_auroc=tr_auroc)
            if cfg.save_model:
                best_params = map_params(lambda t: t.detach().cpu().clone(),
                                         state.params)

    elapsed = time.perf_counter() - t0
    if logger:
        logger.close()
    if save_dir:
        with open(os.path.join(save_dir, f"best_metric{save_id}.csv"),
                  "w") as f:
            f.write("iter,train_auroc,train_aupr,test_auroc,test_aupr\n")
            f.write(f"{best['iter']},{best['train_auroc']:.4f},"
                    f"{best['train_aupr']:.4f},{best['auroc']:.4f},"
                    f"{best['aupr']:.4f}\n")
        if cfg.save_model and best_params is not None:
            save_params(os.path.join(save_dir,
                                      f"best_model_fold{save_id}.npz"),
                         best_params)

    if verbose and timer.ms_per_step is not None:
        print(f"Fold timing: {timer.ms_per_step:.3f} ms/step "
              f"({'CUDA events' if timer.cuda else 'host clock'}, "
              f"{timer.total_steps} steps)")

    return dict(best_auroc=best["auroc"], best_aupr=best["aupr"],
                best_iter=best["iter"], elapsed_s=elapsed,
                final_state=state, best_params=best_params,
                model_cfg=model_cfg, ms_per_step=timer.ms_per_step)
