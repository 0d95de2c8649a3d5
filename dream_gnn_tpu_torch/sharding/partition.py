"""The fold-parallel step on a dp x mp mesh.

Port of ``dream_gnn_tpu/sharding/partition.py``.  JAX lays the stacked
folds' arrays out on its mesh (every leaf's fold axis over ``dp``, the
disease dimension and the decoder's edges over ``mp``) and GSPMD inserts
the collectives.  Here a rank is a process (sharding/mesh.py), so each
rank keeps its own part:

- the fold axis over ``dp``: a rank holds F / dp folds of the stack, their
  inputs (``shard_stacked``) and their parameters, Adam moments and
  learning rates (``shard_state``); folds never communicate, so the
  per-fold clip and Adam run on the rank's folds alone;
- the ``mp`` group of a rank holds the same folds.  The dense encoder runs
  whole on every rank of the group (a Gdataset graph is 593 x 313), and
  only the fused decoders are sharded over ``mp``: the grid decoder's
  disease columns, the per-edge decoder's edges
  (sharding/decoder_spmd.py), whose logits are gathered over the group.

Every draw is made for the whole stack from the generator that every rank
seeds alike, and each rank keeps its folds' (utils/draws.py), so a dp x mp
run draws bit for bit the masks of a one-rank run of the same stack.
``shard_stacked`` needs F divisible by ``dp``, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.model.dream_gnn import map_params, param_leaves
from dream_gnn_tpu_torch.sharding.collectives import all_gather_raw
from dream_gnn_tpu_torch.sharding.decoder_spmd import shard_edges
from dream_gnn_tpu_torch.sharding.foldstack import StackedFolds, tree_map
from dream_gnn_tpu_torch.train.optim import StackedAdam
from dream_gnn_tpu_torch.train.stacked import (StackedState,
                                               evaluate_stacked,
                                               init_params_stacked,
                                               init_state_stacked,
                                               make_one_step_stacked,
                                               stack_seed)
from dream_gnn_tpu_torch.train.step import run_steps as _run_steps


def _fold_slice(mesh, n_folds: int) -> slice:
    """This rank's folds of a stack of ``n_folds`` over ``dp``."""
    dp = mesh.shape["dp"]
    if n_folds % dp:
        raise ValueError(f"{n_folds} folds do not split over dp = {dp}")
    size = n_folds // dp
    lo = mesh.index("dp") * size
    return slice(lo, lo + size)


def shard_stacked(mesh, stacked: StackedFolds,
                  decode_mode: str = "edges") -> StackedFolds:
    """This rank's folds of the stacked inputs, labels and weights; in
    edges ``decode_mode`` with its ``EdgeShard`` of their decoder edges
    over ``mp`` (and its ordering, built once here) as ``inputs.dec_shard``."""
    sl = _fold_slice(mesh, stacked.n_folds)
    local = tree_map(lambda a: a[sl], stacked)
    if decode_mode != "edges":
        return local
    inputs = local.inputs
    shard = shard_edges(mesh, inputs.dec_src, inputs.dec_dst,
                        inputs.drug_feat.shape[-2], inputs.dis_feat.shape[-2])
    return dataclasses.replace(
        local, inputs=dataclasses.replace(inputs, dec_shard=shard))


def shard_state(mesh, state: StackedState) -> StackedState:
    """This rank's folds of a whole stack's train state: the parameters,
    Adam's moments and step count, the (F,) learning rates; the generator
    is shared, as every rank seeds it alike."""
    opt = state.opt
    sl = _fold_slice(mesh, opt.lr.shape[0])
    params = map_params(lambda p: p.detach()[sl].clone().requires_grad_(True),
                        state.params)
    local = StackedAdam(param_leaves(params), opt.lr[sl].clone(),
                        opt.weight_decay, opt.b1, opt.b2, opt.eps)
    local.mu = [m[sl].clone() for m in opt.mu]
    local.nu = [v[sl].clone() for v in opt.nu]
    local.count = opt.count
    return StackedState(params=params, opt=local, generator=state.generator)


def gather_folds(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's (F / dp, ...) fold block gathered over ``dp`` into the
    whole stack's (F, ...), on every rank."""
    return all_gather_raw(x.detach().contiguous(), mesh.group("dp"))


def _init_stacked_state(mesh, model_cfg, train_cfg, seed: int,
                        folds: Sequence[int], device) -> StackedState:
    """The state of one seed's folds as train/stacked.py makes it (params
    from ``fold_generator``, the generator from ``stack_seed``), then this
    rank's folds of it."""
    folds = list(folds)
    gen = torch.Generator(device=device).manual_seed(stack_seed([seed], folds))
    state = init_state_stacked(
        init_params_stacked(model_cfg, [seed], folds, device), gen, train_cfg)
    return shard_state(mesh, state)


def make_multichip_train_step(mesh, model_cfg: ModelConfig,
                              train_cfg: TrainConfig):
    """Returns ``(init_stacked_state, step)``.

    ``init_stacked_state(seed, n_folds, device)``: the train state of folds
    0 .. n_folds - 1 of ``seed``, this rank's folds of it.
    ``step(state, stacked)`` advances every fold by one iteration on the
    ``shard_stacked`` inputs and returns the whole stack's (F,) losses,
    gathered over ``dp`` on every rank.  The fused decoders run their mesh
    paths (sharding/decoder_spmd.py)."""
    one_step = make_one_step_stacked(model_cfg, train_cfg, mesh=mesh)

    def init_stacked_state(seed: int, n_folds: int, device) -> StackedState:
        return _init_stacked_state(mesh, model_cfg, train_cfg, seed,
                                   range(n_folds), device)

    def step(state: StackedState, stacked: StackedFolds) -> torch.Tensor:
        return gather_folds(mesh, one_step(state, stacked.inputs,
                                           stacked.labels,
                                           stacked.edge_weight))

    return init_stacked_state, step


def make_multichip_train_fns(mesh, model_cfg: ModelConfig,
                             train_cfg: TrainConfig):
    """Returns ``(init_state, run_steps, run_interval)``, the fold-parallel
    protocol's functions over the mesh.

    ``init_state(seed, folds, device)``: this rank's folds of the state of
    ``seed``'s ``folds``.  ``run_steps(state, train, n_steps)``: n steps on
    the ``shard_stacked`` train stack; returns the last step's (F,) losses.
    ``run_interval(state, train, test, n_steps)``: n steps, then the train
    and test evaluations; returns every fold's (F, 5) metrics (loss,
    train AUROC, train AUPR, test AUROC, test AUPR).  Both gather over
    ``dp``, so every rank returns the whole stack's numbers."""
    one_step = make_one_step_stacked(model_cfg, train_cfg, mesh=mesh)

    def init_state(seed: int, folds: Sequence[int], device) -> StackedState:
        return _init_stacked_state(mesh, model_cfg, train_cfg, seed, folds,
                                   device)

    def steps(state, train: StackedFolds, n_steps: int) -> torch.Tensor:
        return _run_steps(one_step, state, n_steps, train.inputs,
                          train.labels, train.edge_weight)[-1]

    def run_steps(state, train: StackedFolds, n_steps: int) -> torch.Tensor:
        return gather_folds(mesh, steps(state, train, n_steps))

    def run_interval(state, train: StackedFolds, test: StackedFolds,
                     n_steps: int) -> torch.Tensor:
        loss = steps(state, train, n_steps)
        metrics = torch.cat([
            loss[:, None],
            evaluate_stacked(state.params, train, model_cfg, mesh),
            evaluate_stacked(state.params, test, model_cfg, mesh)], dim=1)
        return gather_folds(mesh, metrics)

    return init_state, run_steps, run_interval
