"""Param and train-state checkpoints.

Port of ``dream_gnn_tpu/train/checkpoint.py``.  The reference saves only
the best model's state_dict (``best_model_fold{id}.pth``, train.py:342-351)
and never resumes; here a checkpoint holds everything a run needs to go on
from the step it was written at, so a preempted run resumes exactly.

Format: an npz of the tree's leaves, ``leaf_{i}`` in ``param_leaves`` order
(dict keys sorted, lists in order), which is ``jax.tree.flatten``'s order
over the same tree.  The JAX ``save_pytree`` adds its pickled ``treedef``,
which the port cannot write without JAX; the port reads a tree back into
the structure of a template instead, so ``load_params`` also reads a file
that the JAX ``save_pytree`` wrote from the JAX param tree (its
``treedef`` is skipped).  A JAX reader of a port file rebuilds the treedef
from its own ``init_params``.

A train state (``save_train_state``) is one such tree:

- ``params``: the param tree (for a stack, leaves with a leading item axis);
- ``mu``, ``nu``, ``count``: the Adam moments and step count, of
  ``torch.optim.Adam`` (the sequential loop) or of ``StackedAdam``;
- ``lr``: the learning rate (the stack's (F,) rates);
- ``step``: the training steps done;
- ``scheduler``: each item's plateau scheduler as (lr, best, num_bad);
- ``best``: each item's best-by-test-AUPR bookkeeping, as ``BEST_KEYS``;
- ``best_params``, ``has_best_params``: each item's best params, on the
  CPU, when the run keeps them (``save_model``); an item with none yet
  stores its current params, flagged 0;
- ``generator``: the ``torch.Generator``'s ``get_state()`` (uint8), in
  place of the JAX key's data and impl name.  A CUDA generator's state is
  restored into the run's generator on its own device.

``best`` sorts first, so ``leaf_0`` is the (items, 5) best array:
``checkpoint_items`` reads a checkpoint's item count from it.

Every write goes to a temporary file that ``os.replace`` moves over the
checkpoint, so a preemption mid-write leaves the previous one whole.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from dream_gnn_tpu_torch.model.dream_gnn import (map_params, param_leaves,
                                                 params_from_leaves)

# The columns of the ``best`` array, one row per item.
BEST_KEYS = ("aupr", "auroc", "iter", "train_aupr", "train_auroc")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_npz(path: str, arrays: dict) -> None:
    """``arrays`` to ``path`` through a temporary file and ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(path: str, tree) -> None:
    """The leaves of a tree of dicts, lists and arrays or tensors, as
    ``leaf_{i}`` in ``param_leaves`` order."""
    _write_npz(path, {f"leaf_{i}": _to_numpy(x)
                      for i, x in enumerate(param_leaves(tree))})


def load_pytree(path: str, template):
    """The tree of ``template`` with the leaves of a ``save_pytree`` file.
    A template leaf that is a tensor gives a tensor of its dtype on its
    device; any other gives the file's numpy array.  A file of another
    leaf count or leaf shape is refused; a ``treedef`` entry (the JAX
    ``save_pytree``'s) is skipped."""
    like = param_leaves(template)
    with np.load(path) as f:
        names = set(f.files) - {"treedef"}
        want = {f"leaf_{i}" for i in range(len(like))}
        if names != want:
            raise ValueError(f"load_pytree: {path} holds {len(names)} leaves "
                             f"({sorted(names)[:3]}...), the template "
                             f"{len(like)}")
        arrays = [f[f"leaf_{i}"] for i in range(len(like))]
    leaves = []
    for i, (a, t) in enumerate(zip(arrays, like)):
        if tuple(a.shape) != tuple(np.shape(t)):
            raise ValueError(f"load_pytree: leaf_{i} of {path} has shape "
                             f"{a.shape}, the template {tuple(np.shape(t))}")
        leaves.append(torch.from_numpy(a).to(device=t.device, dtype=t.dtype)
                      if isinstance(t, torch.Tensor) else a)
    return params_from_leaves(template, leaves)


def save_params(path: str, params) -> None:
    """npz of a param tree in the leaf layout of the JAX package's
    ``save_pytree``, without its ``treedef``: ``--save_model``'s
    ``best_model_fold{i}.npz``."""
    save_pytree(path, params)


def load_params(path: str, template):
    """The param tree of ``template`` (its structure, shapes, dtypes and
    devices) with the values of a ``save_params`` file, or of a file that
    the JAX ``save_pytree`` wrote from the JAX param tree."""
    try:
        return load_pytree(path, template)
    except ValueError as e:
        raise ValueError(f"load_params: {e}") from None


def _moments(opt):
    """(mu, nu, count, lr) of ``torch.optim.Adam`` over one param group or
    of ``StackedAdam``; an Adam that has not stepped has zero moments."""
    if isinstance(opt, torch.optim.Adam):
        params = opt.param_groups[0]["params"]
        state = [opt.state.get(p, {}) for p in params]
        mu = [s.get("exp_avg", torch.zeros_like(p))
              for s, p in zip(state, params)]
        nu = [s.get("exp_avg_sq", torch.zeros_like(p))
              for s, p in zip(state, params)]
        count = float(state[0]["step"]) if "step" in state[0] else 0.0
        return mu, nu, np.float32(count), \
            np.float64(opt.param_groups[0]["lr"])
    return opt.mu, opt.nu, np.int64(opt.count), opt.lr


def _set_moments(opt, mu, nu, count, lr) -> None:
    if isinstance(opt, torch.optim.Adam):
        for p, m, v in zip(opt.param_groups[0]["params"], mu, nu):
            # The step stays a CPU float32 scalar, as Adam makes it.
            opt.state[p] = {"step": torch.tensor(float(count),
                                                 dtype=torch.float32),
                            "exp_avg": m, "exp_avg_sq": v}
        for group in opt.param_groups:
            group["lr"] = float(lr)
        return
    opt.mu, opt.nu, opt.count = list(mu), list(nu), int(count)
    opt.lr.copy_(lr)


def item_params(state, i: int):
    """Item ``i``'s params on the CPU: the tree itself for a sequential
    state, its slice of the leaves for a stack (``StackedAdam``)."""
    stacked = not isinstance(state.opt, torch.optim.Adam)
    return map_params(lambda t: (t[i] if stacked else t).detach().cpu()
                      .clone(), state.params)


def _state_tree(state, step: int, schedulers, best, best_params):
    mu, nu, count, lr = _moments(state.opt)
    tree = {
        "params": state.params, "mu": mu, "nu": nu, "count": count, "lr": lr,
        "step": np.int64(step),
        "scheduler": np.asarray([[s.lr, s.best, float(s.num_bad)]
                                 for s in schedulers], np.float64),
        "best": np.asarray([[float(b[k]) for k in BEST_KEYS] for b in best],
                           np.float64),
        "generator": state.generator.get_state(),
    }
    if best_params is not None:
        tree["best_params"] = [bp if bp is not None
                               else item_params(state, i)
                               for i, bp in enumerate(best_params)]
        tree["has_best_params"] = np.asarray(
            [bp is not None for bp in best_params])
    return tree


def save_train_state(path: str, state, step: int, schedulers: Sequence,
                     best: Sequence[dict],
                     best_params: Optional[List] = None) -> None:
    """Checkpoint a ``TrainState`` or ``StackedState`` after ``step`` steps
    with each item's plateau scheduler and best-by-AUPR bookkeeping (a dict
    of ``BEST_KEYS``); ``best_params``, a list with each item's best params
    or None, only when the run keeps them."""
    save_pytree(path, _state_tree(state, step, schedulers, best, best_params))


def checkpoint_items(path: str) -> int:
    """The number of items (folds of a stack, or 1) of a
    ``save_train_state`` file."""
    with np.load(path) as f:
        return int(f["leaf_0"].shape[0])


def load_train_state(path: str, state, schedulers: Sequence,
                     with_best_params: bool = False):
    """Restore a ``save_train_state`` file into ``state`` (params and
    moments in place, so the optimizer keeps its tensors; the generator
    state; the lr) and into ``schedulers``.  Returns (step, best,
    best_params): the list of each item's bookkeeping dict and, with
    ``with_best_params``, of its best params or None (else None)."""
    n = len(schedulers)
    template = _state_tree(state, 0, schedulers,
                           [dict.fromkeys(BEST_KEYS, 0.0)] * n,
                           [None] * n if with_best_params else None)
    data = load_pytree(path, template)
    with torch.no_grad():
        for p, v in zip(param_leaves(state.params),
                        param_leaves(data["params"])):
            p.copy_(v)
    _set_moments(state.opt, data["mu"], data["nu"], data["count"],
                 data["lr"])
    state.generator.set_state(data["generator"].cpu())
    for s, (lr, best_metric, num_bad) in zip(schedulers, data["scheduler"]):
        s.lr, s.best, s.num_bad = float(lr), float(best_metric), int(num_bad)
    best = [{k: (int(v) if k == "iter" else float(v))
             for k, v in zip(BEST_KEYS, row)} for row in data["best"]]
    best_params = None
    if with_best_params:
        best_params = [bp if has else None for bp, has in
                       zip(data["best_params"], data["has_best_params"])]
    return int(data["step"]), best, best_params
