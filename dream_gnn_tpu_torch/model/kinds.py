"""The model kinds: 'dream', DREAM-GNN's dual route (model/dream_gnn.py),
and 'gcmc', GCMC alone as DGL's ``examples/pytorch/gcmc`` trains it
(model/gcmc_alone.py).  ``kind_of`` is the one reader of
``ModelConfig.model_kind``; the step (train/step.py) and the loop
(train/loop.py) look the kind up when they are built.  A new kind is a
module with its init and forward, and one entry of ``KINDS``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Tuple

from dream_gnn_tpu_torch.config import ModelConfig
from dream_gnn_tpu_torch.model import dream_gnn, gcmc_alone
from dream_gnn_tpu_torch.train.losses import softmax_cross_entropy, total_loss
from dream_gnn_tpu_torch.utils.metrics import (aupr_masked, auroc_masked,
                                               rmse_expected)


@dataclasses.dataclass(frozen=True)
class ModelKind:
    """What one model kind trains and scores."""

    name: str
    init: Callable        # (generator, model_cfg) -> params
    # (params, inputs, model_cfg, *, train, generator, edge_masks)
    # -> (pred, *outs): the logits and the node outputs
    forward: Callable
    # (pred, labels, weight, outs, train_cfg, group) -> the loss of the
    # targets of step.decoder_targets; group: a candidate-sharded decoder's
    loss: Callable
    # (pred, labels, weight, model_cfg) -> device scalars, metric_names
    metrics: Callable
    metric_names: Tuple[str, ...]
    sides: Tuple[str, ...]     # evaluated at each interval, in CSV order
    score: str                 # the CSV column of the best iteration and
    higher_is_better: bool     # of the plateau LR, and its direction
    # Each best metric before the first eval, the test side's named
    # plainly (aupr, not test_aupr) as in results and checkpoints.
    unscored: Mapping[str, float]
    stacks: bool               # trained as a fold stack (train/stacked.py)


KINDS = {
    "dream": ModelKind(
        name="dream", init=dream_gnn.init_params, forward=dream_gnn.forward,
        loss=lambda pred, labels, weight, outs, train_cfg, group: total_loss(
            pred, labels, *outs, beta=train_cfg.beta,
            smoothing=train_cfg.label_smoothing, weight=weight,
            group=group)[0],
        metrics=lambda pred, labels, weight, cfg: (
            auroc_masked(labels, pred, weight),
            aupr_masked(labels, pred, weight)),
        metric_names=("auroc", "aupr"), sides=("train", "test"),
        score="test_aupr", higher_is_better=True,
        unscored=dict(aupr=-1.0, auroc=0.0, train_aupr=0.0,
                      train_auroc=0.0),
        stacks=True),
    # DGL's example: the RMSE of the valid and the test ratings, the best
    # iteration and the plateau by the lowest valid RMSE.
    "gcmc": ModelKind(
        name="gcmc", init=gcmc_alone.init_params, forward=gcmc_alone.forward,
        loss=lambda pred, labels, weight, outs, train_cfg, group:
            softmax_cross_entropy(pred, labels, weight),
        metrics=lambda pred, labels, weight, cfg: (
            rmse_expected(pred, labels, weight, cfg.rating_values),),
        metric_names=("rmse",), sides=("valid", "test"),
        score="valid_rmse", higher_is_better=False,
        unscored=dict(valid_rmse=math.inf, rmse=math.inf), stacks=False),
}


def kind_of(cfg: ModelConfig) -> ModelKind:
    """The ``ModelKind`` that ``cfg.model_kind`` names."""
    kind = KINDS.get(cfg.model_kind)
    if kind is None:
        raise ValueError(f"model_kind={cfg.model_kind!r}: the known kinds "
                         f"are {', '.join(map(repr, KINDS))}")
    return kind


def init_params(gen, cfg: ModelConfig):
    """The params of ``cfg``'s model kind, drawn from ``gen``."""
    return kind_of(cfg).init(gen, cfg)
