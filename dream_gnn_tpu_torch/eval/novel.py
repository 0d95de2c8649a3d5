"""Novel-prediction reporting (reference ``get_top_novel_predictions``,
train.py:26-151).

Port of ``dream_gnn_tpu/eval/novel.py``.  Scores every zero cell of the
association matrix with the trained model, the encoder on the fold's
*train* encoder graph (train.py:80-84), applies a sigmoid and writes the
top-k pairs (with drug names when the dataset has them) to CSV.

The reference batches candidate pairs 5000 at a time and rebuilds a DGL
decoder graph per batch; here all candidates are scored in one eval
forward.  In grid mode that is one grid forward (on the card, one launch
of the grid decoder kernel) whose zero cells are picked; in edges mode one
per-edge forward over the list of all zero cells (one launch of the edge
decoder kernel).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from dream_gnn_tpu_torch.config import ModelConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.model.dream_gnn import forward, map_params
from dream_gnn_tpu_torch.train.loop import fold_inputs

CSV_COLUMNS = ("drug_id", "disease_id", "score")


@torch.no_grad()
def novel_scores(params, model_cfg: ModelConfig, dataset: DreamDataset,
                 cv: int, use_augmentation: bool = False, augment_cfg=None,
                 augment_generator: Optional[torch.Generator] = None):
    """(drug ids, disease ids, sigmoid scores) of every zero cell of the
    association matrix, in row-major order, as numpy arrays.  ``params``
    may lie anywhere; they are moved to the dataset's device.

    ``use_augmentation``: reference --use_augmentation, one loader-side
    feature-augmentation draw (noise -> masking [-> mixup]) from
    ``augment_generator`` applied to the node features of the forward
    (data_loader.py:518,559 via get_graph_data_for_training,
    train.py:87-93)."""
    device = dataset.device
    params = map_params(lambda t: t.detach().to(device), params)
    inputs, _, _, _ = fold_inputs(dataset, cv)
    if use_augmentation:
        gen = augment_generator if augment_generator is not None \
            else torch.Generator(device=device).manual_seed(0)
        drug_feat, dis_feat = dataset.augment_features(gen, augment_cfg)
        inputs = dataclasses.replace(inputs, drug_feat=drug_feat,
                                     dis_feat=dis_feat)

    zr, zc = np.nonzero(np.asarray(dataset.raw.association) == 0)
    if model_cfg.decode_mode == "grid":
        pred, *_ = forward(params, inputs, model_cfg, train=False)
        rows = torch.as_tensor(zr, device=device)
        cols = torch.as_tensor(zc, device=device)
        pred = pred[rows, cols]
    else:
        # The edge list of all zero cells; an eval forward has no backward,
        # so no CSR ordering is built.
        candidates = dataclasses.replace(
            inputs, dec_src=torch.as_tensor(zr, dtype=torch.int32,
                                            device=device),
            dec_dst=torch.as_tensor(zc, dtype=torch.int32, device=device),
            dec_csr=None)
        pred, *_ = forward(params, candidates, model_cfg, train=False)
    return zr, zc, torch.sigmoid(pred).cpu().numpy()


def get_top_novel_predictions(params, model_cfg: ModelConfig,
                              dataset: DreamDataset, cv: int,
                              top_k: int = 200,
                              save_path: Optional[str] = None,
                              use_augmentation: bool = False,
                              augment_cfg=None,
                              augment_generator: Optional[
                                  torch.Generator] = None):
    """Returns a list of dicts {drug_id, disease_id, score[, drug_name]},
    best first, and writes them to ``save_path`` when it is given.  The
    arguments are those of ``novel_scores``."""
    zr, zc, scores = novel_scores(params, model_cfg, dataset, cv,
                                  use_augmentation, augment_cfg,
                                  augment_generator)
    order = np.argsort(-scores)[:top_k]
    rows = []
    for i in order:
        row = dict(drug_id=int(zr[i]), disease_id=int(zc[i]),
                   score=float(scores[i]))
        if dataset.raw.drug_ids is not None:
            row["drug_name"] = dataset.raw.drug_ids[int(zr[i])]
        rows.append(row)

    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        cols = list(rows[0].keys()) if rows else list(CSV_COLUMNS)
        with open(save_path, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in rows:
                f.write(",".join(str(row[c]) for c in cols) + "\n")
    return rows
