"""Dataset assembly: raw data -> device-resident fold tensors.

Port of ``dream_gnn_tpu/data/loader.py`` (reference ``DrugDataLoader``,
data_loader.py:41-597).  Host numpy builds splits and graph layouts
once; everything the train loop touches is a tensor on ``device``.

Reference parity notes:
- node features are the L2-row-normalised pretrained embeddings
  (data_loader.py:205-228);
- the FGCN inputs are the *raw* similarity-matrix rows;
- the "fold-specific" similarity/feature kNN graphs are in fact
  fold-invariant (built from full matrices every fold; SURVEY.md
  §7.3.11) — built once here;
- the test encoder graph is built from the *test* pairs with their true
  labels as edge types and is what evaluation runs on (parity trap
  §7.3.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from dream_gnn_tpu_torch.augment.masks import (feature_masking, feature_noise,
                                               mixup_features)
from dream_gnn_tpu_torch.config import AugmentConfig
from dream_gnn_tpu_torch.data.matio import load_mat
from dream_gnn_tpu_torch.data.splits import FoldSplit, make_cv_splits
from dream_gnn_tpu_torch.data.synthetic import RawData, synthetic_raw_data
from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph, build_enc_graph
from dream_gnn_tpu_torch.graph.knn import (NormAdj, feature_knn_graph,
                                           knn_sim_graph)
from dream_gnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FoldData:
    """Tensors for one CV fold.

    The decoder edge lists are padded to dataset-wide budgets so every
    fold has one shape; ``train_w``/``test_w`` are 1/0 validity weights.
    """

    train_enc: BipartiteGraph
    train_src: torch.Tensor         # (E_train,) int32, pair order
    train_dst: torch.Tensor
    train_labels: torch.Tensor      # (E_train,) float32
    test_enc: BipartiteGraph
    test_src: torch.Tensor
    test_dst: torch.Tensor
    test_labels: torch.Tensor
    train_w: torch.Tensor
    test_w: torch.Tensor


def _l2(x):
    n = np.linalg.norm(x, axis=1, keepdims=True)
    n[n == 0] = 1.0
    return (x / n).astype(np.float32)


class DreamDataset:
    """Loads/generates a dataset and materialises its folds on ``device``."""

    def __init__(self, raw: RawData, *, k: int = 4, symm: bool = True,
                 n_folds: int = 10, kfold_seed: int = 1024,
                 embedding_mode: str = "pretrained",
                 embedding_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.raw = raw
        self.n_drug = raw.n_drug
        self.n_dis = raw.n_dis
        self.k = k
        self.symm = symm
        dev = self.device

        # Features: L2-normalised embeddings (data_loader.py:221-222).
        if embedding_mode == "random":
            # Reference --embedding_mode random: N(0, 0.1) 768-d node
            # features (data_loader.py:209-218); the kNN *feature* graphs
            # still use the raw embeds.
            rng = np.random.default_rng(embedding_seed)
            drug = _l2(rng.normal(0, 0.1, (raw.n_drug, 768)))
            dis = _l2(rng.normal(0, 0.1, (raw.n_dis, 768)))
        elif embedding_mode == "pretrained":
            drug, dis = _l2(raw.drug_embed), _l2(raw.dis_embed)
        else:
            raise ValueError(f"embedding_mode must be 'pretrained' or "
                             f"'random', got {embedding_mode!r}")
        self.drug_feat = torch.as_tensor(drug, device=dev)
        self.dis_feat = torch.as_tensor(dis, device=dev)
        self.drug_sim_feat = torch.as_tensor(
            np.asarray(raw.drug_sim, np.float32), device=dev)
        self.dis_sim_feat = torch.as_tensor(
            np.asarray(raw.dis_sim, np.float32), device=dev)

        # Fold-invariant kNN graphs (built once; see module docstring).
        self.drug_graph: NormAdj = knn_sim_graph(raw.drug_sim, k, symm,
                                                 device=dev)
        self.dis_graph: NormAdj = knn_sim_graph(raw.dis_sim, k, symm,
                                                device=dev)
        self.drug_feature_graph: NormAdj = feature_knn_graph(
            raw.drug_embed, k, symm, device=dev)
        self.dis_feature_graph: NormAdj = feature_knn_graph(
            raw.dis_embed, k, symm, device=dev)

        self.splits: Dict[int, FoldSplit] = make_cv_splits(
            raw.association, n_folds=n_folds, seed=kfold_seed)
        self._folds: Dict[int, FoldData] = {}

    @classmethod
    def load(cls, name_or_path: str, *, k: int = 4, symm: bool = True,
             n_folds: int = 10, kfold_seed: int = 1024,
             embedding_mode: str = "pretrained",
             device="cuda") -> "DreamDataset":
        """Load a .mat file, or generate a synthetic preset by name."""
        if name_or_path.endswith(".mat"):
            raw = load_mat(name_or_path)
        else:
            raw = synthetic_raw_data(name_or_path)
        return cls(raw, k=k, symm=symm, n_folds=n_folds,
                   embedding_mode=embedding_mode, kfold_seed=kfold_seed,
                   device=device)

    def augment_features(self, generator: torch.Generator,
                         augment_cfg=None):
        """Loader-side feature augmentation (data_loader.py:511-542):
        Gaussian noise -> masking -> optional mixup over the normalised
        node features, drugs before diseases at each stage, every draw
        from ``generator`` (on the dataset's device).  Used by the
        novel-prediction path when ``--use_augmentation`` is on; the train
        loop's per-step augmentation lives in augment/masks.py.  Returns
        (drug_feat, dis_feat)."""
        cfg = augment_cfg or AugmentConfig()

        def noise(x):
            return feature_noise(x, torch.randn(
                x.shape, generator=generator, device=x.device,
                dtype=x.dtype), cfg.feature_noise_scale)

        drug, dis = noise(self.drug_feat), noise(self.dis_feat)
        drug = feature_masking(generator, drug, cfg.feature_mask_rate)
        dis = feature_masking(generator, dis, cfg.feature_mask_rate)
        if "mix_up" in cfg.methods:
            drug = mixup_features(generator, drug, cfg.mixup_alpha)
            dis = mixup_features(generator, dis, cfg.mixup_alpha)
        return drug, dis

    def _edge_budgets(self):
        """Dataset-wide (train, test) edge budgets: max over folds,
        rounded up to 256."""
        tr = max(s.train_pairs.shape[1] for s in self.splits.values())
        te = max(s.test_pairs.shape[1] for s in self.splits.values())
        rnd = lambda x: -(-x // 256) * 256  # noqa: E731
        return rnd(tr), rnd(te)

    def fold(self, cv: int) -> FoldData:
        if cv not in self._folds:
            s = self.splits[cv]
            dev = self.device

            def _pad(pairs, values, budget):
                e = pairs.shape[1]
                src = np.zeros(budget, np.int32)
                dst = np.zeros(budget, np.int32)
                lab = np.zeros(budget, np.float32)
                w = np.zeros(budget, np.float32)
                src[:e], dst[:e] = pairs[0], pairs[1]
                lab[:e] = values
                w[:e] = 1.0
                return tuple(torch.as_tensor(x, device=dev)
                             for x in (src, dst, lab, w))

            b_tr, b_te = self._edge_budgets()
            tr_src, tr_dst, tr_lab, tr_w = _pad(s.train_pairs,
                                                s.train_values, b_tr)
            te_src, te_dst, te_lab, te_w = _pad(s.test_pairs,
                                                s.test_values, b_te)
            self._folds[cv] = FoldData(
                train_enc=build_enc_graph(s.train_pairs, s.train_values,
                                          self.n_drug, self.n_dis, self.symm,
                                          device=dev),
                train_src=tr_src, train_dst=tr_dst, train_labels=tr_lab,
                test_enc=build_enc_graph(s.test_pairs, s.test_values,
                                         self.n_drug, self.n_dis, self.symm,
                                         device=dev),
                test_src=te_src, test_dst=te_dst, test_labels=te_lab,
                train_w=tr_w, test_w=te_w,
            )
        return self._folds[cv]
