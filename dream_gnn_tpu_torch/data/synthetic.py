"""Synthetic drug-repositioning datasets.

A copy of ``dream_gnn_tpu/data/synthetic.py``: the same arrays for the
same seed.  The reference dataset ``.mat`` blobs (lrssl / Gdataset /
Cdataset) are not redistributable, so the framework ships a generator
producing data with the same schema and statistics: a sparse low-rank-plus-noise association matrix (~1%
positive rate), cosine-style similarity matrices, and 768-d pretrained
style embeddings — all derived from shared latent factors so the
planted structure is learnable and AUROC/AUPR are meaningful.

Named presets mirror the published dataset scales (BASELINE.md):
Gdataset 593x313 / ~1933 positives, Cdataset 663x409 / ~2532,
lrssl 763x681 / ~3051.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PRESETS = {
    "Gdataset": (593, 313, 1933),
    "Cdataset": (663, 409, 2532),
    "lrssl": (763, 681, 3051),
}


@dataclasses.dataclass
class RawData:
    """Schema of a loaded dataset (.mat keys, data_loader.py:109-129)."""

    association: np.ndarray         # (n_drug, n_dis) binary — 'didr'.T
    drug_sim: np.ndarray            # (n_drug, n_drug) — 'drug'
    dis_sim: np.ndarray             # (n_dis, n_dis) — 'disease'
    drug_embed: np.ndarray          # (n_drug, 768) — 'drug_embed'
    dis_embed: np.ndarray           # (n_dis, 768) — 'disease_embed'
    drug_ids: list | None = None    # 'Wrname'

    @property
    def n_drug(self):
        return self.association.shape[0]

    @property
    def n_dis(self):
        return self.association.shape[1]


def synthetic_raw_data(name: str = "Gdataset", *, n_drug: int | None = None,
                       n_dis: int | None = None, n_pos: int | None = None,
                       latent_dim: int = 32, embed_dim: int = 768,
                       seed: int = 0) -> RawData:
    """Generate a RawData with planted low-rank structure."""
    if name in PRESETS:
        d, v, p = PRESETS[name]
        n_drug = n_drug or d
        n_dis = n_dis or v
        n_pos = n_pos or p
    if not (n_drug and n_dis and n_pos):
        raise ValueError(
            f"unknown dataset {name!r}: pass a .mat path, one of "
            f"{sorted(PRESETS)}, or explicit n_drug/n_dis/n_pos")

    rng = np.random.default_rng(seed)
    zd = rng.normal(size=(n_drug, latent_dim))
    zv = rng.normal(size=(n_dis, latent_dim))

    # Associations: top-n_pos scores of the latent inner product + noise.
    scores = zd @ zv.T / np.sqrt(latent_dim) + 0.5 * rng.normal(
        size=(n_drug, n_dis))
    thresh = np.partition(scores.reshape(-1), -n_pos)[-n_pos]
    association = (scores >= thresh).astype(np.float32)

    def _cosine(z):
        nz = z / np.linalg.norm(z, axis=1, keepdims=True)
        sim = nz @ nz.T
        return ((sim + 1.0) / 2.0).astype(np.float32)  # map to [0, 1]

    drug_sim = _cosine(zd + 0.1 * rng.normal(size=zd.shape))
    dis_sim = _cosine(zv + 0.1 * rng.normal(size=zv.shape))
    np.fill_diagonal(drug_sim, 1.0)
    np.fill_diagonal(dis_sim, 1.0)

    proj_d = rng.normal(size=(latent_dim, embed_dim)) / np.sqrt(latent_dim)
    proj_v = rng.normal(size=(latent_dim, embed_dim)) / np.sqrt(latent_dim)
    drug_embed = (zd @ proj_d + 0.1 * rng.normal(size=(n_drug, embed_dim)))
    dis_embed = (zv @ proj_v + 0.1 * rng.normal(size=(n_dis, embed_dim)))

    return RawData(association=association, drug_sim=drug_sim, dis_sim=dis_sim,
                   drug_embed=drug_embed.astype(np.float32),
                   dis_embed=dis_embed.astype(np.float32),
                   drug_ids=[f"DB{i:05d}" for i in range(n_drug)])
