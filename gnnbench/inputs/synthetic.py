"""Synthetic drug-disease data in the schema of the Gdataset ``.mat`` file,
made from the run's seed.

Copied, frozen, from ``dream_gnn_tpu_torch/data/synthetic.py``
(``synthetic_raw_data``): the same planted low-rank association model, the
same cosine similarity matrices and the same 768-d embeddings, with the
sizes given by the configuration file instead of a preset table.  The
arrays are the ``.mat`` keys the loader reads (``didr`` transposed,
``drug``, ``disease``, ``drug_embed``, ``disease_embed``).

The program never reads this file: the harness makes the arrays and hands
the same arrays to the program's loader and to the plain reference.
"""

from __future__ import annotations

import numpy as np


def raw_arrays(n_drug: int, n_dis: int, n_pos: int, embed_dim: int,
               latent_dim: int, seed: int) -> dict:
    """The five arrays of a dataset with ``n_pos`` associations."""
    rng = np.random.default_rng(seed)
    zd = rng.normal(size=(n_drug, latent_dim))
    zv = rng.normal(size=(n_dis, latent_dim))

    scores = zd @ zv.T / np.sqrt(latent_dim) + 0.5 * rng.normal(
        size=(n_drug, n_dis))
    thresh = np.partition(scores.reshape(-1), -n_pos)[-n_pos]
    association = (scores >= thresh).astype(np.float32)

    def cosine(z):
        nz = z / np.linalg.norm(z, axis=1, keepdims=True)
        return ((nz @ nz.T + 1.0) / 2.0).astype(np.float32)

    drug_sim = cosine(zd + 0.1 * rng.normal(size=zd.shape))
    dis_sim = cosine(zv + 0.1 * rng.normal(size=zv.shape))
    np.fill_diagonal(drug_sim, 1.0)
    np.fill_diagonal(dis_sim, 1.0)

    proj_d = rng.normal(size=(latent_dim, embed_dim)) / np.sqrt(latent_dim)
    proj_v = rng.normal(size=(latent_dim, embed_dim)) / np.sqrt(latent_dim)
    drug_embed = zd @ proj_d + 0.1 * rng.normal(size=(n_drug, embed_dim))
    dis_embed = zv @ proj_v + 0.1 * rng.normal(size=(n_dis, embed_dim))
    return dict(association=association, drug_sim=drug_sim, dis_sim=dis_sim,
                drug_embed=drug_embed.astype(np.float32),
                dis_embed=dis_embed.astype(np.float32))
