""".mat dataset IO (reference ``_load_raw_data``, data_loader.py:99-134).

Port of ``dream_gnn_tpu/data/matio.py``: the same arrays for the same file
and seed.  Expected keys: ``didr`` (disease x drug; transposed on load),
``drug``, ``disease``, and optionally ``drug_embed`` / ``disease_embed`` /
``Wrname``.  Missing embeddings fall back to N(0, 0.1) 768-d draws from
``np.random.default_rng(seed)`` (data_loader.py:119-129), the same numpy
draws as the JAX loader's.  scipy is imported when a file is read or
written.
"""

from __future__ import annotations

import numpy as np

from dream_gnn_tpu_torch.data.synthetic import RawData


def _unwrap(x) -> str:
    """A ``Wrname`` cell loads with varying nesting depth; dig to the str."""
    while isinstance(x, np.ndarray):
        x = x[0]
    return str(x).strip()


def load_mat(path: str, *, embed_dim: int = 768, seed: int = 0) -> RawData:
    import scipy.io as sio

    data = sio.loadmat(path)
    association = np.asarray(data["didr"]).T.astype(np.float32)
    n_drug, n_dis = association.shape

    rng = np.random.default_rng(seed)
    drug_embed = (np.asarray(data["drug_embed"], np.float32)
                  if "drug_embed" in data
                  else rng.normal(0, 0.1, (n_drug, embed_dim)).astype(
                      np.float32))
    dis_embed = (np.asarray(data["disease_embed"], np.float32)
                 if "disease_embed" in data
                 else rng.normal(0, 0.1, (n_dis, embed_dim)).astype(
                     np.float32))
    drug_ids = ([_unwrap(x) for x in np.asarray(data["Wrname"]).reshape(-1)]
                if "Wrname" in data else None)

    return RawData(
        association=association,
        drug_sim=np.asarray(data["drug"], np.float32),
        dis_sim=np.asarray(data["disease"], np.float32),
        drug_embed=drug_embed, dis_embed=dis_embed, drug_ids=drug_ids)


def save_mat(path: str, raw: RawData) -> None:
    """Write a RawData in the reference's .mat schema."""
    import scipy.io as sio

    sio.savemat(path, {
        "didr": raw.association.T,
        "drug": raw.drug_sim,
        "disease": raw.dis_sim,
        "drug_embed": raw.drug_embed,
        "disease_embed": raw.dis_embed,
        "Wrname": np.array([[s] for s in (raw.drug_ids or [])],
                           dtype=object),
    })
