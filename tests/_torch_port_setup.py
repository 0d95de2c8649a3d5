"""Small shared setup for the PyTorch port's cross-framework tests.

Both packages get the same synthetic data (made from a seed with numpy)
and, where a test needs it, the same JAX-initialised weights carried
across with ``dream_gnn_tpu_torch.convert.params_from_jax``.
"""

import dataclasses

import jax
import numpy as np

from dream_gnn_tpu.config import ModelConfig as JModelConfig
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu.train.loop import derive_model_cfg as j_derive
from dream_gnn_tpu_torch.config import ModelConfig as TModelConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset as TDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data as t_raw
from dream_gnn_tpu_torch.train.loop import derive_model_cfg as t_derive

SMALL_DATA = dict(n_drug=40, n_dis=30, n_pos=60, seed=3)
SMALL_MODEL = dict(layers=2, gcn_agg_units=48, gcn_out_units=16,
                   nhid1=32, nhid2=16, decode_mode="grid",
                   decoder_backend="pallas")


def datasets(k=4):
    """(JAX dataset, port dataset on the CPU) of the small preset."""
    return (JDataset(j_raw(**SMALL_DATA), k=k),
            TDataset(t_raw(**SMALL_DATA), k=k, device="cpu"))


def model_cfgs(jds, tds, train_cfg_j=None, train_cfg_t=None, **overrides):
    """Derived (JAX, port) ModelConfigs with the small widths."""
    kw = dict(SMALL_MODEL, **overrides)
    jm, tm = JModelConfig(**kw), TModelConfig(**kw)
    from dream_gnn_tpu.config import TrainConfig as JT
    from dream_gnn_tpu_torch.config import TrainConfig as TT
    return (j_derive(dataclasses.replace(train_cfg_j or JT(), model=jm), jds),
            t_derive(dataclasses.replace(train_cfg_t or TT(), model=tm), tds))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)
