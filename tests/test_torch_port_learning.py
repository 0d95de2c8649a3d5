"""Learning parity of the port against the JAX package over hundreds of
steps (slow tier, as tests/test_cross_framework.py).

One fold of a Gdataset-like synthetic problem (150 drugs x 100 diseases,
600 positives) trains 400 steps with an eval every 100, at small widths in
grid mode, through each package's own ``train_fold`` with its default
augmentation and dropout, for four seeds.  The two packages draw different
random numbers, so only the outcome is compared: the mean over the seeds
of the best test AUROC within 0.1 of the JAX mean, and of the best test
AUPR within 0.05, and both packages learn (mean AUROC > 0.65).  The
tolerances were set from the spread measured first: at this size one
seed's best AUROC ranges from 0.65 to 0.93 and its AUPR from 0.16 to 0.33
within either package.  (With dropout and augmentation off, the two runs
follow the same math from the same params, but Adam amplifies the float
summation order of near-zero gradients into parameter differences of 0.1
within 100 steps, and at this size such a run does not learn.)  Both run
their plain decoders: the JAX fused decoders' dropout draws from the TPU's
PRNG, which interpret mode on the CPU does not have.
"""

import jax
import numpy as np
import pytest

from dream_gnn_tpu.config import ModelConfig as JModel
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu.train.loop import train_fold as j_train_fold
from dream_gnn_tpu_torch.config import ModelConfig as TModel
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.data.loader import DreamDataset as TDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data as t_raw
from dream_gnn_tpu_torch.train.loop import fold_generator
from dream_gnn_tpu_torch.train.loop import train_fold as t_train_fold

DATA = dict(n_drug=150, n_dis=100, n_pos=600, seed=4)
MODEL = dict(layers=2, gcn_agg_units=96, gcn_out_units=32, nhid1=64,
             nhid2=32, decode_mode="grid", decoder_backend="xla",
             compute_dtype="bfloat16")
TRAIN = dict(train_max_iter=401, train_valid_interval=100)
SEEDS = (7, 8, 9, 10)


@pytest.mark.slow
def test_port_learns_as_the_jax_package_does():
    jds = JDataset(j_raw(**DATA), k=4)
    tds = TDataset(t_raw(**DATA), k=4, device="cpu")
    jcfg = JTrain(model=JModel(**MODEL), **TRAIN)
    tcfg = TTrain(model=TModel(**MODEL), **TRAIN)
    j = np.array([[r["best_auroc"], r["best_aupr"]] for r in (
        j_train_fold(jds, 0, jcfg, jax.random.key(s), verbose=False)
        for s in SEEDS)])
    t = np.array([[r["best_auroc"], r["best_aupr"]] for r in (
        t_train_fold(tds, 0, tcfg, fold_generator(s, 0, "cpu"),
                     verbose=False) for s in SEEDS)])
    jm, tm = j.mean(axis=0), t.mean(axis=0)
    assert jm[0] > 0.65 and tm[0] > 0.65, (jm, tm)
    assert abs(tm[0] - jm[0]) <= 0.1, (t, j)
    assert abs(tm[1] - jm[1]) <= 0.05, (t, j)
