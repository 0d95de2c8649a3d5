"""The port's ``.mat`` loader, the CLI's dataset resolution and the
loader-side feature augmentation, against the JAX package.

- ``load_mat`` of a file that the JAX ``save_mat`` wrote equals the JAX
  ``load_mat``, array by array and exactly (the same file, the same numpy
  draws for missing embeddings), with and without embeddings and
  ``Wrname``; and the JAX loader reads the port's ``save_mat`` file.
- The CLI trains on the reference ``raw_data/drug_data/<name>/<name>.mat``
  under the working directory and on ``--data_path``, as the JAX CLI's
  ``resolve_dataset`` does.
- ``mask_features`` and ``mix_rows`` given the JAX functions' own draws
  equal the JAX ``feature_masking`` and ``mixup_features`` (exact for the
  mask; rtol 1e-6 for the mix, the same f32 products in another fused
  order).  The port's draws come from a ``torch.Generator``, so they are
  held by their statistics: keep rate within 0.01 of 1 - rate over 60,000
  values, the Beta(0.2, 0.2) coefficients' mean within 0.05 of 0.5 over
  400 draws.
"""

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from dream_gnn_tpu.augment.masks import feature_masking as j_feature_masking
from dream_gnn_tpu.augment.masks import mixup_features as j_mixup_features
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.matio import load_mat as j_load_mat
from dream_gnn_tpu.data.matio import save_mat as j_save_mat
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu_torch.augment.masks import (beta_sample, feature_masking,
                                               mask_features, mix_rows,
                                               mixup_features)
from dream_gnn_tpu_torch.config import AugmentConfig
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.matio import load_mat, save_mat
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.train import cli

SMALL = ["--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
         "--nhid1", "32", "--nhid2", "16"]
DATA = dict(n_drug=40, n_dis=30, n_pos=60, seed=3)
FIELDS = ("association", "drug_sim", "dis_sim", "drug_embed", "dis_embed")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_raw(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.drug_ids == b.drug_ids


def _write_minimal(path, raw, embeds: bool, names: bool):
    """A .mat with the required keys and optionally the embeddings and
    ``Wrname``, as the reference datasets come in either form."""
    data = {"didr": raw.association.T, "drug": raw.drug_sim,
            "disease": raw.dis_sim}
    if embeds:
        data.update(drug_embed=raw.drug_embed, disease_embed=raw.dis_embed)
    if names:
        data["Wrname"] = np.array([[s] for s in raw.drug_ids], dtype=object)
    sio.savemat(path, data)


@pytest.mark.parametrize("embeds,names", [(True, True), (False, True),
                                          (True, False), (False, False)])
def test_load_mat_matches_jax(tmp_path, embeds, names):
    path = str(tmp_path / "d.mat")
    raw = j_raw(**DATA)
    if embeds and names:
        j_save_mat(path, raw)
    else:
        _write_minimal(path, raw, embeds, names)
    ours, ref = load_mat(path, seed=5), j_load_mat(path, seed=5)
    _assert_same_raw(ours, ref)
    assert (ours.drug_ids is not None) == names
    if not embeds:
        assert ours.drug_embed.shape == (40, 768)


def test_jax_reads_the_port_save_mat(tmp_path):
    path = str(tmp_path / "d.mat")
    raw = synthetic_raw_data(**DATA)
    save_mat(path, raw)
    _assert_same_raw(j_load_mat(path), load_mat(path))
    _assert_same_raw(load_mat(path), raw)


def test_dataset_load_mat_matches_jax(tmp_path):
    """``DreamDataset.load`` of a .mat gives the JAX loader's dataset of the
    same file exactly: features, similarity rows, the kNN graphs and a
    fold's graphs.  (A .mat loads in column-major order, so its L2-normed
    features may differ from the in-memory preset's in the last f32 ulp;
    both packages see the same.)"""
    path = str(tmp_path / "d.mat")
    raw = synthetic_raw_data(**DATA)
    save_mat(path, raw)
    a, j = DreamDataset.load(path, device="cpu"), JDataset.load(path)
    _assert_same_raw(a.raw, raw)
    for name in ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    for name in ("drug_graph", "dis_graph", "drug_feature_graph",
                 "dis_feature_graph"):
        np.testing.assert_array_equal(getattr(a, name).a.numpy(),
                                      np.asarray(getattr(j, name).a), name)
    np.testing.assert_array_equal(a.fold(2).train_enc.a1.numpy(),
                                  np.asarray(j.fold(2).train_enc.a1))


def _argv(save_dir, *extra):
    return ["--device", "-1", "--seeds", "1", "--folds", "0",
            "--train_max_iter", "5", "--train_valid_interval", "2",
            "--save_dir", str(save_dir), *SMALL, *extra]


def _spy(monkeypatch):
    """Capture the dataset that the CLI resolves, and still train on it."""
    seen = {}
    real = cli.run_experiments

    def spy(dataset, cfg, **kw):
        seen["dataset"] = dataset
        return real(dataset, cfg, **kw)

    monkeypatch.setattr(cli, "run_experiments", spy)
    return seen


def test_cli_trains_on_the_reference_mat(tmp_path, monkeypatch):
    """With raw_data/drug_data/Gdataset/Gdataset.mat under the working
    directory the CLI trains on that file, as the JAX CLI does, and not on
    the 593 x 313 preset of the same name."""
    mat = tmp_path / "raw_data" / "drug_data" / "Gdataset" / "Gdataset.mat"
    mat.parent.mkdir(parents=True)
    raw = j_raw(**DATA)
    j_save_mat(str(mat), raw)
    monkeypatch.chdir(tmp_path)
    seen = _spy(monkeypatch)
    summary = cli.main(_argv(tmp_path / "out", "--data_name", "Gdataset"))
    _assert_same_raw(seen["dataset"].raw, j_load_mat(str(mat)))
    assert (tmp_path / "out" / "seed_1" / "test_metric1.csv").exists()
    assert 0.0 <= summary["mean_auroc"] <= 1.0


def test_cli_trains_on_data_path(tmp_path, monkeypatch):
    path = tmp_path / "elsewhere.mat"
    save_mat(str(path), synthetic_raw_data(**DATA))
    seen = _spy(monkeypatch)
    cli.main(_argv(tmp_path / "out", "--data_path", str(path)))
    _assert_same_raw(seen["dataset"].raw, load_mat(str(path)))
    rows = (tmp_path / "out" / "seed_1" / "test_metric1.csv").read_text()
    assert [r.split(",")[0] for r in rows.split()[1:]] == ["2", "4"]


def test_cli_without_a_mat_trains_the_preset(tmp_path, monkeypatch):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    monkeypatch.chdir(tmp_path)
    seen = _spy(monkeypatch)
    cli.main(_argv(tmp_path / "out", "--data_name", "tiny"))
    assert seen["dataset"].n_drug == 40
    _assert_same_raw(seen["dataset"].raw, synthetic_raw_data("tiny"))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_features_matches_jax_with_its_draws(rate):
    key = jax.random.key(4)
    x = np.random.default_rng(0).normal(size=(37, 24)).astype(np.float32)
    u = np.array(jax.random.uniform(key, x.shape))
    want = np.asarray(j_feature_masking(key, x, rate))
    got = mask_features(torch.from_numpy(x), torch.from_numpy(u), rate)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mix_rows_matches_jax_with_its_draws(alpha):
    key = jax.random.key(9)
    x = np.random.default_rng(1).normal(size=(29, 16)).astype(np.float32)
    kp, kl = jax.random.split(key)
    perm = np.array(jax.random.permutation(kp, x.shape[0]))
    lam = np.asarray(jax.random.beta(kl, alpha, alpha))
    want = np.asarray(j_mixup_features(key, x, alpha))
    got = mix_rows(torch.from_numpy(x), torch.from_numpy(perm),
                   torch.tensor(lam, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_port_draws_have_the_jax_statistics():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(300, 200)
    kept = float(feature_masking(gen, x, 0.1).mean())
    assert abs(kept - 0.9) < 0.01
    lams = np.array([float(beta_sample(gen, 0.2, "cpu"))
                     for _ in range(400)])
    assert ((lams >= 0) & (lams <= 1)).all()
    assert abs(lams.mean() - 0.5) < 0.05
    # Beta(0.2, 0.2) puts most of its mass near 0 and 1.
    assert ((lams < 0.1) | (lams > 0.9)).mean() > 0.5
    x = torch.arange(12.0).reshape(6, 2)
    mixed = mixup_features(gen, x, 0.2)
    assert mixed.shape == x.shape and bool(torch.isfinite(mixed).all())


def test_augment_features_pipeline():
    """Noise, then masking, then (with "mix_up") a row mix; one generator
    seed gives one result."""
    ds = DreamDataset(synthetic_raw_data(**DATA), device="cpu")
    cfg = AugmentConfig(feature_noise_scale=0.05, feature_mask_rate=0.3)
    d1, v1 = ds.augment_features(torch.Generator().manual_seed(7), cfg)
    d2, v2 = ds.augment_features(torch.Generator().manual_seed(7), cfg)
    assert torch.equal(d1, d2) and torch.equal(v1, v2)
    assert d1.shape == ds.drug_feat.shape and v1.shape == ds.dis_feat.shape
    zero = float((d1 == 0).float().mean())
    assert abs(zero - 0.3) < 0.03
    kept = d1 != 0
    noise = (d1 - ds.drug_feat)[kept]
    assert abs(float(noise.std()) - 0.05) < 0.005
    mix = AugmentConfig(methods=("edge_dropout", "mix_up"),
                        feature_mask_rate=0.0)
    d3, _ = ds.augment_features(torch.Generator().manual_seed(7), mix)
    assert not torch.equal(d3, d1)
