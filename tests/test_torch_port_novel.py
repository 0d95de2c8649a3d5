"""Novel predictions: the port's ``get_top_novel_predictions`` against the
JAX package's, from the same JAX-initialised params carried across.

Both score every zero cell of the association matrix with the encoder on
the fold's train graph; here with ``top_k`` = all 1,140 zero cells, so the
whole ranking is compared.  Tolerance: each pair's score within 1e-5
absolute (fp32 sigmoids of logits that agree to rtol 1e-4, as
tests/test_torch_port_model.py holds the forward); the CSV has the JAX
columns and row count.  The JAX fused decoders run their Pallas kernels in
interpret mode; the port runs the plain versions (CPU tensors).  With
``--use_augmentation`` both sides get the JAX ``augment_features`` draw
(the port's own draws come from a ``torch.Generator`` and are held by
their statistics in tests/test_torch_port_matio.py).  Through the CLI, the
top-k CSVs are written in sequence and fold-parallel, only with
``--save_model`` and not by the seed-parallel path, as in JAX.
"""

import os

import jax
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.eval.novel import \
    get_top_novel_predictions as j_top_novel
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.eval.novel import get_top_novel_predictions
from dream_gnn_tpu_torch.train.cli import main
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

SMALL = ["--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
         "--nhid1", "32", "--nhid2", "16"]
N_ZERO = 40 * 30 - 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


@pytest.fixture(scope="module")
def data():
    return datasets()


def _compare(jrows, trows):
    assert len(trows) == len(jrows) == N_ZERO
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    j = {(r["drug_id"], r["disease_id"]): r for r in jrows}
    t = {(r["drug_id"], r["disease_id"]): r for r in trows}
    assert set(j) == set(t)
    for pair, row in t.items():
        assert abs(row["score"] - j[pair]["score"]) <= 1e-5, pair
        assert row["drug_name"] == j[pair]["drug_name"]
    scores = [r["score"] for r in trows]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("mode,backend", [("grid", "pallas"),
                                          ("edges", "pallas"),
                                          ("grid", "xla"), ("edges", "xla")])
def test_novel_predictions_match_jax(data, tmp_path, mode, backend):
    jds, tds = data
    jcfg, tcfg = model_cfgs(jds, tds, compute_dtype="float32",
                            decoder_backend=backend, decode_mode=mode)
    jparams = j_init(jax.random.key(5), jcfg)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jrows = j_top_novel(jparams, jcfg, jds, 2, top_k=N_ZERO, save_path=jpath)
    trows = get_top_novel_predictions(tparams, tcfg, tds, 2, top_k=N_ZERO,
                                      save_path=tpath)
    _compare(jrows, trows)
    jcsv, tcsv = (open(p).read().split("\n") for p in (jpath, tpath))
    assert tcsv[0] == jcsv[0] == "drug_id,disease_id,score,drug_name"
    assert len(tcsv) == len(jcsv) == N_ZERO + 2


def test_novel_predictions_with_augmentation_match_jax(data, monkeypatch):
    """One loader-side augmentation draw (noise, masking and mixup) feeds
    the node features of the forward on both sides."""
    jds, tds = data
    jcfg, tcfg = model_cfgs(jds, tds, compute_dtype="float32",
                            decoder_backend="xla", decode_mode="edges")
    jparams = j_init(jax.random.key(6), jcfg)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    key = jax.random.key(1003)
    jaug = JAug(methods=("edge_dropout", "feature_noise", "mix_up"))
    drawn = [torch.from_numpy(np.array(x))
             for x in jds.augment_features(key, jaug)]
    monkeypatch.setattr(tds, "augment_features", lambda gen, cfg: drawn)
    jrows = j_top_novel(jparams, jcfg, jds, 1, top_k=N_ZERO,
                        use_augmentation=True, augment_cfg=jaug,
                        augment_key=key)
    trows = get_top_novel_predictions(
        tparams, tcfg, tds, 1, top_k=N_ZERO, use_augmentation=True,
        augment_cfg=TAug(methods=("edge_dropout", "feature_noise",
                                  "mix_up")),
        augment_generator=torch.Generator().manual_seed(0))
    _compare(jrows, trows)
    plain = get_top_novel_predictions(tparams, tcfg, tds, 1, top_k=N_ZERO)
    assert [r["score"] for r in plain] != [r["score"] for r in trows]


@pytest.mark.parametrize("flags", [
    [], ["--use_augmentation"], ["--fold_parallel"],
    ["--fold_parallel", "--use_augmentation", "--decode_mode", "edges"]])
def test_cli_writes_top_predictions(monkeypatch, tmp_path, flags):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    main(["--data_name", "tiny", "--device", "-1", "--seeds", "3",
          "--folds", "0", "2", "--train_max_iter", "5",
          "--train_valid_interval", "2", "--save_model",
          "--generate_top_predictions", "--top_k", "25",
          "--save_dir", str(tmp_path), *SMALL, *flags])
    for cv in (1, 3):
        rows = (tmp_path / "seed_3" /
                f"top25_novel_predictions_fold{cv}.csv").read_text().split()
        assert rows[0] == "drug_id,disease_id,score,drug_name"
        assert len(rows) == 26
        scores = [float(r.split(",")[2]) for r in rows[1:]]
        assert scores == sorted(scores, reverse=True)
        assert all(0.0 <= s <= 1.0 for s in scores)


@pytest.mark.parametrize("flags", [["--seed_parallel"], []])
def test_cli_writes_no_predictions_without_its_path(monkeypatch, tmp_path,
                                                     flags):
    """The seed-parallel path writes none, and without --save_model no best
    params are kept to score with (JAX harness.py:97-107)."""
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    save_model = ["--save_model"] if flags else []
    main(["--data_name", "tiny", "--device", "-1", "--seeds", "3",
          "--folds", "0", "--train_max_iter", "3",
          "--train_valid_interval", "2", "--generate_top_predictions",
          "--save_dir", str(tmp_path), *SMALL, *flags, *save_model])
    assert not [f for f in os.listdir(tmp_path / "seed_3")
                if "novel" in f]
