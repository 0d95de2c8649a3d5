"""The port's CLI on the CPU (``--device -1``): a smoke run writes the CSV
artifacts that tests/test_train_smoke.py pins for the JAX package, the
flag surface matches the JAX CLI, parts not ported yet raise, and a
card that is not there is an error."""

import os

import jax  # noqa: F401
import pytest
import torch

from dream_gnn_tpu.train.cli import build_parser as j_build_parser
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.train.cli import build_parser, main

SMALL = ["--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
         "--nhid1", "32", "--nhid2", "16"]


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    return "tiny"


def test_cli_smoke_writes_artifacts(tiny_preset, tmp_path, capsys):
    save_dir = str(tmp_path)
    summary = main(["--data_name", tiny_preset, "--device", "-1",
                    "--seeds", "77", "--folds", "0", "1",
                    "--train_max_iter", "9", "--train_valid_interval", "4",
                    "--save_dir", save_dir, *SMALL])
    out = capsys.readouterr().out
    assert "Iter=    4, Loss=" in out and "Test: AUROC=" in out
    assert "ms/step" in out
    seed_dir = os.path.join(save_dir, "seed_77")
    for f in ("test_metric1.csv", "best_metric1.csv", "test_metric2.csv",
              "best_metric2.csv", "experiment_results.csv"):
        assert os.path.exists(os.path.join(seed_dir, f)), f
    assert os.path.exists(os.path.join(save_dir, "summary_results.csv"))
    with open(os.path.join(seed_dir, "test_metric1.csv")) as f:
        lines = f.read().strip().split("\n")
    assert lines[0] == "iter,loss,train_auroc,train_aupr,test_auroc,test_aupr"
    assert len(lines) == 3          # evals at 4 and 8 (max_iter - 1 = 8)
    with open(os.path.join(seed_dir, "experiment_results.csv")) as f:
        assert f.read().startswith("fold,auroc,aupr\n1,")
    assert 0.0 <= summary["mean_auroc"] <= 1.0


def test_cli_save_model_writes_params(tiny_preset, tmp_path):
    main(["--data_name", tiny_preset, "--device", "-1", "--seeds", "1",
          "--folds", "0", "--train_max_iter", "3",
          "--train_valid_interval", "2", "--save_model",
          "--save_dir", str(tmp_path), *SMALL])
    import numpy as np
    with np.load(tmp_path / "seed_1" / "best_model_fold1.npz") as f:
        assert "tgcn.0.basis" in f.files and "decoder.w2" in f.files


def test_flag_surface_matches_jax_cli():
    ours = {a.dest for a in build_parser()._actions}
    ref = {a.dest for a in j_build_parser()._actions}
    assert ours == ref


@pytest.mark.parametrize("flags", [
    ["--fold_parallel"], ["--seed_parallel"], ["--resume"],
    ["--checkpoint_every", "250"], ["--generate_top_predictions"],
    ["--decode_mode", "edges"], ["--decoder_backend", "xla"],
    ["--data_path", "x.mat"], ["--profile_dir", "trace"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        main(["--device", "-1", *flags])


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "0", "--seeds", "1", "--folds", "0"])
