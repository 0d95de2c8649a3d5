"""The port's CLI on the CPU (``--device -1``): a smoke run writes the CSV
artifacts that tests/test_train_smoke.py pins for the JAX package, in
sequence and with ``--fold_parallel`` / ``--seed_parallel``, in grid and
edges decode mode and with either decoder backend, the flag surface
matches the JAX CLI, ``--save_model`` writes the JAX checkpoint's leaf
layout, and a card that is not there is an error.  The ``.mat`` path,
checkpoint and resume, novel predictions and ``--profile_dir`` have files
of their own (tests/test_torch_port_{matio,resume,novel,tooling}.py)."""

import os

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from dream_gnn_tpu.train.cli import build_parser as j_build_parser
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.model.dream_gnn import init_params
from dream_gnn_tpu_torch.train.cli import (build_parser, config_from_args,
                                           main)
from dream_gnn_tpu_torch.train.loop import derive_model_cfg

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
    """The checkpoint holds the leaves of the JAX ``save_pytree`` layout,
    ``leaf_{i}`` in ``jax.tree.flatten`` order over the param tree, and
    nothing else."""
    argv = ["--data_name", tiny_preset, "--device", "-1", "--seeds", "1",
            "--folds", "0", "--train_max_iter", "3",
            "--train_valid_interval", "2", "--save_model",
            "--save_dir", str(tmp_path), *SMALL]
    main(argv)
    cfg = config_from_args(build_parser().parse_args(argv))
    mcfg = derive_model_cfg(cfg, DreamDataset.load(tiny_preset, device="cpu"))
    leaves = jax.tree.leaves(init_params(torch.Generator().manual_seed(0),
                                         mcfg))
    with np.load(tmp_path / "seed_1" / "best_model_fold1.npz") as f:
        assert sorted(f.files) == sorted(f"leaf_{i}"
                                         for i in range(len(leaves)))
        for i, want in enumerate(leaves):
            assert f[f"leaf_{i}"].shape == tuple(want.shape), i


def test_flag_surface_matches_jax_cli():
    ours = {a.dest for a in build_parser()._actions}
    ref = {a.dest for a in j_build_parser()._actions}
    assert ours == ref


@pytest.mark.parametrize("flag", ["--fold_parallel", "--seed_parallel"])
def test_cli_stacked_writes_per_fold_artifacts(tiny_preset, tmp_path, capsys,
                                               flag):
    """Two seeds x two folds trained as stacks write the sequential path's
    files for every seed and fold; each interval line reports the stacked
    step's time and the time per fold-step."""
    save_dir = str(tmp_path)
    summary = main(["--data_name", tiny_preset, "--device", "-1",
                    "--seeds", "77", "78", "--folds", "0", "2",
                    "--train_max_iter", "9", "--train_valid_interval", "4",
                    "--save_model", "--save_dir", save_dir, flag, *SMALL])
    out = capsys.readouterr().out
    assert "ms/step" in out and "ms/fold-step" in out
    items = 4 if flag == "--seed_parallel" else 2
    assert f"[mean over {items} folds]" in out
    for seed in (77, 78):
        seed_dir = os.path.join(save_dir, f"seed_{seed}")
        for f in ("test_metric1.csv", "best_metric1.csv", "test_metric3.csv",
                  "best_metric3.csv", "best_model_fold1.npz",
                  "best_model_fold3.npz", "experiment_results.csv"):
            assert os.path.exists(os.path.join(seed_dir, f)), (seed, f)
        assert not os.path.exists(os.path.join(seed_dir, "test_metric2.csv"))
        with open(os.path.join(seed_dir, "test_metric3.csv")) as f:
            lines = f.read().strip().split("\n")
        assert lines[0] == ("iter,loss,train_auroc,train_aupr,test_auroc,"
                            "test_aupr")
        assert [int(x.split(",")[0]) for x in lines[1:]] == [4, 8]
        with open(os.path.join(seed_dir, "experiment_results.csv")) as f:
            rows = f.read().strip().split("\n")
        assert rows[0] == "fold,auroc,aupr" and len(rows) == 4
    with open(os.path.join(save_dir, "summary_results.csv")) as f:
        assert len(f.read().strip().split("\n")) == 5
    assert [r["seed"] for r in summary["results"]] == [77, 78]
    assert all(r["ms_per_step"] > 0 for r in summary["results"])


@pytest.mark.parametrize("flags", [
    ["--decode_mode", "edges"], ["--decode_mode", "edges", "--fold_parallel"],
    ["--decoder_backend", "xla"],
    ["--decoder_backend", "xla", "--decode_mode", "edges",
     "--fold_parallel"],
    ["--decode_mode", "edges", "--seed_parallel", "--seeds", "77", "78"]])
def test_cli_decode_paths_write_artifacts(tiny_preset, tmp_path, capsys,
                                          flags):
    """The edges decode mode, in sequence, fold-parallel and seed-parallel
    (two seeds' stacks tiled, CSR orderings included), and the plain
    decoder backend write the CSV contract with finite metrics."""
    save_dir = str(tmp_path)
    summary = main(["--data_name", tiny_preset, "--device", "-1",
                    "--seeds", "77", "--folds", "0", "1",
                    "--train_max_iter", "5", "--train_valid_interval", "2",
                    "--save_dir", save_dir, *flags, *SMALL])
    assert "Test: AUROC=" in capsys.readouterr().out
    seed_dir = os.path.join(save_dir, "seed_77")
    for cv in (1, 2):
        with open(os.path.join(seed_dir, f"test_metric{cv}.csv")) as f:
            lines = f.read().strip().split("\n")
        assert lines[0] == ("iter,loss,train_auroc,train_aupr,test_auroc,"
                            "test_aupr")
        assert [int(x.split(",")[0]) for x in lines[1:]] == [2, 4]
        assert all(np.isfinite(float(v)) for x in lines[1:]
                   for v in x.split(","))
        assert os.path.exists(os.path.join(seed_dir, f"best_metric{cv}.csv"))
    with open(os.path.join(seed_dir, "experiment_results.csv")) as f:
        assert len(f.read().strip().split("\n")) == 4
    assert os.path.exists(os.path.join(save_dir, "summary_results.csv"))
    assert 0.0 <= summary["mean_auroc"] <= 1.0


def test_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "0", "--seeds", "1", "--folds", "0"])
