"""Checkpoint and resume in the port, after tests/test_resume.py and
tests/test_cli_resume.py of the JAX package.

A run cut after a checkpoint and resumed must give what the uninterrupted
run gives: the same final params bit for bit (the same state stream:
params, Adam moments, lr, plateau scheduler, best-by-AUPR bookkeeping and
the generator), and the same CSV artifacts byte for byte, in sequence,
``--fold_parallel`` and ``--seed_parallel`` and on the scale path.  A run
is cut here by giving it fewer iterations, which ends it just after its
checkpoint.  The CSV rows past a checkpoint are dropped as the JAX
``MetricLogger`` drops them, and a stale stacked checkpoint is refused.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dream_gnn_tpu.utils.logging import MetricLogger as JMetricLogger
from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.model.dream_gnn import (init_params, map_params,
                                                 param_leaves)
from dream_gnn_tpu_torch.train import scale
from dream_gnn_tpu_torch.train.checkpoint import (checkpoint_items,
                                                  load_pytree,
                                                  load_train_state,
                                                  save_pytree,
                                                  save_train_state)
from dream_gnn_tpu_torch.train.cli import main
from dream_gnn_tpu_torch.train.loop import (derive_model_cfg, fold_generator,
                                            fold_inputs, train_fold)
from dream_gnn_tpu_torch.train.optim import PlateauScheduler
from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                               init_state_stacked,
                                               make_one_step_stacked)
from dream_gnn_tpu_torch.train.step import init_state, make_one_step
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
from dream_gnn_tpu_torch.utils.logging import MetricLogger

SMALL = ["--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
         "--nhid1", "32", "--nhid2", "16"]
MODEL = ModelConfig(layers=2, gcn_agg_units=48, gcn_out_units=16, nhid1=32,
                    nhid2=16, decode_mode="grid", decoder_backend="pallas")
COLS = ["iter", "loss", "train_auroc", "train_aupr", "test_auroc",
        "test_aupr"]
FMTS = ["%d", "%.4f", "%.4f", "%.4f", "%.4f", "%.4f"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    return DreamDataset(synthetic_raw_data(n_drug=40, n_dis=30, n_pos=80,
                                           seed=9), k=3, device="cpu")


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    return "tiny"


@pytest.mark.parametrize("resume_iter", [None, 0, 4, 8])
def test_metric_logger_resume_matches_jax(tmp_path, resume_iter):
    """Reopening a CSV keeps the rows up to ``resume_iter`` (all dropped
    with None) exactly as the JAX ``MetricLogger`` does."""
    files = []
    for cls, name in ((MetricLogger, "t.csv"), (JMetricLogger, "j.csv")):
        path = str(tmp_path / name)
        with cls(COLS, FMTS, path) as lg:
            for it in (4, 8, 12):
                lg.log(iter=it, loss=0.5, train_auroc=0.6, train_aupr=0.2,
                       test_auroc=0.7, test_aupr=0.3)
        with cls(COLS, FMTS, path, resume_iter=resume_iter) as lg:
            lg.log(iter=16, loss=0.4, train_auroc=0.7, train_aupr=0.3,
                   test_auroc=0.8, test_aupr=0.4)
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1]


def test_save_pytree_leaf_order_is_jax_flatten_order(tmp_path):
    tree = {"b": [np.arange(3.0), {"z": np.ones((2, 2)), "a": np.zeros(4)}],
            "a": np.float32(7.0), "c": np.int64(2)}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree)
    with np.load(path) as f:
        assert sorted(f.files) == [f"leaf_{i}" for i in range(5)]
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            np.testing.assert_array_equal(f[f"leaf_{i}"], leaf)
    back = load_pytree(path, tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    with pytest.raises(ValueError, match="load_pytree"):
        load_pytree(path, {"a": np.zeros(3)})


def _assert_trees_equal(a, b):
    for x, y in zip(param_leaves(a), param_leaves(b), strict=True):
        assert torch.equal(x.detach().cpu(), y.detach().cpu())


def _sequential_state(dataset, seed):
    cfg = TrainConfig(model=MODEL)
    mcfg = derive_model_cfg(cfg, dataset)
    gen = torch.Generator().manual_seed(seed)
    state = init_state(init_params(gen, mcfg), gen, cfg)
    return cfg, mcfg, state


def _stacked_state(dataset, seed):
    cfg = TrainConfig(model=MODEL)
    mcfg = derive_model_cfg(cfg, dataset)
    gen = torch.Generator().manual_seed(seed)
    state = init_state_stacked(init_params_stacked(mcfg, [seed], [0, 1],
                                                   "cpu"), gen, cfg)
    return cfg, mcfg, state


@pytest.mark.parametrize("kind", ["sequential", "stacked"])
def test_train_state_round_trip(dataset, tmp_path, kind):
    """Two steps, a save, a load into a state of another seed: params,
    moments, step count, lr, generator, schedulers, bookkeeping and best
    params come back, and the next step of each state is the same."""
    if kind == "sequential":
        cfg, mcfg, a = _sequential_state(dataset, 1)
        _, _, b = _sequential_state(dataset, 2)
        step = make_one_step(mcfg, cfg)
        inputs, _, labels, _ = fold_inputs(dataset, 0)
        args = (inputs, labels, dataset.fold(0).train_w)
        n = 1
    else:
        cfg, mcfg, a = _stacked_state(dataset, 1)
        _, _, b = _stacked_state(dataset, 2)
        step = make_one_step_stacked(mcfg, cfg)
        st = stack_folds(dataset, [0, 1])
        args = (st.inputs, st.labels, st.edge_weight)
        n = 2
    for _ in range(2):
        step(a, *args)
    scheds = [PlateauScheduler(0.002) for _ in range(n)]
    for s, m in zip(scheds, (0.3, 0.2)):
        s.step(m)
        s.lr, s.num_bad = 0.001, 3
    best = [dict(aupr=0.25 + i, auroc=0.7, iter=20, train_aupr=0.3,
                 train_auroc=0.8) for i in range(n)]
    # The last item has best params; an item without stores its own
    # params, flagged 0, and comes back as None.
    kept = map_params(lambda t: (t[-1] if n > 1 else t).detach().clone()
                      * 0.5, a.params)
    best_params = [None] * (n - 1) + [kept]
    path = str(tmp_path / "ckpt.npz")
    save_train_state(path, a, 2, scheds, best, best_params)
    assert not os.path.exists(path + ".tmp")
    assert checkpoint_items(path) == n
    fresh = [PlateauScheduler(0.002) for _ in range(n)]
    step_n, best_b, bp = load_train_state(path, b, fresh,
                                          with_best_params=True)
    assert step_n == 2 and best_b == best
    assert bp[:-1] == [None] * (n - 1)
    _assert_trees_equal(bp[-1], kept)
    assert [(s.lr, s.best, s.num_bad) for s in fresh] == \
        [(s.lr, s.best, s.num_bad) for s in scheds]
    _assert_trees_equal(a.params, b.params)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    if kind == "sequential":
        assert b.opt.param_groups[0]["lr"] == a.opt.param_groups[0]["lr"]
        for p, q in zip(a.opt.param_groups[0]["params"],
                        b.opt.param_groups[0]["params"]):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a.opt.state[p][k], b.opt.state[q][k]), k
    else:
        assert b.opt.count == a.opt.count and torch.equal(b.opt.lr, a.opt.lr)
        _assert_trees_equal(a.opt.mu + a.opt.nu, b.opt.mu + b.opt.nu)
    la, lb = step(a, *args), step(b, *args)
    assert torch.equal(la, lb)
    _assert_trees_equal(a.params, b.params)


@pytest.mark.parametrize("save_model", [False, True])
def test_resume_reproduces_run(dataset, tmp_path, save_model):
    """20 steps with a checkpoint at 10 and 20, then a resume to 40, equal
    40 uninterrupted steps: final params, CSVs and the best params."""
    cfg = TrainConfig(model=MODEL, train_max_iter=41,
                      train_valid_interval=10, checkpoint_every=10,
                      save_model=save_model)
    d1, d2 = str(tmp_path / "full"), str(tmp_path / "resumed")
    full = train_fold(dataset, 0, cfg, fold_generator(0, 0, "cpu"),
                      save_dir=d1, save_id=1, verbose=False)
    train_fold(dataset, 0, dataclasses.replace(cfg, train_max_iter=21),
               fold_generator(0, 0, "cpu"), save_dir=d2, save_id=1,
               verbose=False)
    resumed = train_fold(dataset, 0, cfg, fold_generator(0, 0, "cpu"),
                         save_dir=d2, save_id=1, verbose=False,
                         resume_from=os.path.join(d2, "ckpt_fold1.npz"))
    _assert_trees_equal(full["final_state"].params,
                        resumed["final_state"].params)
    for name in ("test_metric1.csv", "best_metric1.csv"):
        assert open(os.path.join(d1, name)).read() == \
            open(os.path.join(d2, name)).read(), name
    assert resumed["best_iter"] == full["best_iter"]
    if save_model:
        _assert_trees_equal(full["best_params"], resumed["best_params"])


def _csvs(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            if f.endswith(".csv"):
                path = os.path.join(root, f)
                out[os.path.relpath(path, d)] = open(path).read()
    return out


@pytest.mark.parametrize("flags", [
    [], ["--fold_parallel"], ["--seed_parallel", "--seeds", "7", "8"],
    ["--fold_parallel", "--decode_mode", "edges"]])
def test_cli_cut_and_resume_writes_the_same_csvs(tiny_preset, tmp_path,
                                                 flags):
    """Through the CLI: a run cut after its checkpoint at step 8 and
    resumed with --resume writes the uninterrupted run's CSVs."""
    def run(d, iters, *extra):
        argv = ["--data_name", tiny_preset, "--device", "-1", "--seeds", "7",
                "--folds", "0", "1", "--train_max_iter", str(iters),
                "--train_valid_interval", "4", "--checkpoint_every", "4",
                "--save_dir", str(d), *SMALL, *flags, *extra]
        main(argv)

    run(tmp_path / "full", 13)
    run(tmp_path / "cut", 9)
    ckpts = sorted(str(p.relative_to(tmp_path / "cut"))
                   for p in (tmp_path / "cut").rglob("ckpt_*.npz"))
    assert ckpts == (["seed_7/ckpt_fold1.npz", "seed_7/ckpt_fold2.npz"]
                     if not flags else ["seed_7/ckpt_stacked.npz"])
    run(tmp_path / "cut", 13, "--resume")
    full, cut = _csvs(tmp_path / "full"), _csvs(tmp_path / "cut")
    assert set(full) == set(cut) and len(full) >= 6
    for name in full:
        assert full[name] == cut[name], name
    rows = full["seed_7/test_metric2.csv"].split()
    assert [int(r.split(",")[0]) for r in rows[1:]] == [4, 8, 12]


def test_stale_stacked_checkpoint_is_refused(tiny_preset, tmp_path):
    argv = ["--data_name", tiny_preset, "--device", "-1", "--seeds", "7",
            "--train_max_iter", "5", "--train_valid_interval", "4",
            "--checkpoint_every", "4", "--fold_parallel",
            "--save_dir", str(tmp_path), *SMALL]
    main([*argv, "--folds", "0", "1", "2"])
    with pytest.raises(ValueError, match="holds 3 stacked items but this "
                                         "run stacks 2"):
        main([*argv, "--folds", "0", "1", "--resume"])


def test_scale_trainer_resumes(tmp_path):
    """``train.scale`` at a tiny size: cut after its checkpoint at step 2,
    resumed to step 4, it writes the uninterrupted run's CSVs."""
    base = ["--device", "-1", "--n_nodes", "300", "--n_enc", "4000",
            "--n_cand", "600", "--valid_interval", "2",
            "--checkpoint_every", "2"]
    full, cut = tmp_path / "full", tmp_path / "cut"
    scale.main([*base, "--iters", "5", "--save_dir", str(full)])
    scale.main([*base, "--iters", "3", "--save_dir", str(cut)])
    assert (cut / "ckpt_fold0.npz").exists()
    scale.main([*base, "--iters", "5", "--save_dir", str(cut), "--resume"])
    for name in ("test_metric0.csv", "best_metric0.csv"):
        assert (full / name).read_text() == (cut / name).read_text(), name
    assert len((cut / "test_metric0.csv").read_text().split()) == 3
