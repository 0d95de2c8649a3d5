"""GCMC alone on MovieLens-shaped ratings (``model_kind='gcmc'``): the port
against the benchmark's plain reference ``gnnbench/reference/gcmc.py`` at a
tiny size on the CPU (60 users x 40 movies x 10 levels x 600 ratings,
seeded random weights), the GCMC layer's 'stack' and one-hot paths, the
bilinear decoder's plain version, the MovieLens data module, the
benchmark cell's whole run, and the trainer's command line.

Tolerances.  Both sides compute in float32 on the CPU and sum in other
orders (``index_add_`` against the CSR sums, an einsum against the
decoder's gathered products), so values agree to a few units in the last
place of their largest: 1e-5 relative to the largest value of a tensor,
1e-6 on the loss.  The decoder's plain version against autograd of the
same function written out: 1e-5.
"""

from __future__ import annotations

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data import movielens
from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd
from dream_gnn_tpu_torch.model import dream_gnn, gcmc_alone, kinds
from dream_gnn_tpu_torch.nn.gcmc import (gcmc_layer_apply,
                                         gcmc_stack_layer_init)
from dream_gnn_tpu_torch.train.losses import softmax_cross_entropy
from dream_gnn_tpu_torch.train.scale import build_gcmc_inputs
from dream_gnn_tpu_torch.train.step import evaluate, make_one_step
from dream_gnn_tpu_torch.utils.profiling import (clear_spans, span_totals,
                                                 trace)
from gnnbench import faults, run
from gnnbench.drivers import gcmc as driver
from gnnbench.inputs import movielens as bench_data
from gnnbench.inputs import params as P
from gnnbench.reference import gcmc as ref

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# An eval every 2 steps, so that the tiny cell's 0.3 s window holds one
# however slow the machine (its first run of ``clock_every`` steps).
TINY = dict(n_users=60, n_movies=40, n_ratings=600, gcn_agg_units=50,
            gcn_out_units=12, train_valid_interval=2)
# The tiny cell's limits: sound runs read under 1e-6 on every number.
LIMITS = dict(loss_gap=1e-5, grad_gap=1e-4, change_gap=1e-4, eval_gap=1e-4)


def _cfg():
    with open(os.path.join(ROOT, "gnnbench", "configs",
                           "gcmc-ml10m.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    cfg["assumed"] = dict(cfg["assumed"], min_user_ratings=5)
    return cfg


def _rel(x, y):
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


@pytest.fixture(scope="module")
def case():
    """The tiny problem: raw ratings, the port's inputs, its model config,
    the harness's weights and the reference's data."""
    cfg = _cfg()
    raw = bench_data.ratings(cfg, 2 ** 31 + 7, CPU)
    inputs, labels, weights, _ = build_gcmc_inputs(
        raw["users"], raw["movies"], raw["levels"],
        (raw["train"], raw["valid"], raw["test"]), cfg["n_users"],
        cfg["n_movies"], CPU)
    model_cfg = ModelConfig(
        model_kind="gcmc", src_in_units=cfg["n_users"],
        dst_in_units=cfg["n_movies"], num_ratings=10, layers=1,
        gcn_agg_units=cfg["gcn_agg_units"], gcn_agg_accum="stack",
        gcn_out_units=cfg["gcn_out_units"], share_param=False, dropout=0.3,
        gen_r_num_basis_func=4, compute_dtype="float32",
        rating_values=movielens.LEVELS)
    spec = driver.param_spec(cfg)
    params = P.one_model(P.make_params(spec, 1, 11, CPU))
    return dict(cfg=cfg, raw=raw, inputs=inputs, labels=labels,
                weights=weights, model_cfg=model_cfg, params=params,
                data=ref.Data(raw, cfg))


def _fresh(params):
    return dream_gnn.map_params(
        lambda t: t.detach().clone().requires_grad_(True), params)


def test_forward_logits_match_reference(case):
    pred, *_ = gcmc_alone.forward(case["params"], case["inputs"][0],
                                  case["model_cfg"], train=False)
    want, _ = ref.forward(case["params"], case["data"], "train", case["cfg"],
                          None, torch.float32)
    order = case["inputs"][0].dec_layout.order
    assert pred.shape == (10, order.shape[0])
    assert _rel(pred, want[:, order]) <= 1e-5


def test_loss_and_each_gradient_match_reference(case):
    cfg, mc = case["cfg"], case["model_cfg"]
    p_prog, p_ref = _fresh(case["params"]), _fresh(case["params"])
    gen = torch.Generator().manual_seed(5)
    pred, *_ = gcmc_alone.forward(p_prog, case["inputs"][0], mc, train=True,
                                  generator=gen)
    loss = softmax_cross_entropy(pred, case["labels"][0], case["weights"][0])
    loss.backward()
    g2 = torch.Generator().manual_seed(5)
    w = {name: torch.rand(shape, generator=g2)
         for name, shape in ref.draw_order(cfg)}
    logits, levels = ref.forward(p_ref, case["data"], "train", cfg, w,
                                 torch.float32)
    want = ref.cross_entropy(logits, levels)
    want.backward()
    assert torch.equal(gen.get_state(), g2.get_state())
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    got = dream_gnn.named_leaves(p_prog)
    for (name, x), y in zip(got, ref.leaves(p_ref)):
        assert _rel(x.grad, y.grad) <= 1e-5, name


def test_rmse_matches_reference(case):
    for k, side in ((1, "valid"), (2, "test")):
        got = evaluate(case["params"], case["inputs"][k], case["model_cfg"],
                       case["labels"][k], case["weights"][k])
        logits, levels = ref.forward(case["params"], case["data"], side,
                                     case["cfg"], None, torch.float32)
        assert len(got) == 1
        assert abs(float(got[0]) - ref.rmse(logits, levels)) <= 1e-5


def test_test_side_encodes_over_train_and_valid_ratings(case):
    raw, g = case["raw"], case["inputs"][2].enc_graph
    assert case["inputs"][1].enc_graph is case["inputs"][0].enc_graph
    n = sum(int(pair.fwd.src.shape[0]) for pair in g.fwd)
    assert n == raw["train"].shape[0] + raw["valid"].shape[0]


def test_stack_is_the_concatenated_per_relation_sums(case):
    """'stack' against each relation's messages summed by hand: the
    concatenation in relation order, times the destination norm, then the
    activation and the Linear (dropout off)."""
    g, p = case["inputs"][0].enc_graph, case["params"]["tgcn"][0]
    users, movies = gcmc_layer_apply(p, g, None, None, dropout_rate=0.3,
                                     share_param=False, accum="stack",
                                     msg_dtype=torch.float32)
    nu, nm = g.ci_drug.shape[0], g.ci_dis.shape[0]
    to_m, to_u = [], []
    for r in range(10):
        f = g.fwd[r].fwd                   # user -> movie, movie-sorted CSR
        rows = torch.repeat_interleave(torch.arange(nm),
                                       (f.row_ptr[1:] - f.row_ptr[:-1]).long())
        hu = p["w_drug"][r] * g.cj_drug
        to_m.append(torch.zeros(nm, hu.shape[1]).index_add_(
            0, rows, hu[f.src.long()]))
        b = g.rev[r].fwd                   # movie -> user
        rows = torch.repeat_interleave(torch.arange(nu),
                                       (b.row_ptr[1:] - b.row_ptr[:-1]).long())
        hm = p["w_dis"][r] * g.cj_dis
        to_u.append(torch.zeros(nu, hm.shape[1]).index_add_(
            0, rows, hm[b.src.long()]))
    leaky = torch.nn.functional.leaky_relu
    hu = leaky(torch.cat(to_u, 1) * g.ci_drug, 0.1)
    hm = leaky(torch.cat(to_m, 1) * g.ci_dis, 0.1)
    assert _rel(users, hu @ p["ifc_w"] + p["ifc_b"]) <= 1e-5
    assert _rel(movies, hm @ p["fc_w"] + p["fc_b"]) <= 1e-5


def test_one_hot_inputs_are_an_identity_product(case):
    """One-hot inputs (features None) against the explicit product of
    identity features with each relation's weights."""
    g, p = case["inputs"][0].enc_graph, case["params"]["tgcn"][0]
    nu, nm = g.ci_drug.shape[0], g.ci_dis.shape[0]
    kw = dict(dropout_rate=0.0, share_param=False, accum="stack",
              msg_dtype=torch.float32)
    a = gcmc_layer_apply(p, g, None, None, **kw)
    b = gcmc_layer_apply(p, g, torch.eye(nu), torch.eye(nm), **kw)
    for x, y in zip(a, b):
        assert _rel(x, y) <= 1e-6


def test_stack_init_widths():
    gen = torch.Generator().manual_seed(0)
    p = gcmc_stack_layer_init(gen, drug_in=7, dis_in=5, msg_units=3,
                              out_units=4, num_ratings=10)
    assert p["w_drug"].shape == (10, 7, 3) and p["w_dis"].shape == (10, 5, 3)
    assert p["ifc_w"].shape == (30, 4) and p["fc_w"].shape == (30, 4)
    with pytest.raises(NotImplementedError):
        gcmc_alone.init_params(gen, ModelConfig(model_kind="gcmc", layers=1,
                                                share_param=False))


def test_message_units_of_gcmc_alone_are_not_cut():
    params = gcmc_alone.init_params(
        torch.Generator().manual_seed(0),
        ModelConfig(model_kind="gcmc", src_in_units=6, dst_in_units=4,
                    gcn_agg_units=500, num_ratings=10, layers=1,
                    gcn_agg_accum="stack", gcn_out_units=8,
                    share_param=False))
    assert params["tgcn"][0]["w_drug"].shape == (10, 6, 50)
    assert params["tgcn"][0]["w_dis"].shape == (10, 4, 50)
    assert ModelConfig(gcn_agg_units=1024).effective_msg_units(0) == 341


@pytest.mark.parametrize("build", ["init_params", "make_one_step"])
def test_an_unknown_model_kind_is_refused(build):
    """A misspelt ``model_kind`` (a configuration file passes the key
    straight into ``ModelConfig``) raises, naming the known kinds, where
    it would otherwise train DREAM-GNN."""
    cfg = ModelConfig(model_kind="gcmc-alone")
    with pytest.raises(ValueError, match="'dream', 'gcmc'"):
        if build == "init_params":
            kinds.init_params(torch.Generator().manual_seed(0), cfg)
        else:
            make_one_step(cfg, TrainConfig(model=cfg))


def test_dream_stack_is_still_refused():
    with pytest.raises(NotImplementedError):
        dream_gnn.init_params(torch.Generator().manual_seed(0),
                              ModelConfig(gcn_agg_accum="stack"))


def test_gcmc_init_params_shapes(case):
    params = kinds.kind_of(case["model_cfg"]).init(
        torch.Generator().manual_seed(0), case["model_cfg"])
    got = {n: tuple(t.shape) for n, t in dream_gnn.named_leaves(params)}
    want = {".".join(str(k) for k in path).replace(".0.", "[0]."): shape
            for path, shape, _ in driver.param_spec(case["cfg"])}
    assert got == want


@pytest.mark.parametrize("r,b,d", [(10, 4, 12), (5, 2, 7), (3, 1, 5)])
def test_plain_decoder_matches_autograd_of_its_function(r, b, d):
    """``bilinear_fwd_plain`` and ``bilinear_bwd_plain`` against the same
    function written per rating, differentiated by autograd."""
    rng = np.random.default_rng(r * 10 + b)
    nu, nm = 30, 20
    key = np.unique(rng.integers(0, nu * nm, 300))
    layout = bd.build_bilinear_layout(key // nm, key % nm, nu, nm,
                                      device=CPU)
    u, v = torch.randn(nu, d, dtype=torch.float64), torch.randn(
        nm, d, dtype=torch.float64)
    p, a = torch.randn(b, d, d, dtype=torch.float64), torch.randn(
        r, b, dtype=torch.float64)
    g = torch.randn(r, layout.n_edges, dtype=torch.float64)
    xs = [x.clone().requires_grad_(True) for x in (u, v, p, a)]
    i, j = layout.src.long(), layout.dst.long()
    want = xs[3] @ torch.einsum("ek,bkl,el->be", xs[0][i], xs[2], xs[1][j])
    (want * g).sum().backward()
    up = (u @ bd.basis_cat(p)).reshape(-1, b, d)
    assert _rel(bd.bilinear_fwd_plain(up, v, a, layout), want) <= 1e-10
    dup, da, w = bd.bilinear_bwd_plain(g, up, u, v, a, layout)
    pc = bd.basis_cat(p)
    du = dup.reshape(nu, -1) @ pc.T
    dv = w.reshape(nm, -1) @ p.reshape(b * d, d)
    dp = (u.T @ dup.reshape(nu, -1)).reshape(d, b, d).permute(1, 0, 2)
    for got, x in zip((du, dv, dp, da), xs):
        assert _rel(got, x.grad) <= 1e-10


def test_layout_tasks_cover_each_node_in_runs(case):
    lay = case["inputs"][0].dec_layout
    small = bd.build_bilinear_layout(lay.src, lay.dst, lay.n_users,
                                     lay.n_movies, device=CPU, task=3)
    beg = small.u_task_beg.long()
    assert int(beg[-1]) == lay.n_edges
    assert int((beg[1:] - beg[:-1]).max()) <= 3
    for t in range(small.u_task_node.shape[0]):
        assert (small.src[beg[t]:beg[t + 1]] == small.u_task_node[t]).all()
    mb = small.m_task_beg.long()
    mv = small.dst[small.perm.long()]
    assert (mv[1:] >= mv[:-1]).all()
    assert torch.equal(small.m_src, small.src[small.perm.long()])
    assert int((mb[1:] - mb[:-1]).max()) <= 3
    assert (small.src[1:] * lay.n_movies + small.dst[1:]
            > small.src[:-1] * lay.n_movies + small.dst[:-1]).all()


def test_traced_step_opens_forty_segment_sums_and_the_bilinear_spans(case):
    from dream_gnn_tpu_torch.train.step import (init_state, make_one_step,
                                                run_steps)

    mc = case["model_cfg"]
    tc = TrainConfig(model=mc, augment=AugmentConfig(methods=()),
                     train_lr=0.001, weight_decay=0.0, beta=0.0)
    state = init_state(_fresh(case["params"]), torch.Generator().manual_seed(
        1), tc)
    step = make_one_step(mc, tc)
    clear_spans()
    with trace(None):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            run_steps(step, state, 1, case["inputs"][0], case["labels"][0],
                      case["weights"][0])
    got = span_totals()
    clear_spans()
    assert got["step"][0] == 1
    assert got["segment_sum"][0] == 40
    assert got["bilinear"][0] == 1 and got["bilinear_bwd"][0] == 1
    assert got["decoder"][0] == 1 and got["decoder_bwd"][0] == 1


# ---------------------------------------------------------------------------
# The data module.

def test_ratings_dat_is_read_and_split(tmp_path):
    rng = np.random.default_rng(0)
    n = 1000
    uid = rng.choice([3, 10, 11, 50, 77], n)
    mid = rng.choice([1, 2, 9, 400], n)
    stars = rng.choice(movielens.LEVELS, n)
    path = tmp_path / "ratings.dat"
    path.write_text("".join(f"{a}::{b}::{c}::978300760\n"
                            for a, b, c in zip(uid, mid, stars)))
    users, movies, levels, nu, nm = movielens.read_ratings(str(path))
    assert (nu, nm) == (5, 4)
    assert np.array_equal(users, np.searchsorted([3, 10, 11, 50, 77], uid))
    assert np.array_equal(movies, np.searchsorted([1, 2, 9, 400], mid))
    assert np.allclose(np.asarray(movielens.LEVELS)[levels], stars)
    train, valid, test = movielens.split(n, 3)
    assert (len(test), len(valid), len(train)) == (100, 90, 810)
    assert np.array_equal(np.sort(np.concatenate([train, valid, test])),
                          np.arange(n))
    assert movielens.level_index([0.5, 3.0, 5.0]).tolist() == [0, 5, 9]
    with pytest.raises(ValueError):
        movielens.level_index([5.5])


def test_dgl_split_sizes_at_the_dataset_size():
    n = movielens.N_RATINGS
    n_test = int(np.ceil(n * movielens.TEST_RATIO))
    n_valid = int(np.ceil((n - n_test) * movielens.VALID_RATIO))
    assert (n - n_test - n_valid, n_valid, n_test) == (8_100_043, 900_005,
                                                       1_000_006)


@pytest.mark.parametrize("gen", ["port", "bench"])
def test_made_ratings_have_the_schema(gen):
    """Both generators: the counts, one rating a pair, ids and levels in
    range.  The benchmark's also keeps its assumed bounds on each user's
    count; the port's draws pairs uniformly and promises none."""
    nu, nm, n = 300, 200, 9000
    if gen == "port":
        users, movies, levels = (torch.as_tensor(x) for x in
                                 movielens.synthetic_ratings(4, nu, nm, n))
    else:
        cfg = dict(_cfg(), n_users=nu, n_movies=nm, n_ratings=n)
        low = cfg["assumed"]["min_user_ratings"] = 20
        raw = bench_data.ratings(cfg, 4, CPU)
        users, movies, levels = raw["users"], raw["movies"], raw["levels"]
        parts = torch.cat([raw["train"], raw["valid"], raw["test"]])
        assert torch.equal(torch.sort(parts).values, torch.arange(n))
        assert raw["test"].shape[0] == 900
        counts = torch.bincount(users, minlength=nu)
        assert int(counts.min()) >= low
        assert int(counts.max()) <= nm // 4
    assert users.shape == movies.shape == levels.shape == (n,)
    assert torch.unique(users * nm + movies).shape[0] == n
    assert 0 <= int(users.min()) and int(users.max()) < nu
    assert 0 <= int(levels.min()) and int(levels.max()) <= 9
    assert 0 <= int(movies.min()) and int(movies.max()) < nm


# ---------------------------------------------------------------------------
# The benchmark cell, whole, at the tiny size.

@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gcmc") / "checkout")
    shutil.copytree(os.path.join(ROOT, "gnnbench"),
                    os.path.join(root, "gnnbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "gnnbench", "configs", "tiny-gcmc.json"),
              "w") as f:
        json.dump(_cfg(), f)
    bench["configs"] = [dict(name="tiny-gcmc", source="test", reduced=[],
                             file="gnnbench/configs/tiny-gcmc.json",
                             why="test sizes")]
    bench["workloads"] = [dict(name="t-gcmc", config="tiny-gcmc",
                               traffic="t-gcmc", chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "gnnbench", "traffic", "t-gcmc.json"),
              "w") as f:
        json.dump(dict(clock_every=2, compare_steps=3, trace_steps=2), f)
    with open(os.path.join(root, "gnnbench", "limits", "t-gcmc.json"),
              "w") as f:
        json.dump(LIMITS, f)
    return root


def _run(root, capsys, seed, trace_on=0):
    # tests/conftest.py has loaded JAX into this process, which the
    # benchmark's own runs refuse; here the check would see the suite.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run, "forbidden_modules", lambda: [])
        rc = run.main(["--workload", "t-gcmc", "--seed", str(seed),
                       "--seconds", "0.3", "--trace", str(trace_on)],
                      device=CPU, root=root)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_sound_run_is_correct(tiny_root, capsys, trace_on):
    result = _run(tiny_root, capsys, 2 ** 31 + 101, trace_on)
    assert result["correct"] is True
    assert result["compared"]["draws_apart"]["value"] == 0
    names = {"model_steps_per_s.scale", "setup_s"} if not trace_on \
        else {"layout_build_s", "step_mfu.scale", "eval_ms.scale"}
    assert names <= set(result["metrics"])


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, capsys, fault):
    with faults.planted(fault):
        result = _run(tiny_root, capsys, 2 ** 31 + 103)
    assert result["correct"] is False


def test_the_bf16_control_is_not_correct(tiny_root):
    from gnnbench import calibrate, harness

    cell = harness.find_cell("t-gcmc", tiny_root)
    got = calibrate.readings(cell, 2 ** 31 + 107, CPU, "control-bf16")
    assert got["verdict"] is False


def test_the_reference_takes_no_program_copy(case):
    params = copy.deepcopy(case["params"])
    out = ref.run(case["raw"], case["cfg"], params, 9, CPU, steps=1)
    for x, y in zip(ref.leaves(params), ref.leaves(case["params"])):
        assert torch.equal(x, y)
    assert out["eval"].shape == (1, 2, 1) and out["loss"].shape == (1, 1)


# ---------------------------------------------------------------------------
# The command line.

def test_the_trainer_command_line_runs_gcmc(tmp_path, capsys):
    from dream_gnn_tpu_torch.train import scale

    rc = scale.main(["--model", "gcmc-ml10m", "--device", "-1", "--quick",
                     "--iters", "21", "--valid_interval", "10",
                     "--save_dir", str(tmp_path)])
    assert rc == 0
    rows = (tmp_path / "test_metric0.csv").read_text().splitlines()
    assert rows[0] == "iter,loss,valid_rmse,test_rmse" and len(rows) == 3
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["best_iter"] in (10, 20)
    assert "GCMC_SUMMARY" in capsys.readouterr().out
