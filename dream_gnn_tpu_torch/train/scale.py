"""End-to-end training at framework scale: the single-device scale path.

    python -m dream_gnn_tpu_torch.train.scale [--iters N] [--quick]
        [--device -1] [--save_dir DIR] [--checkpoint_every N] [--resume]
    python -m dream_gnn_tpu_torch.train.scale --model gcmc-ml10m
        [--ratings ratings.dat] [--iters N] [--quick] [--device -1]
        [--save_dir DIR]

``--model gcmc-ml10m`` trains GCMC alone on MovieLens-10M as DGL's
``examples/pytorch/gcmc`` README runs it (``--gcn_agg_accum=stack
--gcn_dropout=0.3 --train_lr=0.001 --use_one_hot_fea
--gen_r_num_basis_func=4``, the other settings train.py's defaults): one
'stack' GCMC layer over the 10 rating levels' relations, one-hot inputs,
500 -> 75 units, the bilinear decoder with 4 basis matrices and a 10-way
softmax, full-batch Adam steps over every train rating; the valid and the
test RMSE every ``--valid_interval`` steps (``gcmc_model_config``,
``build_gcmc_inputs``).  ``--ratings`` reads MovieLens' ``ratings.dat``;
without it the ratings are made from ``--data_seed`` at the dataset's
shapes (data/movielens.py), or with ``--quick`` at a tiny size
(``QUICK_MOVIELENS``: 60 users, 40 movies, 600 ratings).

Port of ``scripts/train_scale.py`` of the JAX package: a 100k x 100k
synthetic problem through the slabbed SpMM encoder (kernels/spmm_slab.py),
the streaming scale decoder (kernels/scale_decoder.py), the default
augmentation (PRF edge dropout + feature noise) and bf16 decoder operands,
trained through the standard harness (train/loop.py:train_on_inputs:
interval loops, plateau LR on test AUPR, best-by-AUPR, the CSV contract).

The task is a planted low-rank association model, so there is signal to
learn and a held-out set to measure it on:

    u ~ N(0, I_r)/sqrt(r) per drug, v per disease, r = 32
    cell (i, j) is positive iff u_i . v_j > tau  (tau -> 10% base rate)
    encoder graph    : 10M sampled cells (rating 1 = positive)
    train candidates : 1M sampled cells, BCE-trained
    test candidates  : 1M cells disjoint from both (hash-deduped)
    node features    : 128-d random projection of u/v + N(0, 0.5) noise

AUROC/AUPR on the test candidates are the learning evidence (base-rate
AUPR 0.10): the run prints ``LEARNING_OK`` (test AUROC > 0.75 and AUPR >
0.2) or ``LEARNING_WEAK`` and exits 0 or 1 accordingly.  The sizes are
arguments (``--n_nodes``, ``--n_enc``, ``--n_cand``) whose defaults are the
JAX script's; a short run at small sizes reports WEAK, as it should.

Artifacts in ``--save_dir``: test_metric0.csv, best_metric0.csv,
ckpt_fold0.npz and summary.json.  The train state is checkpointed every
``--checkpoint_every`` steps (the JAX script's 1000; 0 turns it off), after
an eval, so it takes effect at multiples of ``--valid_interval``;
``--resume`` goes on from ``ckpt_fold0.npz`` when there is one
(train/checkpoint.py).  The problem is made on the host with numpy from the
JAX script's constant seed (``SEED``); the graph and decoder layouts are
built with torch on the run's device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

N_DRUG = N_DIS = 100_000
RANK = 32
D = 128
N_ENC = 10_000_000
N_CAND = 1_000_000
POS_RATE = 0.10
SEED = 1234
ITERS = 4001
QUICK_ITERS = 501
QUICK_MOVIELENS = (60, 40, 600)    # users, movies, ratings of --quick
VALID_INTERVAL = 100
CHECKPOINT_EVERY = 1000

SAVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results", "scale_train_torch")


def build_problem(rng, n_drug: int = N_DRUG, n_dis: int = N_DIS,
                  rank: int = RANK, d: int = D, n_enc: int = N_ENC,
                  n_cand: int = N_CAND, pos_rate: float = POS_RATE):
    """Planted low-rank association data and disjoint splits, as the JAX
    script's ``build_problem`` draws them from ``rng``."""
    u = rng.normal(size=(n_drug, rank)).astype(np.float32) / np.sqrt(rank)
    v = rng.normal(size=(n_dis, rank)).astype(np.float32) / np.sqrt(rank)

    n_total = n_enc + 2 * n_cand
    # Oversample, then dedupe cells so the test set is truly held out.
    src = rng.integers(0, n_drug, int(n_total * 1.05))
    dst = rng.integers(0, n_dis, int(n_total * 1.05))
    _, uniq = np.unique(src.astype(np.int64) * n_dis + dst,
                        return_index=True)
    uniq = np.sort(uniq)[:n_total]
    src, dst = src[uniq], dst[uniq]
    if len(src) != n_total:
        raise ValueError("oversampling margin too small for these sizes")

    score = np.einsum("er,er->e", u[src], v[dst])
    tau = np.quantile(score, 1.0 - pos_rate)
    y = (score > tau).astype(np.float32)

    enc = slice(0, n_enc)
    tr = slice(n_enc, n_enc + n_cand)
    te = slice(n_enc + n_cand, n_total)

    w_d = rng.normal(size=(rank, d)).astype(np.float32)
    w_v = rng.normal(size=(rank, d)).astype(np.float32)
    feat_d = u @ w_d + 0.5 * rng.normal(size=(n_drug, d)).astype(np.float32)
    feat_v = v @ w_v + 0.5 * rng.normal(size=(n_dis, d)).astype(np.float32)
    return dict(enc=(src[enc], dst[enc], y[enc]),
                train=(src[tr], dst[tr], y[tr]),
                test=(src[te], dst[te], y[te]),
                feat_drug=feat_d, feat_dis=feat_v)


def model_config(d: int = D):
    """The JAX script's model: 3 GCMC layers 384/128, FGCN 256/128, the
    128/64 decoder in bf16 on the fused ('pallas') backend."""
    from dream_gnn_tpu_torch.config import ModelConfig

    return ModelConfig(
        layers=3, gcn_agg_units=384, gcn_out_units=128,
        src_in_units=d, dst_in_units=d, fdim_drug=d, fdim_disease=d,
        nhid1=256, nhid2=128, compute_dtype="bfloat16",
        decoder_backend="pallas")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_inputs(prob, n_drug: int, n_dis: int, device):
    """(train ModelInputs, test ModelInputs, slot labels and weights of
    both, layout build seconds) of a problem, on ``device``."""
    from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
    from dream_gnn_tpu_torch.graph.slabbed import build_enc_graph_slabbed
    from dream_gnn_tpu_torch.kernels.scale_decoder import \
        build_scale_decoder_layout
    from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs

    device = torch.device(device)
    _sync(device)
    t0 = time.perf_counter()
    es, ed, ey = prob["enc"]
    graph = build_enc_graph_slabbed(np.stack([es, ed]), ey, n_drug, n_dis,
                                    device=device)
    layouts = {k: build_scale_decoder_layout(prob[k][0], prob[k][1], n_drug,
                                             n_dis, device=device)
               for k in ("train", "test")}
    _sync(device)
    layout_s = time.perf_counter() - t0

    eye_d = coo_from_arrays(np.arange(n_drug), np.arange(n_drug),
                            np.ones(n_drug, np.float32), n_drug, n_drug,
                            device=device)
    eye_v = coo_from_arrays(np.arange(n_dis), np.arange(n_dis),
                            np.ones(n_dis, np.float32), n_dis, n_dis,
                            device=device)
    # f32, as jnp.asarray makes them in the JAX script (numpy computes
    # u / sqrt(rank) in f64).
    fd = torch.from_numpy(prob["feat_drug"].astype(np.float32)).to(device)
    fv = torch.from_numpy(prob["feat_dis"].astype(np.float32)).to(device)
    common = dict(enc_graph=graph, drug_graph=eye_d, drug_sim_feat=fd,
                  drug_feat=fd, dis_graph=eye_v, dis_sim_feat=fv,
                  dis_feat=fv, drug_feature_graph=None,
                  dis_feature_graph=None)
    out = []
    for k in ("train", "test"):
        src, dst, y = prob[k]
        out.append(ModelInputs(
            dec_src=torch.from_numpy(src.astype(np.int32)).to(device),
            dec_dst=torch.from_numpy(dst.astype(np.int32)).to(device),
            dec_layout=layouts[k], **common))
    lab_tr, w_tr = layouts["train"].slot_labels(prob["train"][2])
    lab_te, w_te = layouts["test"].slot_labels(prob["test"][2])
    return out[0], out[1], lab_tr, lab_te, w_tr, w_te, layout_s


def gcmc_model_config(n_users: int, n_movies: int):
    """GCMC alone at the published ml-10m run's widths: one-hot inputs of
    ``n_users`` and ``n_movies``, 10 levels, one 'stack' layer of 500 units
    (50 a level) to 75, leaky, dropout 0.3, share_param off, 4 basis
    matrices, float32."""
    from dream_gnn_tpu_torch.config import ModelConfig
    from dream_gnn_tpu_torch.data.movielens import LEVELS

    return ModelConfig(
        model_kind="gcmc", src_in_units=n_users,
        dst_in_units=n_movies, num_ratings=len(LEVELS), layers=1,
        gcn_agg_units=500, gcn_agg_accum="stack", gcn_out_units=75,
        share_param=False, model_activation="leaky", dropout=0.3,
        gen_r_num_basis_func=4, compute_dtype="float32",
        rating_values=LEVELS)


def build_gcmc_inputs(users, movies, levels, parts, n_users: int,
                      n_movies: int, device, num_ratings: int = 10):
    """GCMC alone's inputs from ratings (users, movies, level indices) and
    the (train, valid, test) index arrays ``parts``, as DGL's data.py
    builds them: the train and valid ratings are decoded over the encoder
    graph of the train ratings, the test ratings over that of the train and
    valid ones; each graph has a relation a level and direction (the
    slabbed layouts), each side the bilinear decoder's layout.  Returns
    ([ModelInputs], [labels], [weights]) of the three sides, the labels the
    level indices in slot order, and the seconds of the layout builds."""
    from dream_gnn_tpu_torch.graph.slabbed import build_enc_graph_slabbed
    from dream_gnn_tpu_torch.kernels.bilinear_decoder import \
        build_bilinear_layout
    from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs
    from dream_gnn_tpu_torch.utils.device import as_tensor

    device = torch.device(device)
    users, movies, levels = (as_tensor(x, torch.int64, device)
                             for x in (users, movies, levels))
    parts = [as_tensor(p, torch.int64, device) for p in parts]
    _sync(device)
    t0 = time.perf_counter()

    def graph(idx):
        return build_enc_graph_slabbed(
            torch.stack([users[idx], movies[idx]]), levels[idx], n_users,
            n_movies, ratings=range(num_ratings), device=device)

    train_graph = graph(parts[0])
    graphs = (train_graph, train_graph, graph(torch.cat(parts[:2])))
    inputs, labels, weights = [], [], []
    for idx, g in zip(parts, graphs):
        layout = build_bilinear_layout(users[idx], movies[idx], n_users,
                                       n_movies, device=device)
        inputs.append(ModelInputs(
            enc_graph=g, dec_src=layout.src, dec_dst=layout.dst,
            drug_graph=None, drug_sim_feat=None, drug_feat=None,
            dis_graph=None, dis_sim_feat=None, dis_feat=None,
            dec_layout=layout))
        labels.append(layout.slot_labels(levels[idx]))
        weights.append(torch.ones(idx.shape[0], dtype=torch.float32,
                                  device=device))
    _sync(device)
    return inputs, labels, weights, time.perf_counter() - t0


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("dream", "gcmc-ml10m"),
                   default="dream",
                   help="DREAM-GNN on the planted problem, or GCMC alone "
                        "on MovieLens-10M")
    p.add_argument("--ratings", type=str, default=None,
                   help="gcmc-ml10m: MovieLens' ratings.dat")
    p.add_argument("--data_seed", type=int, default=SEED,
                   help="gcmc-ml10m: seed of the made ratings and the split")
    p.add_argument("--iters", type=int, default=ITERS,
                   help="train_max_iter: iters - 1 training steps")
    p.add_argument("--quick", action="store_true",
                   help=f"at most {QUICK_ITERS} iterations; gcmc-ml10m: "
                        f"made ratings at a tiny size")
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    p.add_argument("--save_dir", type=str, default=SAVE_DIR)
    p.add_argument("--n_nodes", type=int, default=N_DRUG,
                   help="drugs, and as many diseases")
    p.add_argument("--n_enc", type=int, default=N_ENC)
    p.add_argument("--n_cand", type=int, default=N_CAND,
                   help="train candidates, and as many test candidates")
    p.add_argument("--valid_interval", type=int, default=VALID_INTERVAL)
    p.add_argument("--checkpoint_every", type=int, default=CHECKPOINT_EVERY,
                   help="steps between train-state checkpoints; 0: none")
    p.add_argument("--resume", action="store_true",
                   help="go on from --save_dir's ckpt_fold0.npz")
    return p


def main(argv=None) -> int:
    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.train.loop import train_on_inputs
    from dream_gnn_tpu_torch.utils.device import resolve_device, set_numerics

    args = build_parser().parse_args(argv)
    iters = min(args.iters, QUICK_ITERS) if args.quick else args.iters
    device = resolve_device("cpu" if args.device < 0
                            else f"cuda:{args.device}")
    set_numerics()
    if args.model == "gcmc-ml10m":
        return main_gcmc(args, iters, device)
    n = args.n_nodes

    rng = np.random.default_rng(SEED)
    t_setup = time.perf_counter()
    print("building planted low-rank problem...", flush=True)
    prob = build_problem(rng, n_drug=n, n_dis=n, n_enc=args.n_enc,
                         n_cand=args.n_cand)
    print("building slabbed encoder graph and scale decoder layouts...",
          flush=True)
    (train_inputs, test_inputs, lab_tr, lab_te, w_tr, w_te,
     layout_s) = build_inputs(prob, n, n, device)
    print(f"layout build {layout_s:.3f} s on {device}", flush=True)

    model = model_config()
    cfg = TrainConfig(model=model, beta=0.0, train_max_iter=iters,
                      train_valid_interval=args.valid_interval,
                      save_dir=args.save_dir,
                      checkpoint_every=args.checkpoint_every,
                      save_model=False)
    print(f"setup {time.perf_counter() - t_setup:.1f}s; training "
          f"{iters - 1} iters (eval every {cfg.train_valid_interval})...",
          flush=True)

    os.makedirs(args.save_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ckpt = os.path.join(args.save_dir, "ckpt_fold0.npz")
    resume_from = ckpt if args.resume and os.path.exists(ckpt) else None
    t0 = time.perf_counter()
    res = train_on_inputs(model, cfg, train_inputs, test_inputs, lab_tr,
                          lab_te, w_tr, w_te, gen, save_dir=args.save_dir,
                          save_id=0, verbose=True, resume_from=resume_from)
    wall = time.perf_counter() - t0

    summary = dict(
        iters=iters - 1, wall_clock_s=round(wall, 1),
        ms_per_step=res["ms_per_step"],
        best_test_auroc=round(res["best_auroc"], 4),
        best_test_aupr=round(res["best_aupr"], 4),
        best_iter=res["best_iter"], pos_rate=POS_RATE,
        n_enc_edges=args.n_enc, n_candidates=args.n_cand, nodes=[n, n],
        layout_build_s=layout_s,
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
        config="slabbed encoder + fused scale decoder, bf16, "
               "default augmentation")
    with open(os.path.join(args.save_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("SCALE_TRAIN_SUMMARY " + json.dumps(summary), flush=True)
    ok = res["best_auroc"] > 0.75 and res["best_aupr"] > 2 * POS_RATE
    print(f"LEARNING_{'OK' if ok else 'WEAK'}: best test AUROC "
          f"{res['best_auroc']:.4f}, AUPR {res['best_aupr']:.4f} "
          f"(base rate {POS_RATE})", flush=True)
    return 0 if ok else 1


def main_gcmc(args, iters: int, device) -> int:
    """``--model gcmc-ml10m``: GCMC alone on MovieLens-10M; prints the best
    valid RMSE's iteration and its test RMSE and writes summary.json."""
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.data import movielens
    from dream_gnn_tpu_torch.train.loop import train_on_inputs

    if args.ratings:
        users, movies, levels, n_users, n_movies = movielens.read_ratings(
            args.ratings)
    else:
        n_users, n_movies, n_ratings = QUICK_MOVIELENS if args.quick else (
            movielens.N_USERS, movielens.N_MOVIES, movielens.N_RATINGS)
        users, movies, levels = movielens.synthetic_ratings(
            args.data_seed, n_users, n_movies, n_ratings)
    parts = movielens.split(users.shape[0], args.data_seed)
    inputs, labels, weights, layout_s = build_gcmc_inputs(
        users, movies, levels, parts, n_users, n_movies, device)
    print(f"{users.shape[0]} ratings of {n_users} users and {n_movies} "
          f"movies; layout build {layout_s:.3f} s on {device}", flush=True)
    model = gcmc_model_config(n_users, n_movies)
    cfg = TrainConfig(model=model, augment=AugmentConfig(methods=()),
                      train_lr=0.001, weight_decay=0.0, train_grad_clip=1.0,
                      beta=0.0, train_max_iter=iters,
                      train_valid_interval=args.valid_interval,
                      save_dir=args.save_dir)
    os.makedirs(args.save_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    res = train_on_inputs(model, cfg, inputs[0], inputs[2], labels[0],
                          labels[2], weights[0], weights[2], gen,
                          save_dir=args.save_dir,
                          valid=(inputs[1], labels[1], weights[1]))
    summary = dict(
        iters=iters - 1, ms_per_step=res["ms_per_step"],
        best_valid_rmse=res["best_valid_rmse"],
        best_test_rmse=res["best_rmse"], best_iter=res["best_iter"],
        ratings=int(users.shape[0]), users=n_users, movies=n_movies,
        data=args.ratings or f"made from seed {args.data_seed}",
        layout_build_s=layout_s,
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"))
    with open(os.path.join(args.save_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("GCMC_SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
