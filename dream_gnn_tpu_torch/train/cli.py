"""CLI entry point with reference flag-name parity (train.py:403-452).

Usage:  python -m dream_gnn_tpu_torch.train.cli --data_name Gdataset ...

The flags are those of ``python -m dream_gnn_tpu.train.cli``.  Named
datasets resolve to the synthetic preset of the same name.  ``--device``
has its reference meaning: a GPU index, with -1 for the CPU; a GPU that
is not there is an error, never a quiet fall back to the CPU.

Parts of the JAX trainer the port does not have yet raise
``NotImplementedError`` naming their item in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import dataclasses

from dream_gnn_tpu_torch.config import AugmentConfig, ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.train.harness import run_experiments
from dream_gnn_tpu_torch.utils.device import resolve_device, set_numerics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DREAM-GNN training, PyTorch")
    p.add_argument("--data_name", default="Gdataset", type=str)
    p.add_argument("--data_path", default=None, type=str,
                   help="explicit .mat path (not ported yet)")
    p.add_argument("--save_dir", type=str, default="seed_experiments")
    p.add_argument("--model_activation", type=str, default="leaky")
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--gcn_agg_units", type=int, default=1024)
    p.add_argument("--gcn_agg_accum", type=str, default="sum")
    p.add_argument("--gcn_out_units", type=int, default=128)
    p.add_argument("--train_max_iter", type=int, default=18000)
    p.add_argument("--train_grad_clip", type=float, default=1.0)
    p.add_argument("--train_valid_interval", type=int, default=250)
    # The reference uses type=bool here (train.py:416), which makes any
    # explicit value truthy; a real str->bool makes symm=False reachable.
    p.add_argument("--gcn_agg_norm_symm",
                   type=lambda s: s.lower() not in ("false", "0", "no"),
                   default=True)
    p.add_argument("--nhid1", type=int, default=768)
    p.add_argument("--nhid2", type=int, default=128)
    p.add_argument("--train_lr", type=float, default=0.002)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--share_param", default=True, action="store_true")
    p.add_argument("--num_neighbor", type=int, default=4)
    p.add_argument("--beta", type=float, default=0.001)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--attention_dropout", type=float, default=0.1)
    p.add_argument("--aug_methods", type=str, nargs="+",
                   default=["edge_dropout", "feature_noise"],
                   choices=["edge_dropout", "add_random_edges",
                            "feature_noise", "graph_noise",
                            "feature_masking", "mix_up"])
    p.add_argument("--edge_dropout_rate", type=float, default=0.1)
    p.add_argument("--add_edge_rate", type=float, default=0.03)
    p.add_argument("--feature_noise_scale", type=float, default=0.05)
    p.add_argument("--graph_noise_scale", type=float, default=0.03)
    p.add_argument("--feature_mask_rate", type=float, default=0.1)
    p.add_argument("--mixup_alpha", type=float, default=0.2)
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--device", type=int, default=0,
                   help="GPU index; -1 runs on the CPU")
    p.add_argument("--save_id", type=int, default=None,
                   help="reference log-save id; accepted for parity, "
                        "ignored — fold ids are cv+1 (train.py:501)")
    p.add_argument("--l2_reg_weight", type=float, default=0.0,
                   help="parsed but never used by the reference "
                        "(train.py:426); weight decay is --weight_decay")
    p.add_argument("--embedding_mode", type=str, default="pretrained",
                   choices=["pretrained", "random"])
    p.add_argument("--use_augmentation", action="store_true", default=False,
                   help="loader-side feature augmentation for novel "
                        "prediction only (not ported yet)")
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--generate_top_predictions", action="store_true",
                   default=False)
    p.add_argument("--top_k", type=int, default=200)
    p.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="override the fixed seed list")
    p.add_argument("--folds", type=int, nargs="+", default=None,
                   help="subset of CV folds to run")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="decoder matmul operand dtype (f32 accumulation)")
    p.add_argument("--decoder_backend", type=str, default="pallas",
                   choices=["xla", "pallas"],
                   help="'pallas': the fused CUDA decoder kernels; "
                        "'xla': the plain PyTorch decoders")
    p.add_argument("--decode_mode", type=str, default="grid",
                   choices=["edges", "grid"])
    p.add_argument("--rng_impl", type=str, default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="accepted for parity; the port uses torch.Generator")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fold_parallel", action="store_true")
    p.add_argument("--seed_parallel", action="store_true")
    return p


# (flag is set, ROADMAP.md queue A item that ports it)
_NOT_PORTED = (
    (lambda a: a.resume, "--resume", "5: checkpoint and resume"),
    (lambda a: a.checkpoint_every > 0, "--checkpoint_every",
     "5: checkpoint and resume"),
    (lambda a: a.generate_top_predictions, "--generate_top_predictions",
     "5: novel predictions"),
    (lambda a: a.data_path is not None
     or a.data_name.endswith(".mat"), "--data_path (.mat)",
     "11: .mat and embedding loaders"),
    (lambda a: a.profile_dir is not None, "--profile_dir",
     "11: timing and profiling"),
)


def check_ported(args) -> None:
    for is_set, flag, item in _NOT_PORTED:
        if is_set(args):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md queue A, item {item})")


def config_from_args(args) -> TrainConfig:
    model = ModelConfig(
        layers=args.layers, gcn_agg_units=args.gcn_agg_units,
        gcn_agg_accum=args.gcn_agg_accum, gcn_out_units=args.gcn_out_units,
        share_param=args.share_param, model_activation=args.model_activation,
        nhid1=args.nhid1, nhid2=args.nhid2, dropout=args.dropout,
        attention_dropout=args.attention_dropout,
        compute_dtype=args.compute_dtype,
        decoder_backend=args.decoder_backend,
        decode_mode=args.decode_mode)
    augment = AugmentConfig(
        methods=tuple(args.aug_methods),
        edge_dropout_rate=args.edge_dropout_rate,
        add_edge_rate=args.add_edge_rate,
        feature_noise_scale=args.feature_noise_scale,
        graph_noise_scale=args.graph_noise_scale,
        feature_mask_rate=args.feature_mask_rate,
        mixup_alpha=args.mixup_alpha)
    cfg = TrainConfig(
        data_name=args.data_name, save_dir=args.save_dir,
        num_neighbor=args.num_neighbor,
        gcn_agg_norm_symm=args.gcn_agg_norm_symm,
        train_lr=args.train_lr, weight_decay=args.weight_decay,
        train_grad_clip=args.train_grad_clip,
        train_max_iter=args.train_max_iter,
        train_valid_interval=args.train_valid_interval,
        beta=args.beta, label_smoothing=args.label_smoothing,
        save_model=args.save_model,
        use_augmentation=args.use_augmentation,
        generate_top_predictions=args.generate_top_predictions,
        top_k=args.top_k, model=model, augment=augment,
        rng_impl=args.rng_impl,
        checkpoint_every=args.checkpoint_every, resume=args.resume)
    if args.seeds is not None:
        cfg = dataclasses.replace(cfg, seeds=tuple(args.seeds))
    return cfg


def device_from_args(args):
    return resolve_device("cpu" if args.device < 0
                          else f"cuda:{args.device}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    cfg = config_from_args(args)
    device = device_from_args(args)
    set_numerics()
    print(args)
    dataset = DreamDataset.load(cfg.data_name, k=cfg.num_neighbor,
                                symm=cfg.gcn_agg_norm_symm,
                                n_folds=cfg.n_folds,
                                kfold_seed=cfg.kfold_seed,
                                embedding_mode=args.embedding_mode,
                                device=device)
    return run_experiments(dataset, cfg, seeds=args.seeds, folds=args.folds,
                           fold_parallel=args.fold_parallel,
                           seed_parallel=args.seed_parallel)


if __name__ == "__main__":
    main()
