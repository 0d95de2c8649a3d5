"""AUPR regression gate of the port, on the card.

    python -m dream_gnn_tpu_torch.scripts.aupr_gate_check [--device N]
    python -m dream_gnn_tpu_torch.scripts.aupr_gate_check --full-band
    python -m dream_gnn_tpu_torch.scripts.aupr_gate_check --make-band \\
        --out PATH

Port of the JAX package's ``scripts/aupr_gate_check.py``.  The default
mode runs the short protocol (seed ``GATE_SEED`` x 10 folds, 2001
iterations, an eval every 250, fold-parallel, the fused grid decoder
kernels, bf16 decoder operands, the Gdataset preset) and gates its per-fold
test-AUPR distribution (eval/aupr_gate.py ``gate``) against the band in
``results/gate_short_protocol/aupr_distribution.json``; ``--full-band``
runs seed ``FULL_GATE_SEED`` through the full 18,000-iteration protocol and
gates it against ``results/Gdataset_full_v2/``.  Exit 0 when the gate
passes, 1 when it fails.

The bands in ``results/`` come from the JAX package's runs, which draw
their random numbers from another generator, and stay as they are: a run
outside them is a finding, not a reason to widen them.

Two differences from the JAX script, both on purpose:
- with no CUDA device the script exits 2 before it trains, unless the
  caller asks for the CPU (``--device -1``); the JAX script skipped with
  exit 0 off the TPU, which would hide a missing card;
- ``--make-band`` writes the band (5 seeds x 10 folds of the short
  protocol) only to the ``--out`` path that the caller names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

RESULTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "results")
BAND_PATH = os.path.join(RESULTS, "gate_short_protocol",
                         "aupr_distribution.json")
BAND_SEEDS = [77, 31415, 888, 1001, 9999]
# Held out of BAND_SEEDS: a gate run whose seed helped define the band is
# partly circular.  42 is one of the reference's fixed seeds
# (train.py:471).
GATE_SEED = 42
SHORT_ITERS = 2001
FULL_BAND_DIR = os.path.join(RESULTS, "Gdataset_full_v2")
FULL_BAND_PATH = os.path.join(FULL_BAND_DIR, "aupr_distribution.json")
# Held out of every full-protocol band run (checked against its seed_<n>
# directories when the gate runs).
FULL_GATE_SEED = 555
DATA_NAME = "Gdataset"
# The production execution: the fused grid decoder kernels, bf16 operands.
MODEL = dict(decoder_backend="pallas", decode_mode="grid",
             compute_dtype="bfloat16")


def short_cfg(save_dir: str, iters: int):
    from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig

    return TrainConfig(data_name=DATA_NAME, model=ModelConfig(**MODEL),
                       train_max_iter=iters, train_valid_interval=250,
                       save_dir=save_dir, save_model=False,
                       generate_top_predictions=False)


def run_protocol(seeds, save_dir: str, device, iters: int) -> np.ndarray:
    """The protocol of ``seeds`` x 10 folds, fold-parallel, into
    ``save_dir``; returns its per-fold best test AUPRs."""
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.eval.aupr_gate import collect_fold_auprs
    from dream_gnn_tpu_torch.train.harness import run_experiments
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    cfg = short_cfg(save_dir, iters)
    dataset = DreamDataset.load(cfg.data_name, k=cfg.num_neighbor,
                                device=device)
    run_experiments(dataset, cfg, seeds=seeds, verbose=True,
                    fold_parallel=True)
    return collect_fold_auprs(save_dir)


def _gate(observed: np.ndarray, band_path: str, tag: str) -> int:
    from dream_gnn_tpu_torch.eval.aupr_gate import gate

    with open(band_path) as f:
        ref = json.load(f)
    ok, report = gate(observed, ref)
    print("per-fold AUPR: " + ", ".join(f"{x:.4f}" for x in observed))
    print(json.dumps(report, indent=2))
    if ok:
        print(f"{tag}_OK n={report['n']} mean={float(np.mean(observed)):.4f} "
              f"(band {band_path})")
        return 0
    print(f"{tag}_FAIL: per-fold AUPR distribution outside the band "
          f"{band_path}; see the report above")
    return 1


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--full-band", action="store_true",
                      help="gate the full protocol of FULL_GATE_SEED")
    mode.add_argument("--make-band", action="store_true",
                      help="write a short-protocol band to --out")
    p.add_argument("--out", type=str, default=None,
                   help="the band file --make-band writes")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.make_band and not args.out:
        print("aupr_gate_check: --make-band needs --out; the bands under "
              "results/ stay as they are", file=sys.stderr)
        return 2
    if args.device >= 0 and not torch.cuda.is_available():
        print("aupr_gate_check: no CUDA device (pass --device -1 to run "
              "on the CPU)", file=sys.stderr)
        return 2
    from dream_gnn_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.device < 0
                            else f"cuda:{args.device}")
    print(f"device: {torch.cuda.get_device_name(device)}"
          if device.type == "cuda" else "device: cpu", flush=True)

    if args.make_band:
        from dream_gnn_tpu_torch.eval.aupr_gate import distribution_summary

        with tempfile.TemporaryDirectory(prefix="aupr_band_") as tmp:
            auprs = run_protocol(BAND_SEEDS, tmp, device, SHORT_ITERS)
        summary = distribution_summary(auprs)
        summary["protocol"] = {
            "data_name": DATA_NAME, "iters": SHORT_ITERS,
            "seeds": BAND_SEEDS, "folds": 10,
            "exec": "fold_parallel grid-decoder bf16"}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"band written: {args.out} (n={summary['n']}, "
              f"mean={summary['mean']:.4f})")
        return 0

    if args.full_band:
        from dream_gnn_tpu_torch.config import TrainConfig

        band_seeds = sorted(int(n.split("_", 1)[1])
                            for n in os.listdir(FULL_BAND_DIR)
                            if n.startswith("seed_"))
        if FULL_GATE_SEED in band_seeds:
            raise ValueError(f"full-gate seed {FULL_GATE_SEED} helped "
                             f"define the band {FULL_BAND_PATH}")
        iters = TrainConfig().train_max_iter
        with tempfile.TemporaryDirectory(prefix="aupr_fgate_") as tmp:
            observed = run_protocol([FULL_GATE_SEED], tmp, device, iters)
        return _gate(observed, FULL_BAND_PATH, "AUPR_FULL_GATE")

    with tempfile.TemporaryDirectory(prefix="aupr_gate_") as tmp:
        observed = run_protocol([GATE_SEED], tmp, device, SHORT_ITERS)
    return _gate(observed, BAND_PATH, "AUPR_GATE")


if __name__ == "__main__":
    sys.exit(main())
