"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. device and build: the card's name and power limit, then the CUDA
   kernels built from the sources in the checkout (nvcc's register and
   shared-memory report is printed);
2. kernels against their plain PyTorch versions at Gdataset width
   (593 drugs x 313 diseases), fp32 and bf16, dropout 0 and 0.3: forward
   logits and all six gradients, each within a stated tolerance; a
   control showing that the bf16 tolerance sees a kernel that does not
   round; then each kernel's time beside its bound and the plain
   version's time;
3. the model's eval forward on the card (kernel) against the same
   forward on the CPU (plain version), at full default width;
4. the trainer through the port's CLI at full default width: a few
   training steps and two eval intervals, with the kernels' launch counts;
5. a profile of ten default training steps: step time, device busy share
   and the kernels that take the device's time.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet), used for the bound.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

ND, NV = 593, 313            # Gdataset preset (data/synthetic.py)
# Tolerances on max|kernel - plain| / max|plain|, per output.  Both dtypes
# run the same arithmetic and differ only in the order of their f32 sums:
# in bf16 mode both round h1d, w2, da2, g and h2d at the same points, and
# a product of bf16 values is exact in f32.  The largest error measured
# in either dtype was below 1e-6 (PERF.md).  A bf16 kernel that skipped
# its rounding would be off by 3e-3 to 7e-2 (the control case below).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
GRAD_NAMES = ("dPd", "dPv", "db1", "dW2", "db2", "dw3")
# Outputs that the bf16 rounding must move: all but db2, which sums the
# unrounded da2 and moves only where a relu flips.
ROUNDED = ("logits", "dPd", "dPv", "db1", "dW2", "dw3")
# The CLI's defaults (train/cli.py), which ModelConfig's own defaults are not.
MAIN_PATH = dict(compute_dtype="bfloat16", decoder_backend="pallas",
                 decode_mode="grid")


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _decoder_inputs(dev):
    rng = np.random.default_rng(0)
    h1, h2 = 128, 64

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return dict(
        pd=t(rng.normal(0, 0.5, (ND, h1))), pv=t(rng.normal(0, 0.5, (NV, h1))),
        b1=t(rng.uniform(-0.06, 0.06, h1)),
        w2=t(rng.uniform(-0.09, 0.09, (h1, h2))),
        b2=t(rng.uniform(-0.09, 0.09, h2)), w3=t(rng.uniform(-0.12, 0.12, h2)),
        g=t(rng.normal(0, 1e-3, (ND, NV))),
        seed=torch.tensor([918273], dtype=torch.int32, device=dev))


def _bound_ms(fwd: bool, dtype) -> tuple:
    h1, h2 = 128, 64
    cells = ND * NV
    per_cell = 2 * h1 * h2 + 2 * h1 + 2 * h2             # a2 product, a1, w3 dot
    if not fwd:
        # The recomputed forward, the dh1 and dW2 products, then g * w3,
        # the db2 and dw3 sums and the dPd, dPv and db1 sums.
        per_cell += 2 * (2 * h1 * h2) + 4 * h2 + 3 * h1
    flops = cells * per_cell
    table_bytes = (ND + NV) * h1 * 4
    weight_bytes = (h1 + h1 * h2 + 2 * h2) * 4
    grid_bytes = cells * 4                                # out, or g
    nbytes = table_bytes + weight_bytes + grid_bytes
    if not fwd:
        nbytes += table_bytes + weight_bytes              # the gradients
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    print("== build")
    t0 = time.perf_counter()
    report = gd.build(force=True)
    print(f"{report}  nvcc build: {time.perf_counter() - t0:.2f} s")


def phase_kernels():
    """Kernel vs plain version; returns the table's rows without launches."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    dev = torch.device("cuda", 0)
    x = _decoder_inputs(dev)
    args = [x[k] for k in ("pd", "pv", "b1", "w2", "b2", "w3", "seed")]
    print(f"== kernels vs plain at {ND} x {NV}, H1 128, H2 64")
    err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.3):
            ref = gd.grid_decoder_plain(*args, rate, True, dtype)
            out = gd.launch_fwd(*args, rate, True, dtype)
            ref_g = gd.grid_decoder_plain_bwd(*args, rate, True, dtype, x["g"])
            out_g = gd.launch_bwd(*args, rate, True, dtype, x["g"])
            torch.cuda.synchronize()
            pairs = [("logits", out, ref)] + list(zip(GRAD_NAMES, out_g, ref_g))
            for name, a, b in pairs:
                if a.shape != b.shape:
                    raise AssertionError(f"{name}: shape {a.shape} != {b.shape}")
                abs_err = float((a - b).abs().max())
                rel = abs_err / max(float(b.abs().max()), 1e-30)
                kind = "fwd" if name == "logits" else "bwd"
                err[kind] = max(err[kind], abs_err)
                ok = rel <= TOL[dtype] and bool(torch.isfinite(a).all())
                print(f"  {str(dtype)[6:]:8s} rate={rate:.1f} {name:6s} "
                      f"max_abs_err={abs_err:.3e} rel={rel:.3e} "
                      f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} ({dtype}, rate {rate}) "
                                         f"disagrees with the plain version")
    # Control: the fp32 kernel, which rounds nothing, held against the bf16
    # plain version must fail the bf16 tolerance, or that tolerance could
    # not see a bf16 kernel that skipped its rounding.
    for rate in (0.0, 0.3):
        ref = gd.grid_decoder_plain(*args, rate, True, torch.bfloat16)
        ref_g = gd.grid_decoder_plain_bwd(*args, rate, True, torch.bfloat16,
                                          x["g"])
        out = gd.launch_fwd(*args, rate, True, torch.float32)
        out_g = gd.launch_bwd(*args, rate, True, torch.float32, x["g"])
        for name, a, b in [("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                            ref_g)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            print(f"  control fp32 kernel vs bf16 plain rate={rate:.1f} "
                  f"{name:6s} rel={rel:.3e}")
            if name in ROUNDED and rel <= TOL[torch.bfloat16]:
                raise AssertionError(f"control: {name} without bf16 rounding "
                                     f"passes the bf16 tolerance")
    # Main-path case: bf16, dropout 0.3, training.
    dtype, rate = torch.bfloat16, 0.3
    launches = dict(gd.LAUNCHES)
    t = {
        "fwd": _time_ms(lambda: gd.launch_fwd(*args, rate, True, dtype)),
        "bwd": _time_ms(lambda: gd.launch_bwd(*args, rate, True, dtype,
                                              x["g"])),
    }
    with torch.no_grad():
        tp = {
            "fwd": _time_ms(lambda: gd.grid_decoder_plain(*args, rate, True,
                                                          dtype), reps=5),
            "bwd": _time_ms(lambda: gd.grid_decoder_plain_bwd(
                *args, rate, True, dtype, x["g"]), reps=5),
        }
    gd.LAUNCHES.update(launches)
    rows = []
    for kind, line in (("fwd", 102), ("bwd", 122)):
        bound, by = _bound_ms(kind == "fwd", dtype)
        print(f"  grid_decoder_{kind}: {t[kind]:.4f} ms, bound {bound:.4f} ms "
              f"({by}), plain {tp[kind]:.4f} ms; no single PyTorch call "
              f"computes this function")
        rows.append(dict(
            name=f"grid_decoder_{kind}", route="cuda",
            source="dream_gnn_tpu_torch/kernels/csrc/grid_decoder.cu",
            replaces=f"dream_gnn_tpu/kernels/pallas_grid_decoder.py:{line}",
            launches=0, max_abs_err=err[kind], ms=t[kind], plain_ms=tp[kind],
            bound_ms=bound, bound_by=by, library_ms=None))
    return rows


def phase_model():
    """Eval forward at full default width: card (kernel) vs CPU (plain)."""
    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, init_params,
                                                     map_params)
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs

    print("== model eval forward, card vs CPU, Gdataset default width")
    cfg = TrainConfig()
    outs = {}
    params_cpu = None
    for dev in ("cpu", "cuda:0"):
        ds = DreamDataset.load("Gdataset", k=cfg.num_neighbor, device=dev)
        mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **MAIN_PATH)
        if params_cpu is None:
            params_cpu = init_params(torch.Generator().manual_seed(0), mcfg)
        params = map_params(lambda t: t.to(dev), params_cpu)
        train_inputs, _ = fold_inputs(ds, 0)
        with torch.no_grad():
            pred, *_ = forward(params, train_inputs, mcfg, train=False)
        outs[dev] = pred.cpu()
    a, b = outs["cuda:0"], outs["cpu"]
    if a.shape != (ND, NV) or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"model logits: shape {tuple(a.shape)} or "
                             f"non-finite values")
    rel = float((a - b).abs().max()) / float(b.abs().max())
    print(f"  logits {tuple(a.shape)} rel_err={rel:.3e} tol=1e-02")
    if rel > 1e-2:
        raise AssertionError("model logits on the card disagree with the CPU")


def phase_trainer():
    """Trainer steps through the CLI; returns the kernels' launch counts."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.train.cli import main

    print("== trainer: python -m dream_gnn_tpu_torch.train.cli "
          "(Gdataset defaults)")
    with tempfile.TemporaryDirectory() as save_dir:
        for k in gd.LAUNCHES:
            gd.LAUNCHES[k] = 0
        summary = main(["--data_name", "Gdataset", "--seeds", "77",
                        "--folds", "0", "--train_max_iter", "41",
                        "--train_valid_interval", "20",
                        "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches = dict(gd.LAUNCHES)
        seed_dir = Path(save_dir, "seed_77")
        rows = (seed_dir / "test_metric1.csv").read_text().split()
        last = dict(zip(rows[0].split(","), map(float, rows[-1].split(","))))
        if len(rows) != 3:
            raise AssertionError(f"expected 2 eval intervals, got {rows}")
        for name in ("loss", "train_auroc", "test_auroc"):
            if not np.isfinite(last[name]):
                raise AssertionError(f"trainer {name} is not finite: {last}")
        if not np.isfinite(summary["mean_auroc"]):
            raise AssertionError(f"summary AUROC is not finite: {summary}")
        for f in (seed_dir / "test_metric1.csv", seed_dir / "best_metric1.csv",
                  seed_dir / "experiment_results.csv",
                  Path(save_dir, "summary_results.csv")):
            if not f.exists():
                raise AssertionError(f"missing artifact {f.name}")
    print(f"  launches on the trainer path: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"grid_decoder_{k} never launched on the "
                                 f"trainer path")
    return launches


def phase_profile(n_steps: int = 10):
    """Where a default training step's time goes: ``n_steps`` steady
    steps under torch.profiler; device busy share and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    print(f"== profile: {n_steps} training steps, Gdataset defaults")
    cfg = TrainConfig()
    ds = DreamDataset.load("Gdataset", k=cfg.num_neighbor, device="cuda:0")
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **MAIN_PATH)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    state = init_state(init_params(gen, mcfg), gen, cfg)
    step = make_one_step(mcfg, cfg)
    inputs, _ = fold_inputs(ds, 0)
    step_ms = _time_ms(lambda: step(state, inputs), reps=n_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step(state, inputs)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # Device kernels only: host ops' kernels are listed themselves, and
        # record_function ranges (e.g. "Optimizer.step#Adam.step") would
        # count their kernels twice.
        if ev.device_type != DeviceType.CUDA or "#" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_steps, ev.count / n_steps, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"  step {step_ms:.3f} ms (CUDA events, no profiler); device "
          f"kernels {busy_ms:.3f} ms/step = {100 * busy_ms / step_ms:.1f}% "
          f"busy" + ("" if rows else " (profiler saw no device time: "
                     "not measured)"))
    print(f"  {sum(r[1] for r in rows):.0f} kernels per step; top by device "
          f"time (ms/step, calls/step, name):")
    for ms, count, key in rows[:12]:
        print(f"    {ms:8.4f} {count:6.1f}  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    gpu = _gpu_line()
    print(f"== device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    phase_build()
    rows = phase_kernels()
    phase_model()
    launches = phase_trainer()
    phase_profile()
    for row in rows:
        row["launches"] = launches[row["name"].rsplit("_", 1)[1]]
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
