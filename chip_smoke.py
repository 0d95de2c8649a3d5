"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. device and build: the card's name and power limit, then the CUDA
   kernels built from the sources in the checkout, one nvcc per source in
   parallel (nvcc's register and shared-memory report is printed);
2. kernels against their plain PyTorch versions at Gdataset width
   (593 drugs x 313 diseases), fp32 and bf16, dropout 0 and 0.3: forward
   logits and all six gradients, each within a stated tolerance; a
   control showing that the bf16 tolerance sees a kernel that does not
   round; then each kernel's time beside its bound and the plain
   version's time;
3. the fold-batched kernels the same way at F = 3 folds of the full grid,
   plus: fold f of a batched forward equals the single-fold kernel with
   seed[f] bit for bit, and two batched backward launches give the same
   bits; then their times at F = 10, bf16, dropout 0.3;
4. the per-edge kernels on fold 0's real train list (167,168 edges over
   the Gdataset tables) the same way, plus: an fp32 edge logit with
   dropout equals the grid kernel's cell [src, dst], and two backward
   launches give the same bits; then their times, the CSR build's and the
   da1 buffer's size;
5. the fold-batched per-edge kernels at F = 3 folds' real lists, fold f
   equal to the single-fold kernel with seed[f] bit for bit, determinism;
   their times at F = 10;
6. the model's eval forward on the card (kernels) against the same
   forward on the CPU (plain versions), at full default width, in grid
   and in edges mode;
7. the trainer through the port's CLI at full default width: a few
   training steps and two eval intervals, with the kernels' launch counts;
8. the fold-parallel trainer through the CLI (``--fold_parallel``, all 10
   folds of one seed as one stack): ms per stacked step and per
   fold-step, and the batched kernels' launch counts;
9. the trainer of 7 with ``--decode_mode edges``: only the single-fold
   edge kernels launch;
10. the trainer of 8 with ``--decode_mode edges``: only the batched edge
    kernels launch;
11. ``--decoder_backend xla --decode_mode edges``: the plain decoder,
    finite metrics and no decoder kernel launched;
12. a profile of ten default training steps: step time, device busy share
    and the kernels that take the device's time;
13. the same profile of ten stacked steps of the 10 folds, whose kernels
    per step must stay within twice the sequential step's;
14-15. the profiles of 12 and 13 in edges mode.

Each trainer phase sets every launch count to 0 just before it drives the
CLI and reads the counts just after.

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
NF_CHECK, NF = 3, 10         # folds: batched checks, batched timing and trainer
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
EDGES_PATH = dict(MAIN_PATH, decode_mode="edges")
KERNEL_ARGS = ("pd", "pv", "b1", "w2", "b2", "w3", "seed")


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


def _decoder_inputs(dev, nf=None):
    """Decoder kernel inputs; with ``nf`` every tensor gains a leading fold
    axis and each fold its own seed."""
    rng = np.random.default_rng(0)
    h1, h2 = 128, 64
    lead = () if nf is None else (nf,)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return dict(
        pd=t(rng.normal(0, 0.5, (*lead, ND, h1))),
        pv=t(rng.normal(0, 0.5, (*lead, NV, h1))),
        b1=t(rng.uniform(-0.06, 0.06, (*lead, h1))),
        w2=t(rng.uniform(-0.09, 0.09, (*lead, h1, h2))),
        b2=t(rng.uniform(-0.09, 0.09, (*lead, h2))),
        w3=t(rng.uniform(-0.12, 0.12, (*lead, h2))),
        g=t(rng.normal(0, 1e-3, (*lead, ND, NV))),
        seed=torch.tensor([918273] if nf is None
                          else rng.integers(0, 2 ** 31 - 1, nf),
                          dtype=torch.int32, device=dev))


def _bound_ms(fwd: bool, dtype, nf: int = 1, cells: int = ND * NV,
              index_bytes: int = 0) -> tuple:
    """(least ms, "operations" or "bytes") of the decoder MLP over ``cells``
    grid cells or edges per fold; ``index_bytes`` are the edge ids read."""
    h1, h2 = 128, 64
    per_cell = 2 * h1 * h2 + 2 * h1 + 2 * h2             # a2 product, a1, w3 dot
    if not fwd:
        # The recomputed forward, the dh1 and dW2 products, then g * w3,
        # the db2 and dw3 sums and the dPd, dPv and db1 sums.
        per_cell += 2 * (2 * h1 * h2) + 4 * h2 + 3 * h1
    flops = nf * cells * per_cell
    table_bytes = nf * (ND + NV) * h1 * 4
    weight_bytes = nf * (h1 + h1 * h2 + 2 * h2) * 4
    grid_bytes = nf * cells * 4                           # out, or g
    nbytes = table_bytes + weight_bytes + grid_bytes + index_bytes
    if not fwd:
        nbytes += table_bytes + weight_bytes              # the gradients
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from dream_gnn_tpu_torch.kernels import cuda_build

    print("== build")
    t0 = time.perf_counter()
    report = cuda_build.build(force=True)
    print(f"{report}  nvcc build: {time.perf_counter() - t0:.2f} s")


def _compare(pairs, dtype, rate, label, err):
    """Hold (name, kernel, plain) outputs to TOL; ``err`` keeps the largest
    absolute error per direction."""
    for name, a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {a.shape} != {b.shape}")
        abs_err = float((a - b).abs().max())
        rel = abs_err / max(float(b.abs().max()), 1e-30)
        kind = "fwd" if name == "logits" else "bwd"
        err[kind] = max(err[kind], abs_err)
        ok = rel <= TOL[dtype] and bool(torch.isfinite(a).all())
        print(f"  {label} {str(dtype)[6:]:8s} rate={rate:.1f} {name:6s} "
              f"max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {name} ({dtype}, rate {rate}) "
                                 f"disagrees with the plain version")


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
            _compare([("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                       ref_g)),
                     dtype, rate, "single", err)
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


def phase_kernels_batched():
    """Fold-batched kernels vs plain version at F = 3, fold vs single-fold
    kernel, determinism; timing at F = 10.  Returns the table's rows
    without launches."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    dev = torch.device("cuda", 0)
    x = _decoder_inputs(dev, NF_CHECK)
    args = [x[k] for k in ("pd", "pv", "b1", "w2", "b2", "w3", "seed")]
    print(f"== batched kernels vs plain at F={NF_CHECK} x {ND} x {NV}")
    err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.3):
            out = gd.launch_fwd_batched(*args, rate, True, dtype)
            out_g = gd.launch_bwd_batched(*args, rate, True, dtype, x["g"])
            ref = gd.grid_decoder_batched_plain(*args, rate, True, dtype)
            ref_g = gd.grid_decoder_batched_plain_bwd(*args, rate, True,
                                                      dtype, x["g"])
            torch.cuda.synchronize()
            _compare([("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                       ref_g)),
                     dtype, rate, "batched", err)
            del ref, ref_g
            # Fold f of the batched launch is the single-fold kernel called
            # with seed[f], bit for bit.
            for f in range(NF_CHECK):
                one = gd.launch_fwd(*[a[f].contiguous() for a in args[:6]],
                                    args[6][f:f + 1].contiguous(), rate, True,
                                    dtype)
                if not torch.equal(one, out[f]):
                    raise AssertionError(f"batched fold {f} ({dtype}, rate "
                                         f"{rate}) != single-fold kernel")
            print(f"  batched {str(dtype)[6:]:8s} rate={rate:.1f} every fold "
                  f"equals the single-fold kernel bit for bit")
    again = gd.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, x["g"])
    first = gd.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, x["g"])
    if not all(torch.equal(a, b) for a, b in zip(again, first)):
        raise AssertionError("two batched backward launches differ")
    print("  batched backward: two launches give identical bits")
    for rate in (0.0, 0.3):
        ref = gd.grid_decoder_batched_plain(*args, rate, True, torch.bfloat16)
        ref_g = gd.grid_decoder_batched_plain_bwd(*args, rate, True,
                                                  torch.bfloat16, x["g"])
        out = gd.launch_fwd_batched(*args, rate, True, torch.float32)
        out_g = gd.launch_bwd_batched(*args, rate, True, torch.float32, x["g"])
        for name, a, b in [("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                            ref_g)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            print(f"  control fp32 batched kernel vs bf16 plain "
                  f"rate={rate:.1f} {name:6s} rel={rel:.3e}")
            if name in ROUNDED and rel <= TOL[torch.bfloat16]:
                raise AssertionError(f"control: batched {name} without bf16 "
                                     f"rounding passes the bf16 tolerance")
        del ref, ref_g
    # Main-path case at the trainer's F: bf16, dropout 0.3, training.
    x = _decoder_inputs(dev, NF)
    args = [x[k] for k in ("pd", "pv", "b1", "w2", "b2", "w3", "seed")]
    dtype, rate = torch.bfloat16, 0.3
    launches = dict(gd.LAUNCHES)
    t = {
        "fwd": _time_ms(lambda: gd.launch_fwd_batched(*args, rate, True,
                                                      dtype)),
        "bwd": _time_ms(lambda: gd.launch_bwd_batched(*args, rate, True,
                                                      dtype, x["g"])),
    }
    with torch.no_grad():
        tp = {
            "fwd": _time_ms(lambda: gd.grid_decoder_batched_plain(
                *args, rate, True, dtype), reps=3),
            "bwd": _time_ms(lambda: gd.grid_decoder_batched_plain_bwd(
                *args, rate, True, dtype, x["g"]), reps=3),
        }
    gd.LAUNCHES.update(launches)
    rows = []
    for kind, line in (("fwd", 406), ("bwd", 427)):
        bound, by = _bound_ms(kind == "fwd", dtype, NF)
        print(f"  grid_decoder_{kind}_batched F={NF}: {t[kind]:.4f} ms "
              f"({t[kind] / NF:.4f} ms per fold), bound {bound:.4f} ms "
              f"({by}), plain {tp[kind]:.4f} ms; no single PyTorch call "
              f"computes this function")
        rows.append(dict(
            name=f"grid_decoder_{kind}_batched", route="cuda",
            source="dream_gnn_tpu_torch/kernels/csrc/grid_decoder.cu",
            replaces=f"dream_gnn_tpu/kernels/pallas_grid_decoder.py:{line}",
            launches=0, max_abs_err=err[kind], ms=t[kind], plain_ms=tp[kind],
            bound_ms=bound, bound_by=by, library_ms=None))
    return rows


def _edge_inputs(ds, nf=None):
    """Edge kernel inputs on fold 0's real train list (or the stacked train
    lists of folds 0 .. nf-1): random Gdataset-sized tables and weights,
    the edges, their CSR orderings and a cotangent that is 0 on padding."""
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import fold_inputs

    x = _decoder_inputs(ds.device, nf)
    if nf is None:
        inputs, _, _, _ = fold_inputs(ds, 0)
        w = ds.fold(0).train_w
    else:
        stacked = stack_folds(ds, list(range(nf)))
        inputs, w = stacked.inputs, stacked.edge_weight
    x["edges"] = torch.stack([inputs.dec_src, inputs.dec_dst], dim=-2) \
        .contiguous()
    x["csr"] = inputs.dec_csr
    rng = np.random.default_rng(1)
    x["g"] = torch.tensor(rng.normal(0, 1e-3, tuple(w.shape)).astype(
        np.float32), device=ds.device) * w
    return x


def _edge_row(kind, batched, err, t, tp, dtype, ne, nf=1):
    line = {("fwd", False): "pallas_decoder.py:99",
            ("bwd", False): "pallas_decoder.py:120",
            ("fwd", True): "pallas_decoder_batched.py:43",
            ("bwd", True): "pallas_decoder_batched.py:63"}[kind, batched]
    name = f"edge_decoder_{kind}" + ("_batched" if batched else "")
    bound, by = _bound_ms(kind == "fwd", dtype, nf, cells=ne,
                          index_bytes=nf * 2 * ne * 4)
    print(f"  {name} F={nf} E={ne}: {t[kind]:.4f} ms ({t[kind] / nf:.4f} ms "
          f"per fold), bound {bound:.5f} ms ({by}), plain {tp[kind]:.4f} ms; "
          f"no single PyTorch call computes this function")
    return dict(name=name, route="cuda",
                source="dream_gnn_tpu_torch/kernels/csrc/edge_decoder.cu",
                replaces=f"dream_gnn_tpu/kernels/{line}", launches=0,
                max_abs_err=err[kind], ms=t[kind], plain_ms=tp[kind],
                bound_ms=bound, bound_by=by, library_ms=None)


def _edge_checks(ed, x, batched, label, err):
    """Edge kernel vs plain version (fp32/bf16, rate 0/0.3), then the
    control that the bf16 tolerance sees missing rounding."""
    fwd = ed.launch_fwd_batched if batched else ed.launch_fwd
    bwd = ed.launch_bwd_batched if batched else ed.launch_bwd
    plain = ed.edge_decoder_batched_plain if batched else ed.edge_decoder_plain
    plain_bwd = ed.edge_decoder_batched_plain_bwd if batched \
        else ed.edge_decoder_plain_bwd
    args = [x[k] for k in KERNEL_ARGS[:6]] + [x["edges"], x["seed"]]
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.3):
            out = fwd(*args, rate, True, dtype)
            out_g = bwd(*args, rate, True, dtype, x["g"], x["csr"])
            ref = plain(*args, rate, True, dtype)
            ref_g = plain_bwd(*args, rate, True, dtype, x["g"])
            torch.cuda.synchronize()
            _compare([("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                       ref_g)),
                     dtype, rate, label, err)
            del ref, ref_g
    for rate in (0.0, 0.3):
        ref = plain(*args, rate, True, torch.bfloat16)
        ref_g = plain_bwd(*args, rate, True, torch.bfloat16, x["g"])
        out = fwd(*args, rate, True, torch.float32)
        out_g = bwd(*args, rate, True, torch.float32, x["g"], x["csr"])
        for name, a, b in [("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                            ref_g)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            print(f"  control fp32 {label} kernel vs bf16 plain "
                  f"rate={rate:.1f} {name:6s} rel={rel:.3e}")
            if name in ROUNDED and rel <= TOL[torch.bfloat16]:
                raise AssertionError(f"control: {label} {name} without bf16 "
                                     f"rounding passes the bf16 tolerance")
        del ref, ref_g
    first = bwd(*args, 0.3, True, torch.bfloat16, x["g"], x["csr"])
    again = bwd(*args, 0.3, True, torch.bfloat16, x["g"], x["csr"])
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"two {label} backward launches differ")
    print(f"  {label} backward: two launches give identical bits")
    return args


def _edge_times(ed, x, batched):
    """Kernel and plain times, bf16 with dropout 0.3 (the main path)."""
    fwd = ed.launch_fwd_batched if batched else ed.launch_fwd
    bwd = ed.launch_bwd_batched if batched else ed.launch_bwd
    plain = ed.edge_decoder_batched_plain if batched else ed.edge_decoder_plain
    plain_bwd = ed.edge_decoder_batched_plain_bwd if batched \
        else ed.edge_decoder_plain_bwd
    args = [x[k] for k in KERNEL_ARGS[:6]] + [x["edges"], x["seed"]]
    dtype, rate = torch.bfloat16, 0.3
    launches = dict(ed.LAUNCHES)
    t = {"fwd": _time_ms(lambda: fwd(*args, rate, True, dtype)),
         "bwd": _time_ms(lambda: bwd(*args, rate, True, dtype, x["g"],
                                     x["csr"]))}
    ed.LAUNCHES.update(launches)
    with torch.no_grad():
        tp = {"fwd": _time_ms(lambda: plain(*args, rate, True, dtype), reps=3),
              "bwd": _time_ms(lambda: plain_bwd(*args, rate, True, dtype,
                                                x["g"]), reps=3)}
    return t, tp


def phase_edge_kernels(ds):
    """Rows 5-6 on fold 0's real train list; returns their table rows
    without launches."""
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    x = _edge_inputs(ds)
    ne = x["edges"].shape[-1]
    print(f"== edge kernels vs plain on fold 0's train list: E={ne} over "
          f"{ND} x {NV} nodes")
    err = {"fwd": 0.0, "bwd": 0.0}
    args = _edge_checks(ed, x, False, "edges", err)
    # An edge draws the masks of grid cell [src, dst]: in fp32 its logit is
    # the grid kernel's cell.
    out = ed.launch_fwd(*args, 0.3, True, torch.float32)
    grid = gd.launch_fwd(*args[:6], x["seed"], 0.3, True, torch.float32)
    cells = grid[x["edges"][0].long(), x["edges"][1].long()]
    rel = float((out - cells).abs().max()) / float(cells.abs().max())
    print(f"  fp32 rate=0.3 edge logits vs grid kernel cells [src, dst]: "
          f"rel={rel:.3e} tol=1e-04 {'ok' if rel <= 1e-4 else 'FAIL'}")
    if rel > 1e-4:
        raise AssertionError("edge kernel disagrees with the grid kernel")
    t, tp = _edge_times(ed, x, False)
    # The CSR build, once per edge list (not in the step): its time and its
    # kernels.
    _profile("edge_csr (torch ops)",
             lambda: ed.edge_csr(x["edges"][0], x["edges"][1], ND, NV), 5)
    da1_bytes = ne * 128 * 4
    print(f"  da1 buffer {da1_bytes / 1e6:.1f} MB, written once and read "
          f"twice: {3 * da1_bytes / PEAK_BYTES_S * 1e3:.4f} ms at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s")
    return [_edge_row(kind, False, err, t, tp, torch.bfloat16, ne)
            for kind in ("fwd", "bwd")]


def phase_edge_kernels_batched(ds):
    """Rows 7-8: checks at F = 3 folds' real lists, fold f against the
    single-fold kernel with seed[f], timing at F = 10; returns their table
    rows without launches."""
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed

    x = _edge_inputs(ds, NF_CHECK)
    ne = x["edges"].shape[-1]
    print(f"== batched edge kernels vs plain at F={NF_CHECK}, E={ne}")
    err = {"fwd": 0.0, "bwd": 0.0}
    args = _edge_checks(ed, x, True, "batched edges", err)
    for dtype in (torch.float32, torch.bfloat16):
        out = ed.launch_fwd_batched(*args, 0.3, True, dtype)
        grads = ed.launch_bwd_batched(*args, 0.3, True, dtype, x["g"],
                                      x["csr"])
        # The forward of fold f is the single-fold kernel's bit for bit.  The
        # backward splits each fold into another number of blocks (the split
        # depends on F), so its partial sums add in another order.
        for f in range(NF_CHECK):
            one = [a[f].contiguous() for a in args[:7]] \
                + [args[7][f:f + 1].contiguous()]
            if not torch.equal(ed.launch_fwd(*one, 0.3, True, dtype), out[f]):
                raise AssertionError(f"batched edges fold {f} ({dtype}) != "
                                     f"single-fold kernel")
            single = ed.launch_bwd(*one, 0.3, True, dtype,
                                   x["g"][f].contiguous())
            for name, a, b in zip(GRAD_NAMES, grads, single):
                rel = float((a[f] - b).abs().max()) / max(
                    float(b.abs().max()), 1e-30)
                if rel > TOL[dtype]:
                    raise AssertionError(f"batched edges fold {f} {name} "
                                         f"({dtype}): rel {rel:.3e} from the "
                                         f"single-fold kernel")
        print(f"  batched edges {str(dtype)[6:]:8s} rate=0.3 every fold's "
              f"forward equals the single-fold kernel bit for bit, its "
              f"backward within {TOL[dtype]:.0e}")
    del x, args
    x = _edge_inputs(ds, NF)
    ne = x["edges"].shape[-1]
    t, tp = _edge_times(ed, x, True)
    return [_edge_row(kind, True, err, t, tp, torch.bfloat16, ne, NF)
            for kind in ("fwd", "bwd")]


def phase_model():
    """Eval forward at full default width, grid and edges mode: card
    (kernels) vs CPU (plain versions)."""
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
        train_inputs, *_ = fold_inputs(ds, 0)
        for path in (MAIN_PATH, EDGES_PATH):
            mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **path)
            if params_cpu is None:
                params_cpu = init_params(torch.Generator().manual_seed(0),
                                         mcfg)
            params = map_params(lambda t: t.to(dev), params_cpu)
            with torch.no_grad():
                pred, *_ = forward(params, train_inputs, mcfg, train=False)
            outs[dev, path["decode_mode"]] = pred.cpu()
    for mode, shape in (("grid", (ND, NV)),
                        ("edges", tuple(train_inputs.dec_src.shape))):
        a, b = outs["cuda:0", mode], outs["cpu", mode]
        if a.shape != shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{mode} model logits: shape "
                                 f"{tuple(a.shape)} or non-finite values")
        rel = float((a - b).abs().max()) / float(b.abs().max())
        print(f"  {mode} logits {tuple(a.shape)} rel_err={rel:.3e} tol=1e-02")
        if rel > 1e-2:
            raise AssertionError(f"{mode} model logits on the card disagree "
                                 f"with the CPU")


def _launches():
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    return {"grid": dict(gd.LAUNCHES), "edge": dict(ed.LAUNCHES)}


def _zero_launches():
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    for counts in (gd.LAUNCHES, ed.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _run_trainer(label: str, flags, n_folds: int, n_intervals: int = 2):
    """The CLI at Gdataset defaults plus ``flags``, with every launch count
    set to 0 just before and read just after; checks the artifacts of
    ``n_folds`` folds with ``n_intervals`` evals each and finite metrics.
    Returns (summary, launches)."""
    from dream_gnn_tpu_torch.train.cli import main

    print(f"== {label}: python -m dream_gnn_tpu_torch.train.cli "
          f"{' '.join(flags)}")
    with tempfile.TemporaryDirectory() as save_dir:
        _zero_launches()
        summary = main(["--data_name", "Gdataset", "--seeds", "77",
                        *flags, "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches = _launches()
        seed_dir = Path(save_dir, "seed_77")
        for cv in range(n_folds):
            rows = (seed_dir / f"test_metric{cv + 1}.csv").read_text().split()
            if len(rows) != n_intervals + 1:
                raise AssertionError(f"fold {cv}: expected {n_intervals} eval "
                                     f"intervals, got {rows}")
            last = dict(zip(rows[0].split(","),
                            map(float, rows[-1].split(","))))
            for name in ("loss", "train_auroc", "test_auroc"):
                if not np.isfinite(last[name]):
                    raise AssertionError(f"fold {cv} {name} is not finite: "
                                         f"{last}")
            if not (seed_dir / f"best_metric{cv + 1}.csv").exists():
                raise AssertionError(f"missing best_metric{cv + 1}.csv")
        for f in (seed_dir / "experiment_results.csv",
                  Path(save_dir, "summary_results.csv")):
            if not f.exists():
                raise AssertionError(f"missing artifact {f.name}")
        if not np.isfinite(summary["mean_auroc"]):
            raise AssertionError(f"summary AUROC is not finite: {summary}")
    print(f"  launches on this path: {launches}")
    return summary, launches


def _expect_launches(launches, module: str, kinds, label: str):
    """Every ``kinds`` count of ``module`` launched; every other count of
    either module is 0."""
    for mod, counts in launches.items():
        for k, n in counts.items():
            if mod == module and k in kinds:
                if n <= 0:
                    raise AssertionError(f"{mod} decoder {k} never launched "
                                         f"on the {label} path")
            elif n:
                raise AssertionError(f"the {label} path launched the {mod} "
                                     f"decoder's {k} kernel")


def _print_stacked_ms(summary):
    ms = summary["results"][0]["ms_per_step"]
    print(f"  {ms:.3f} ms per stacked step of {NF} folds (mean of all 40 "
          f"steps, CUDA events), {ms / NF:.3f} ms per fold-step")


TRAIN_41 = ["--train_max_iter", "41", "--train_valid_interval", "20"]


def phase_trainer():
    """Trainer steps through the CLI; returns the kernels' launch counts."""
    _, launches = _run_trainer("trainer (Gdataset defaults)",
                               ["--folds", "0", *TRAIN_41], 1)
    _expect_launches(launches, "grid", ("fwd", "bwd"), "trainer")
    return launches


def phase_trainer_stacked():
    """The fold-parallel trainer through the CLI: all folds of one seed as
    one stack; returns the batched kernels' launch counts."""
    summary, launches = _run_trainer(
        f"fold-parallel trainer (Gdataset defaults, {NF} folds)",
        ["--fold_parallel", *TRAIN_41], NF)
    _print_stacked_ms(summary)
    _expect_launches(launches, "grid", ("fwd_b", "bwd_b"), "fold-parallel")
    return launches


def phase_trainer_edges():
    """The edges decode mode through the CLI, one fold."""
    _, launches = _run_trainer("edges trainer",
                               ["--decode_mode", "edges", "--folds", "0",
                                *TRAIN_41], 1)
    _expect_launches(launches, "edge", ("fwd", "bwd"), "edges")
    return launches


def phase_trainer_edges_stacked():
    """The edges decode mode with ``--fold_parallel``: the 10 folds of one
    seed as one stack."""
    summary, launches = _run_trainer(
        f"edges fold-parallel trainer ({NF} folds)",
        ["--decode_mode", "edges", "--fold_parallel", *TRAIN_41], NF)
    _print_stacked_ms(summary)
    _expect_launches(launches, "edge", ("fwd_b", "bwd_b"),
                     "edges fold-parallel")
    return launches


def phase_plain_backend():
    """``--decoder_backend xla``: the plain edge decoder, no kernel."""
    _, launches = _run_trainer(
        "plain decoder backend",
        ["--decoder_backend", "xla", "--decode_mode", "edges", "--folds", "0",
         "--train_max_iter", "21", "--train_valid_interval", "10"], 1)
    _expect_launches(launches, "none", (), "plain backend")


def _profile(label: str, step, n_steps: int) -> float:
    """``n_steps`` steady calls of ``step`` under torch.profiler: step time,
    device busy share and the top kernels; returns kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_ms = _time_ms(step, reps=n_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
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
    kernels = sum(r[1] for r in rows)
    print(f"  {label}: step {step_ms:.3f} ms (CUDA events, no profiler); "
          f"device kernels {busy_ms:.3f} ms/step = "
          f"{100 * busy_ms / step_ms:.1f}% busy"
          + ("" if rows else " (profiler saw no device time: not measured)"))
    print(f"  {kernels:.0f} kernels per step; top by device time (ms/step, "
          f"calls/step, name):")
    for ms, count, key in rows[:12]:
        print(f"    {ms:8.4f} {count:6.1f}  {key[:90]}")
    return kernels


def phase_profile(path, n_steps: int = 10) -> float:
    """Where a default training step's time goes; returns kernels/step."""
    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    mode = path["decode_mode"]
    print(f"== profile: {n_steps} training steps, Gdataset defaults, "
          f"{mode} mode")
    cfg = TrainConfig()
    ds = DreamDataset.load("Gdataset", k=cfg.num_neighbor, device="cuda:0")
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **path)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    state = init_state(init_params(gen, mcfg), gen, cfg)
    step = make_one_step(mcfg, cfg)
    inputs, _, labels, _ = fold_inputs(ds, 0)
    w = ds.fold(0).train_w
    return _profile(f"sequential {mode}",
                    lambda: step(state, inputs, labels, w), n_steps)


def phase_profile_stacked(path, seq_kernels: float, n_steps: int = 10):
    """The same profile for a stacked step of the 10 folds of one seed; its
    kernels per step must stay within twice the sequential step's."""
    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg
    from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                                   init_state_stacked,
                                                   make_one_step_stacked,
                                                   stack_seed)

    mode = path["decode_mode"]
    print(f"== profile: {n_steps} stacked training steps of {NF} folds, "
          f"Gdataset defaults, {mode} mode")
    cfg = TrainConfig()
    ds = DreamDataset.load("Gdataset", k=cfg.num_neighbor, device="cuda:0")
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **path)
    folds = list(range(NF))
    gen = torch.Generator(device="cuda:0").manual_seed(stack_seed([0], folds))
    state = init_state_stacked(init_params_stacked(mcfg, [0], folds,
                                                   "cuda:0"), gen, cfg)
    step = make_one_step_stacked(mcfg, cfg)
    stacked = stack_folds(ds, folds)
    kernels = _profile(f"stacked {mode} F={NF}",
                       lambda: step(state, stacked.inputs, stacked.labels,
                                    stacked.edge_weight), n_steps)
    if kernels > 2 * seq_kernels:
        raise AssertionError(f"stacked step launches {kernels:.0f} kernels, "
                             f"more than twice the sequential "
                             f"{seq_kernels:.0f}")
    print(f"  kernels per step: stacked {kernels:.0f} vs sequential "
          f"{seq_kernels:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    gpu = _gpu_line()
    print(f"== device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    phase_build()
    rows = phase_kernels()
    rows += phase_kernels_batched()
    ds = DreamDataset.load("Gdataset", device="cuda:0")
    rows += phase_edge_kernels(ds)
    rows += phase_edge_kernels_batched(ds)
    del ds
    torch.cuda.empty_cache()
    phase_model()
    launches = phase_trainer()
    launches_b = phase_trainer_stacked()
    launches_e = phase_trainer_edges()
    launches_eb = phase_trainer_edges_stacked()
    phase_plain_backend()
    for path in (MAIN_PATH, EDGES_PATH):
        phase_profile_stacked(path, phase_profile(path))
    # Each kernel's launches on the path that runs it.
    for row, n in zip(rows, (launches["grid"]["fwd"], launches["grid"]["bwd"],
                             launches_b["grid"]["fwd_b"],
                             launches_b["grid"]["bwd_b"],
                             launches_e["edge"]["fwd"],
                             launches_e["edge"]["bwd"],
                             launches_eb["edge"]["fwd_b"],
                             launches_eb["edge"]["bwd_b"])):
        row["launches"] = n
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
