"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. device and build: the card's name and power limit, then the CUDA
   kernels built from the sources in the checkout, one nvcc per source in
   parallel (nvcc's register and shared-memory report is printed, and the
   lines of the bf16 kernels on the tensor cores once more: the forwards
   ``grid_fwd_mma_kernel``, ``edge_fwd_mma_kernel`` and both
   instantiations of ``scale_fwd_mma_kernel`` (K2 with and without its a1
   spill), the backwards ``grid_bwd_mma_kernel``, ``edge_bwd_mma_kernel``
   and both instantiations of ``scale_bwd_mma_kernel``, B1 and the
   mirror);
2. kernels against their plain PyTorch versions at Gdataset width
   (593 drugs x 313 diseases), fp32 and bf16, dropout 0 and 0.3: forward
   logits and all six gradients, each within a stated tolerance; a
   control showing that the bf16 tolerance sees a kernel that does not
   round; then each kernel's time beside its bound and the plain
   version's time, and the forward's and the backward's TFLOP/s and
   residency (blocks and warps an SM) in bf16 (tensor cores) and fp32
   (CUDA cores);
3. the fold-batched kernels the same way at F = 3 folds of the full grid,
   plus: fold f of a batched forward equals the single-fold kernel with
   seed[f] bit for bit, and two batched backward launches give the same
   bits; then their times at F = 10, bf16, dropout 0.3;
4. the per-edge kernels on fold 0's real train list (167,168 edges over
   the Gdataset tables) the same way, plus: an fp32 edge logit with
   dropout equals the grid kernel's cell [src, dst], and two backward
   launches give the same bits; then their times, the forward's and the
   backward's TFLOP/s and residency in bf16 (tensor cores) and fp32 (CUDA
   cores), the CSR build's time and the da1 buffer's size;
5. the fold-batched per-edge kernels at F = 3 folds' real lists, fold f
   equal to the single-fold kernel with seed[f] bit for bit, determinism;
   their times, rates and residency at F = 10, and the backward's device
   time split by a profile into its pass 1, its pass 2 and the slab sums;
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
    and the kernels that take the device's time; the step must run the
    tensor-core forward and backward, ``grid_fwd_mma_kernel`` and
    ``grid_bwd_mma_kernel``, and neither ``grid_fwd_kernel`` nor
    ``grid_bwd_kernel``;
13. the same profile of ten stacked steps of the 10 folds, whose kernels
    per step must stay within twice the sequential step's;
14-15. the profiles of 12 and 13 in edges mode, which must run
    ``edge_fwd_mma_kernel`` and ``edge_bwd_mma_kernel`` and neither
    ``edge_fwd_kernel`` nor ``edge_bwd_kernel``;
16. the scale path's kernels against their plain versions at its shapes
    (the planted 100k x 100k problem of ``train.scale``: the ~9M-edge
    rating-0 and ~1M-edge rating-1 relations, forward and transposed,
    d = 128; 1M candidates over the 100k-row tables), fp32 and bf16,
    dropout 0 and 0.3, every output within a stated tolerance (the bf16 K2
    against the plain version with its a2 product in unit order), two
    launches the same bits, the bf16 control; then each kernel's time
    beside its bound, its plain version's and one PyTorch call's where
    there is one (and for the segment sums of 16 and 20, the rate at which
    they gather rows of x, entries x row bytes / time), and K2's, B1's and
    the mirror's TFLOP/s and residency in bf16 (tensor cores) and fp32
    (CUDA cores);
17. the scale model's eval forward on the card (kernels) against the CPU
    (plain versions) at 10k x 10k nodes, 1M edges, 100k candidates;
18. the scale trainer through ``train.scale`` at full size, 20 steps with an
    eval every 10: ms/step, peak memory, the layout build time and the
    launch counts the path implies;
19. a profile of ten scale training steps, which must run the tensor-core
    ``scale_fwd_mma_kernel`` (K2) and ``scale_bwd_mma_kernel`` (B1 and the
    mirror) and neither ``scale_fwd_kernel`` nor ``scale_bwd_kernel``;
20. the scale benchmark's SpMMs, grouped (``spmm_gather``) and blocked
    (``spmm_blocked``), against their plain versions at their paths'
    shapes: the ~7M-edge rating-0 and ~3M-edge rating-1 relations of
    ``scripts.bench_scale --grouped``, forward and transposed; both kernels
    on ``scripts.bench_spmm``'s 10M-edge graph; the grouped SpMM as the
    scale decoder's scatter of 1M slots into 100k rows.  fp32 and bf16,
    with and without a PRF edge mask, two launches the same bits, the bf16
    controls (among them that the blocked SpMM rounds val), and the
    decoder's gradients with ``build_seq=False`` bit for bit those with
    ``build_seq=True``; then each kernel's time beside its bound, its plain
    version's and ``torch.sparse.mm``'s (``index_add_``'s for the scatter);
21. the bench model's eval forward on the card against the CPU over
    the padded-COO and over the grouped layout, 10k x 10k nodes, 1M edges;
22. ``scripts.bench_scale`` at full size in both layouts: ms/step, edges/s,
    peak memory and the layout build time; the grouped layout launches
    exactly 12 forward and 12 backward ``spmm_gather`` per step, the COO
    layout no kernel;
23. ``scripts.bench_spmm`` at full size with its launch counts, then a
    profile of ten ``bench_scale --grouped`` steps.

Each trainer phase sets every launch count to 0 just before it drives its
entry point and reads the counts just after.

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


def _decoder_flops(fwd: bool, nf: int = 1, cells: int = ND * NV) -> int:
    """Operations of the decoder MLP over ``cells`` grid cells or edges per
    fold, forward or backward."""
    h1, h2 = 128, 64
    per_cell = 2 * h1 * h2 + 2 * h1 + 2 * h2             # a2 product, a1, w3 dot
    if not fwd:
        # The recomputed forward, the dh1 and dW2 products, then g * w3,
        # the db2 and dw3 sums and the dPd, dPv and db1 sums.
        per_cell += 2 * (2 * h1 * h2) + 4 * h2 + 3 * h1
    return nf * cells * per_cell


def _bound_ms(fwd: bool, dtype, nf: int = 1, cells: int = ND * NV,
              index_bytes: int = 0) -> tuple:
    """(least ms, "operations" or "bytes") of the decoder MLP over ``cells``
    grid cells or edges per fold; ``index_bytes`` are the edge ids read."""
    h1, h2 = 128, 64
    flops = _decoder_flops(fwd, nf, cells)
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
    # The tensor-core kernels' registers, spills and shared memory, each
    # instantiation by its mangled template argument: K2's <true> spills a1,
    # the scale backward's <false> is B1, <true> the mirror.
    lines = report.splitlines()
    for kernel, label in (
            ("grid_fwd_mma_kernel", "bf16 grid forward"),
            ("edge_fwd_mma_kernel", "bf16 edge forward"),
            ("scale_fwd_mma_kernelILb1E", "bf16 scale K2, a1 spilled"),
            ("scale_fwd_mma_kernelILb0E", "bf16 scale K2, eval"),
            ("grid_bwd_mma_kernel", "bf16 grid backward"),
            ("edge_bwd_mma_kernel", "bf16 edge backward"),
            ("scale_bwd_mma_kernelILb0E", "bf16 scale B1"),
            ("scale_bwd_mma_kernelILb1E", "bf16 scale mirror")):
        at = [n for n, line in enumerate(lines)
              if "Compiling entry function" in line and kernel in line]
        if len(at) != 1:
            raise AssertionError(f"nvcc's report names {kernel} {len(at)} "
                                 f"times, not once")
        print(f"  {kernel} ({label}), nvcc -Xptxas -v:")
        for line in lines[at[0] + 1:at[0] + 4]:
            print(f"    {line.strip()}")


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


def _print_rate(label: str, ms_bf16: float, ms_fp32: float, nf: int,
                occupancy, cells: int = ND * NV, flops=None, fwd=False):
    """A decoder kernel's rate and residency in each dtype (bf16: the
    tensor-core kernel, fp32: the CUDA-core one), at dropout 0.3;
    ``occupancy`` is its module's ``fwd_occupancy`` or ``bwd_occupancy``.
    ``flops`` defaults to the grid and per-edge forward's (``fwd``) or
    backward's over ``cells``."""
    if flops is None:
        flops = _decoder_flops(fwd, nf, cells)
    for name, ms, dtype in (("bf16", ms_bf16, torch.bfloat16),
                            ("fp32", ms_fp32, torch.float32)):
        blocks, warps = occupancy(dtype)
        print(f"  {label} {name}: {ms:.4f} ms, {flops / ms / 1e9:.2f} "
              f"TFLOP/s ({100 * flops / ms * 1e3 / PEAK_FLOPS_S[dtype]:.1f}% "
              f"of the {name} peak); {blocks} block(s), {warps} warps "
              f"resident an SM")


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
    t32 = {
        "fwd": _time_ms(lambda: gd.launch_fwd(*args, rate, True,
                                              torch.float32)),
        "bwd": _time_ms(lambda: gd.launch_bwd(*args, rate, True,
                                              torch.float32, x["g"])),
    }
    with torch.no_grad():
        tp = {
            "fwd": _time_ms(lambda: gd.grid_decoder_plain(*args, rate, True,
                                                          dtype), reps=5),
            "bwd": _time_ms(lambda: gd.grid_decoder_plain_bwd(
                *args, rate, True, dtype, x["g"]), reps=5),
        }
    gd.LAUNCHES.update(launches)
    _print_rate("grid_decoder_fwd", t["fwd"], t32["fwd"], 1, gd.fwd_occupancy,
                fwd=True)
    _print_rate("grid_decoder_bwd", t["bwd"], t32["bwd"], 1, gd.bwd_occupancy)
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
    t32 = {
        "fwd": _time_ms(lambda: gd.launch_fwd_batched(*args, rate, True,
                                                      torch.float32)),
        "bwd": _time_ms(lambda: gd.launch_bwd_batched(
            *args, rate, True, torch.float32, x["g"])),
    }
    with torch.no_grad():
        tp = {
            "fwd": _time_ms(lambda: gd.grid_decoder_batched_plain(
                *args, rate, True, dtype), reps=3),
            "bwd": _time_ms(lambda: gd.grid_decoder_batched_plain_bwd(
                *args, rate, True, dtype, x["g"]), reps=3),
        }
    gd.LAUNCHES.update(launches)
    _print_rate(f"grid_decoder_fwd_batched F={NF}", t["fwd"], t32["fwd"], NF,
                gd.fwd_occupancy, fwd=True)
    _print_rate(f"grid_decoder_bwd_batched F={NF}", t["bwd"], t32["bwd"], NF,
                gd.bwd_occupancy)
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
    """Kernel and plain times, bf16 with dropout 0.3 (the main path); prints
    the forward's and the backward's rate and residency, timing the fp32
    kernels too."""
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
    t32 = {"fwd": _time_ms(lambda: fwd(*args, rate, True, torch.float32)),
           "bwd": _time_ms(lambda: bwd(*args, rate, True, torch.float32,
                                       x["g"], x["csr"]))}
    ed.LAUNCHES.update(launches)
    with torch.no_grad():
        tp = {"fwd": _time_ms(lambda: plain(*args, rate, True, dtype), reps=3),
              "bwd": _time_ms(lambda: plain_bwd(*args, rate, True, dtype,
                                                x["g"]), reps=3)}
    nf = x["edges"].shape[0] if batched else 1
    for kind in ("fwd", "bwd"):
        _print_rate(f"edge_decoder_{kind}{'_batched' if batched else ''} "
                    f"F={nf}", t[kind], t32[kind], nf,
                    getattr(ed, f"{kind}_occupancy"),
                    cells=x["edges"].shape[-1], fwd=kind == "fwd")
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
    _edge_bwd_split(ed, x)
    return [_edge_row(kind, True, err, t, tp, torch.bfloat16, ne, NF)
            for kind in ("fwd", "bwd")]


def _edge_bwd_split(ed, x, n_calls: int = 10):
    """Row 8's device time per launch (bf16, dropout 0.3), split by a
    profile into pass 1 (edge_bwd_mma_kernel), pass 2
    (edge_scatter_kernel) and the wrapper's slab sums (every other
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    args = [x[k] for k in KERNEL_ARGS[:6]] + [x["edges"], x["seed"]]
    launches = dict(ed.LAUNCHES)

    def call():
        ed.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, x["g"],
                              x["csr"])

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
    ed.LAUNCHES.update(launches)
    rows = _kernel_rows(prof, n_calls)
    if not rows:
        print("  edge_decoder_bwd_batched split: the profiler saw no device "
              "time (not measured)")
        return
    parts = {"pass 1": 0.0, "pass 2": 0.0, "slab sums": 0.0}
    for ms, _, key in rows:
        part = "pass 1" if "edge_bwd_mma_kernel" in key else \
            "pass 2" if "edge_scatter_kernel" in key else "slab sums"
        parts[part] += ms
    if not parts["pass 1"] or not parts["pass 2"]:
        raise AssertionError(f"edge backward profile lacks a pass: {rows}")
    total = sum(parts.values())
    print(f"  edge_decoder_bwd_batched F={NF} device time per launch "
          f"(torch.profiler, {n_calls} launches): {total:.4f} ms = "
          + ", ".join(f"{k} {v:.4f} ms ({100 * v / total:.1f}%)"
                      for k, v in parts.items()))


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


def _counters():
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    return {"grid": gd.LAUNCHES, "edge": ed.LAUNCHES, "spmm": sp.LAUNCHES,
            "seq": sq.LAUNCHES, "scale": sd.LAUNCHES, "gather": sg.LAUNCHES,
            "blocked": sb.LAUNCHES}


def _launches():
    return {mod: dict(counts) for mod, counts in _counters().items()}


def _zero_launches():
    for counts in _counters().values():
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
    every module is 0."""
    for mod, counts in launches.items():
        for k, n in counts.items():
            if mod == module and k in kinds:
                if n <= 0:
                    raise AssertionError(f"{mod} kernel {k} never launched "
                                         f"on the {label} path")
            elif n:
                raise AssertionError(f"the {label} path launched the {mod} "
                                     f"kernel {k}")


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


def _profile(label: str, step, n_steps: int, top: int = 12, expect=(),
             forbid=()) -> float:
    """``n_steps`` steady calls of ``step`` under torch.profiler: step time,
    device busy share and the ``top`` kernels (all with ``top=None``);
    returns kernels per step.  Fails unless some kernel's name holds each
    of ``expect`` and none holds any of ``forbid``."""
    from torch.profiler import ProfilerActivity, profile

    step_ms = _time_ms(step, reps=n_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    rows = _kernel_rows(prof, n_steps)
    busy_ms = sum(r[0] for r in rows)
    kernels = sum(r[1] for r in rows)
    print(f"  {label}: step {step_ms:.3f} ms (CUDA events, no profiler); "
          f"device kernels {busy_ms:.3f} ms/step = "
          f"{100 * busy_ms / step_ms:.1f}% busy"
          + ("" if rows else " (profiler saw no device time: not measured)"))
    print(f"  {kernels:.0f} kernels per step; "
          + ("all" if top is None else "top") + " by device time (ms/step, "
          "calls/step, name):")
    for ms, count, key in rows[:top]:
        print(f"    {ms:8.4f} {count:6.1f}  {key[:90]}")
    for name in expect:
        hits = [r for r in rows if name in r[2]]
        if not hits:
            raise AssertionError(f"{label}: no {name} among the step's kernels")
        for ms, count, key in hits:
            print(f"  {name}: {ms:.4f} ms/step, {count:.1f} calls/step "
                  f"({key[:60]})")
    for name in forbid:
        if any(name in r[2] for r in rows):
            raise AssertionError(f"{label}: {name} ran in the step")
    return kernels


def _kernel_rows(prof, n_calls: int) -> list:
    """(device ms per call, launches per call, name) of every device kernel
    in a torch.profiler run of ``n_calls`` calls, longest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # Device kernels only: host ops' kernels are listed themselves, and
        # record_function ranges (e.g. "Optimizer.step#Adam.step") would
        # count their kernels twice.  A kernel's own name may hold a "#"
        # (a lambda's, as in every dtype cast), so the ranges are told by
        # their flag, or by a "#" in a name that is not a kernel's.
        if ev.device_type != DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False) \
                or ("#" in ev.key and not ev.key.startswith("void ")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_calls, ev.count / n_calls, ev.key))
    rows.sort(reverse=True)
    return rows


def _step_names(mode: str) -> dict:
    """A bf16 step runs its decoder's tensor-core forward and backward and
    not the fp32 CUDA-core ones (``grid_fwd_kernel``, ``grid_bwd_kernel``,
    ``edge_fwd_kernel``, ``edge_bwd_kernel``)."""
    kind = {"grid": "grid", "edges": "edge"}[mode]
    return dict(expect=(f"{kind}_fwd_mma_kernel", f"{kind}_bwd_mma_kernel"),
                forbid=(f"{kind}_fwd_kernel", f"{kind}_bwd_kernel"))


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
                    lambda: step(state, inputs, labels, w), n_steps,
                    **_step_names(mode))


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
                                    stacked.edge_weight), n_steps,
                       **_step_names(mode))
    if kernels > 2 * seq_kernels:
        raise AssertionError(f"stacked step launches {kernels:.0f} kernels, "
                             f"more than twice the sequential "
                             f"{seq_kernels:.0f}")
    print(f"  kernels per step: stacked {kernels:.0f} vs sequential "
          f"{seq_kernels:.0f}")


# ---------------------------------------------------------------------------
# The single-device scale path (dream_gnn_tpu_torch/train/scale.py).

SCALE_N = 100_000            # train.scale's drugs and diseases at full size
# Tolerance on max|kernel - plain| / max|plain| for the scale kernels.  Each
# kernel and its plain version compute the same messages and the same MLP
# with the same roundings, and differ in the order of their f32 sums (the
# plain SpMM's index_add runs in no fixed order on the card).  The largest
# error measured on the H100 was below 6e-6 (PERF.md).
SCALE_TOL = 1e-4
# Operations per candidate slot of the decoder MLP (H1 = 128, H2 = 64):
# forward: the a2 product, a1 and the logit dot; B1: the recomputed forward,
# the dh1 and dW2 products, g * w3 and the db2, dw3, db1 sums; the mirror:
# the recomputed forward, the dh1 product, g * w3 and the da1 mask.
OPS_K2 = 2 * 128 * 64 + 2 * 128 + 2 * 64
OPS_B1 = OPS_K2 + 2 * (2 * 128 * 64) + 4 * 64 + 3 * 128
OPS_MIRROR = OPS_K2 + 2 * 128 * 64 + 2 * 64 + 128


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _gather_rate(entries: int, row_bytes: int, ms: float) -> str:
    """The segment sum's achieved gather rate: entries x row bytes / time,
    to hold against the L2's bandwidth (x is read once per entry)."""
    return f"gathers {entries * row_bytes / (ms * 1e-3) / 1e12:.3f} TB/s"


def _scale_row(name, replaces, err, ms, plain_ms, nbytes, flops, dtype,
               library_ms=None, library="no single PyTorch call computes "
                                         "this function", gathered=None):
    """A kernel-table row for a scale kernel: the bound is the larger of
    ``nbytes`` over the memory rate and ``flops`` over the peak for
    ``dtype``.  ``gathered``: (entries, row bytes) of a segment sum."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    src = "scale_decoder" if name.startswith("scale_decoder") else "spmm"
    print(f"  {name}: {ms:.4f} ms, bound {bound:.5f} ms ({by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
          + ("" if gathered is None else _gather_rate(*gathered, ms) + ", ")
          + f"plain {plain_ms:.4f} ms, "
          + (library if library_ms is None
             else f"{library}: {library_ms:.4f} ms"))
    return dict(name=name, route="cuda",
                source=f"dream_gnn_tpu_torch/kernels/csrc/{src}.cu",
                replaces=f"dream_gnn_tpu/kernels/{replaces}", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


def _hold(label, pairs, tol=SCALE_TOL) -> float:
    """Hold (name, kernel, plain) outputs to ``tol``; returns the largest
    absolute error."""
    worst = 0.0
    for name, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label} {name}: {a.dtype} {tuple(a.shape)}"
                                 f" != {b.dtype} {tuple(b.shape)}")
        a, b = a.float(), b.float()
        abs_err = float((a - b).abs().max())
        rel = abs_err / max(float(b.abs().max()), 1e-30)
        ok = rel <= tol and bool(torch.isfinite(a).all())
        print(f"  {label} {name:6s} max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"tol={tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {name} disagrees with the plain "
                                 f"version")
        worst = max(worst, abs_err)
    return worst


def _scale_problem():
    """train.scale's planted problem at full size (numpy, on the host) and
    its training inputs on the card."""
    from dream_gnn_tpu_torch.train import scale

    t0 = time.perf_counter()
    prob = scale.build_problem(np.random.default_rng(scale.SEED))
    t1 = time.perf_counter()
    tin, _, lab, _, w, _, layout_s = scale.build_inputs(
        prob, SCALE_N, SCALE_N, torch.device("cuda", 0))
    print(f"== scale problem: {t1 - t0:.1f} s on the host (numpy); encoder "
          f"graph and both decoder layouts on the card in {layout_s:.3f} s")
    return tin, lab, w


def _spmm_rows(graph, dev):
    """Row 9: the SpMM over both relations of each rating, forward and
    transposed, fp32 and bf16, edge dropout 0 and 0.3."""
    from dream_gnn_tpu_torch.augment.masks import prf_mask_pair
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    gen = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    for r, pair in enumerate(graph.fwd):
        for rate in (0.0, 0.3):
            p = prf_mask_pair(pair, 12345, rate) if rate else pair
            for kind, g in (("fwd", p.fwd), ("bwd", p.bwd)):
                x = torch.randn(g.n_src, 128, device=dev, generator=gen)
                for dtype in (torch.float32, torch.bfloat16):
                    rnd, xr = dtype == torch.bfloat16, x.to(dtype)
                    out = sp.launch_segment_sum(g.row_ptr, g.src, g.val, xr,
                                                rnd)
                    ref = sp.segment_sum_plain(g.row_ptr, g.src, g.val, xr,
                                               rnd)
                    err = max(err, _hold(
                        f"spmm rating {r} {kind} E={g.n_live} "
                        f"{str(dtype)[6:]} rate={rate}", [("out", out, ref)]))
                    again = sp.launch_segment_sum(g.row_ptr, g.src, g.val, xr,
                                                  rnd)
                    if not torch.equal(out, again):
                        raise AssertionError("two SpMM launches differ")
                    del ref
    # Control: without the bf16 rounding the SpMM misses the bf16 tolerance.
    g = graph.fwd[0].fwd
    x = torch.randn(g.n_src, 128, device=dev, generator=gen)
    ref = sp.segment_sum_plain(g.row_ptr, g.src, g.val, x.bfloat16(), True)
    out = sp.launch_segment_sum(g.row_ptr, g.src, g.val, x, False)
    rel = float((out - ref).abs().max()) / float(ref.abs().max())
    print(f"  control: fp32 SpMM vs bf16 plain rel={rel:.3e}")
    if rel <= SCALE_TOL:
        raise AssertionError("control: the SpMM without bf16 rounding passes "
                             "the bf16 tolerance")
    print("  SpMM: two launches give identical bits; times in bf16 (the "
          "path's dtype):")
    t = {}
    for r, pair in enumerate(graph.fwd):
        for kind in ("fwd", "bwd"):
            g = getattr(pair, kind)
            x = torch.randn(g.n_src, 128, device=dev).bfloat16()
            t[r, kind] = _time_ms(lambda g=g, x=x: sp.launch_segment_sum(
                g.row_ptr, g.src, g.val, x, True))
            print(f"    rating {r} {kind}: E={g.n_live}, {g.n_src} -> "
                  f"{g.n_dst} rows: {t[r, kind]:.4f} ms, "
                  f"{_gather_rate(g.n_live, 128 * 2, t[r, kind])}")
    g = graph.fwd[0].fwd
    x = torch.randn(g.n_src, 128, device=dev).bfloat16()
    with torch.no_grad():
        plain_ms = _time_ms(lambda: sp.segment_sum_plain(
            g.row_ptr, g.src, g.val, x, True), reps=3)
    csr = torch.sparse_csr_tensor(g.row_ptr, g.src, g.val,
                                  size=(g.n_dst, g.n_src))
    xf = x.float()
    lib = torch.sparse.mm(csr, xf)
    ours = sp.launch_segment_sum(g.row_ptr, g.src, g.val, x, False)
    print(f"  torch.sparse.mm (CSR, f32) vs the kernel without rounding: "
          f"rel={float((lib - ours).abs().max()) / float(ours.abs().max()):.3e}")
    lib_ms = _time_ms(lambda: torch.sparse.mm(csr, xf))
    nbytes = _nbytes(g.row_ptr, g.src, g.val, x) + g.n_dst * 128 * 4
    return _scale_row("spmm_slab", "pallas_spmm_slab.py:61", err,
                      t[0, "fwd"], plain_ms, nbytes, 2 * g.n_live * 128,
                      torch.bfloat16, lib_ms,
                      "torch.sparse.mm on the CSR in f32",
                      gathered=(g.n_live, 128 * 2))


def _seq_row(layout, dev):
    """Row 12: the scatter of a (1M, 128) da1 stream into the drug table.
    The scale layout's slots carry no weights (``g.val`` is None): the
    kernel reads no ``val``, as on the path."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    g = layout.seq_drug
    if g.val is not None:
        raise AssertionError("the scale layout's scatter should carry no "
                             "slot weights")
    val = None
    err = 0.0
    for x_dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(g.n_slots, 128, device=dev).to(x_dtype)
        for dtype in (torch.float32, torch.bfloat16):
            rnd = dtype == torch.bfloat16
            out = sp.launch_segment_sum(g.offsets, None, val, x, rnd)
            ref = sp.segment_sum_plain(g.offsets, None, val, x, rnd)
            err = max(err, _hold(f"seq_scatter x {str(x_dtype)[6:]} mode "
                                 f"{str(dtype)[6:]}", [("out", out, ref)]))
            if not torch.equal(out, sp.launch_segment_sum(g.offsets, None,
                                                          val, x, rnd)):
                raise AssertionError("two seq_scatter launches differ")
    x = torch.randn(g.n_slots, 128, device=dev).bfloat16()
    ms = _time_ms(lambda: sp.launch_segment_sum(g.offsets, None, val, x, True))
    with torch.no_grad():
        plain_ms = _time_ms(lambda: sp.segment_sum_plain(
            g.offsets, None, val, x, True), reps=3)
    node, xf = layout.drug_of_slot.long(), x.float()
    out = torch.zeros(g.n_dst, 128, device=dev)
    lib_ms = _time_ms(lambda: out.zero_().index_add_(0, node, xf))
    nbytes = _nbytes(g.offsets, val, x) + g.n_dst * 128 * 4
    return _scale_row("seq_scatter", "pallas_seq_scatter.py:144", err, ms,
                      plain_ms, nbytes, g.n_slots * 128, torch.bfloat16,
                      lib_ms, "index_add_ in f32",
                      gathered=(g.n_slots, 128 * 2))


def _unit_order(fn, *args):
    """``fn(*args)`` with each torch.matmul of depth 128 (K2's a2 =
    rnd(h1d) @ rnd(w2)) summed one unit at a time in unit order, in f32:
    the order that the tensor-core K2 takes where h2d sits near a bf16
    midpoint (a product of two bf16 values is exact in f32)."""
    matmul = torch.matmul

    def unit(x, y):
        if x.shape[-1] != 128 or y.dim() != 2 or y.shape[0] != 128:
            return matmul(x, y)
        acc = torch.zeros(*x.shape[:-1], y.shape[1], device=x.device)
        for u in range(128):
            acc += x[..., u:u + 1] * y[u:u + 1, :]
        return acc

    torch.matmul = unit
    try:
        return fn(*args)
    finally:
        torch.matmul = matmul


def _decoder_rows(layout, dev):
    """Rows 13-15: K2, B1 and the mirror over 1M candidates and the
    100k-row tables, fp32 and bf16, dropout 0 and 0.3.  The bf16 K2 is held
    against the plain version with its a2 product in unit order."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    rng = np.random.default_rng(2)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    pd, pv = t(rng.normal(0, 0.5, (SCALE_N, 128))), \
        t(rng.normal(0, 0.5, (SCALE_N, 128)))
    b1, w2 = t(rng.uniform(-.06, .06, 128)), t(rng.uniform(-.09, .09,
                                                             (128, 64)))
    b2, w3 = t(rng.uniform(-.09, .09, 64)), t(rng.uniform(-.12, .12, 64))
    seed = torch.tensor([918273], dtype=torch.int32, device=dev)
    g = t(rng.normal(0, 1e-3, layout.n_pos))
    g_m = g[layout.gout_perm.long()]
    fwd = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
    mir = (layout.drug_of_mslot, layout.dis_of_mslot, layout.mirror_eid)

    def run(kernel, rate, dtype):
        common = (w2, b2, w3, seed, rate, True, dtype)
        if kernel:
            out, a1 = sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, rate,
                                   True, dtype, True)
            return (out, a1, *sd.launch_b1(a1, pd, pv, layout, g, b1,
                                           *common),
                    sd.launch_mirror(pd, pv, layout, g_m, b1, *common))
        out, a1 = _unit_order(sd.scale_fwd_plain, pd, pv, b1, w2, b2, w3,
                              *fwd, seed, rate, True, dtype, True) \
            if dtype == torch.bfloat16 else \
            sd.scale_fwd_plain(pd, pv, b1, w2, b2, w3, *fwd, seed, rate,
                               True, dtype, True)
        return (out, a1, *sd.scale_bwd_plain(a1, pd, pv, *fwd, g, b1, *common,
                                             True),
                sd.scale_bwd_plain(None, pd, pv, *mir, g_m, b1, *common,
                                   False))

    names = ("logits", "a1", "da1", "dW2", "db2", "dw3", "db1", "da1_m")
    err = {"k2": 0.0, "b1": 0.0, "mirror": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.3):
            got, want = run(True, rate, dtype), run(False, rate, dtype)
            torch.cuda.synchronize()
            label = f"scale {str(dtype)[6:]} rate={rate}"
            err["k2"] = max(err["k2"], _hold(label, zip(names[:2], got[:2],
                                                         want[:2])))
            err["b1"] = max(err["b1"], _hold(label, zip(names[2:7], got[2:7],
                                                         want[2:7])))
            err["mirror"] = max(err["mirror"], _hold(label, [
                (names[7], got[7], want[7])]))
            del got, want
    for rate in (0.0, 0.3):
        got = run(True, rate, torch.float32)
        want = run(False, rate, torch.bfloat16)
        for i in (0, 2, 7):
            a, b = got[i].float(), want[i].float()
            rel = float((a - b).abs().max()) / float(b.abs().max())
            print(f"  control fp32 scale kernels vs bf16 plain rate={rate} "
                  f"{names[i]:6s} rel={rel:.3e}")
            if rel <= SCALE_TOL:
                raise AssertionError(f"control: {names[i]} without bf16 "
                                     f"rounding passes the bf16 tolerance")
        del got, want
    a, b = run(True, 0.3, torch.bfloat16), run(True, 0.3, torch.bfloat16)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("two runs of the scale kernels differ")
    print("  scale kernels: two runs give identical bits")
    del a, b

    dtype, rate = torch.bfloat16, 0.3
    out, a1 = sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, rate, True,
                           dtype, True)
    common = (w2, b2, w3, seed, rate, True, dtype)
    da1 = sd.launch_b1(a1, pd, pv, layout, g, b1, *common)[0]
    weights = (b1, w2, b2, w3, seed)
    ms = {"k2": _time_ms(lambda: sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd,
                                                seed, rate, True, dtype,
                                                True)),
          "b1": _time_ms(lambda: sd.launch_b1(a1, pd, pv, layout, g, b1,
                                                *common)),
          "mirror": _time_ms(lambda: sd.launch_mirror(pd, pv, layout, g_m,
                                                        b1, *common))}
    # K2's, B1's and the mirror's rate and residency in each dtype (bf16:
    # the tensor-core kernel, fp32: the CUDA-core one), at dropout 0.3.
    _, a1_32 = sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, rate, True,
                            torch.float32, True)
    common32 = (w2, b2, w3, seed, rate, True, torch.float32)
    ms32 = {"k2": _time_ms(lambda: sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd,
                                                  seed, rate, True,
                                                  torch.float32, True)),
            "b1": _time_ms(lambda: sd.launch_b1(a1_32, pd, pv, layout, g, b1,
                                                  *common32)),
            "mirror": _time_ms(lambda: sd.launch_mirror(pd, pv, layout, g_m,
                                                          b1, *common32))}
    del a1_32
    e = layout.n_pos
    _print_rate("scale_decoder_k2", ms["k2"], ms32["k2"], 1, sd.fwd_occupancy,
                flops=OPS_K2 * e)
    for name, ops in (("b1", OPS_B1), ("mirror", OPS_MIRROR)):
        _print_rate(f"scale_decoder_{name}", ms[name], ms32[name], 1,
                    lambda dt, m=name == "mirror": sd.bwd_occupancy(dt, m),
                    flops=ops * e)
    with torch.no_grad():
        plain = {"k2": _time_ms(lambda: sd.scale_fwd_plain(
                     pd, pv, b1, w2, b2, w3, *fwd, seed, rate, True, dtype,
                     True), reps=3),
                 "b1": _time_ms(lambda: sd.scale_bwd_plain(
                     a1, pd, pv, *fwd, g, b1, *common, True), reps=3),
                 "mirror": _time_ms(lambda: sd.scale_bwd_plain(
                     None, pd, pv, *mir, g_m, b1, *common, False), reps=3)}
    return [
        _scale_row("scale_decoder_k2", "pallas_scale_decoder.py:460",
                   err["k2"], ms["k2"], plain["k2"],
                   _nbytes(pd, pv, *fwd, *weights, out, a1), OPS_K2 * e,
                   dtype),
        _scale_row("scale_decoder_b1", "pallas_scale_decoder.py:579",
                   err["b1"], ms["b1"], plain["b1"],
                   _nbytes(a1, fwd[2], g, *weights, da1)
                   + _nbytes(w2, b1, b2, w3),          # the weight gradients
                   OPS_B1 * e, dtype),
        _scale_row("scale_decoder_mirror", "pallas_scale_decoder.py:679",
                   err["mirror"], ms["mirror"], plain["mirror"],
                   _nbytes(pd, pv, *mir, g_m, *weights, da1), OPS_MIRROR * e,
                   dtype)]


def phase_scale_kernels(tin):
    """Rows 9 and 12-15 at the scale path's shapes; returns their table
    rows without launches."""
    dev = torch.device("cuda", 0)
    graph, layout = tin.enc_graph, tin.dec_layout
    print(f"== scale kernels vs plain: relations of "
          f"{[p.fwd.n_live for p in graph.fwd]} edges over {SCALE_N} x "
          f"{SCALE_N} nodes, d 128; {layout.n_pos} candidates")
    rows = [_spmm_rows(graph, dev), _seq_row(layout, dev)]
    torch.cuda.empty_cache()
    return rows + _decoder_rows(layout, dev)


def phase_scale_profile(tin, lab, w, n_steps: int = 10):
    """Where a scale training step's time goes.  The bf16 step must run
    the tensor-core K2, ``scale_fwd_mma_kernel``, and backward,
    ``scale_bwd_mma_kernel<false>`` (B1) and ``<true>`` (the mirror), and
    neither CUDA-core kernel, ``scale_fwd_kernel`` or
    ``scale_bwd_kernel``."""
    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.train.scale import model_config
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    print(f"== profile: {n_steps} scale training steps at full size")
    mcfg = model_config()
    cfg = TrainConfig(model=mcfg, beta=0.0)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    state = init_state(init_params(gen, mcfg), gen, cfg)
    step = make_one_step(mcfg, cfg)
    # Every kernel, so that the step's kernel count can be accounted for.
    _profile("scale step", lambda: step(state, tin, lab, w), n_steps,
             top=None, expect=("scale_fwd_mma_kernel", "scale_bwd_mma_kernel"),
             forbid=("scale_fwd_kernel", "scale_bwd_kernel"))


def phase_scale_model():
    """The scale model's eval forward, card vs CPU, at 10k x 10k nodes, 1M
    encoder edges and 100k candidates."""
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, init_params,
                                                     map_params)
    from dream_gnn_tpu_torch.train import scale

    n, n_enc, n_cand = 10_000, 1_000_000, 100_000
    print(f"== scale model eval forward, card vs CPU: {n} x {n} nodes, "
          f"{n_enc} edges, {n_cand} candidates")
    prob = scale.build_problem(np.random.default_rng(7), n_drug=n, n_dis=n,
                               n_enc=n_enc, n_cand=n_cand)
    cfg = scale.model_config()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    outs = {}
    for dev in ("cpu", "cuda:0"):
        tin, *_ = scale.build_inputs(prob, n, n, torch.device(dev))
        with torch.no_grad():
            pred, *_ = forward(map_params(lambda x: x.to(dev), params), tin,
                               cfg, train=False)
        outs[dev] = pred.cpu()
    a, b = outs["cuda:0"], outs["cpu"]
    if a.shape != (n_cand,) or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"scale logits: shape {tuple(a.shape)} or "
                             f"non-finite values")
    rel = float((a - b).abs().max()) / float(b.abs().max())
    print(f"  scale logits {tuple(a.shape)} rel_err={rel:.3e} tol=1e-02")
    if rel > 1e-2:
        raise AssertionError("scale model logits on the card disagree with "
                             "the CPU")


def phase_scale_trainer():
    """The scale trainer through its entry point at full size, 20 steps
    with an eval every 10; returns the launch counts."""
    from dream_gnn_tpu_torch.train import scale

    argv = ["--iters", "21", "--valid_interval", "10"]
    print(f"== scale trainer: python -m dream_gnn_tpu_torch.train.scale "
          f"{' '.join(argv)} (full size)")
    with tempfile.TemporaryDirectory() as save_dir:
        _zero_launches()
        rc = scale.main([*argv, "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches = _launches()
        summary = json.loads(Path(save_dir, "summary.json").read_text())
        rows = Path(save_dir, "test_metric0.csv").read_text().split()
        if rc not in (0, 1) or len(rows) != 3 \
                or not Path(save_dir, "best_metric0.csv").exists():
            raise AssertionError(f"scale trainer: rc {rc}, rows {rows}")
    last = dict(zip(rows[0].split(","), map(float, rows[-1].split(","))))
    for name in ("loss", "train_auroc", "test_auroc", "test_aupr"):
        if not np.isfinite(last[name]):
            raise AssertionError(f"scale trainer {name} is not finite: {last}")
    steps, evals = 20, 2 * 2
    want = {mod: {k: 0 for k in counts} for mod, counts in launches.items()}
    want.update(spmm={"fwd": 12 * (steps + evals), "bwd": 12 * steps},
                seq={"seq_scatter": 2 * steps},
                scale={"k2": steps + evals, "b1": steps, "mirror": steps})
    print(f"  launches on this path: {launches}")
    if launches != want:
        raise AssertionError(f"scale trainer launches {launches}, the path "
                             f"implies {want}")
    print(f"  {summary['ms_per_step']:.3f} ms/step (mean of the 20 steps, "
          f"CUDA events); peak device memory "
          f"{summary['peak_memory_bytes'] / 2 ** 30:.2f} GiB; layout build "
          f"{summary['layout_build_s']:.3f} s; best test AUROC "
          f"{summary['best_test_auroc']}, AUPR {summary['best_test_aupr']}")
    return launches


# ---------------------------------------------------------------------------
# The scale benchmark's sparse encoders (dream_gnn_tpu_torch/scripts/).

BENCH_N, BENCH_E = 100_000, 10_000_000   # bench_scale / bench_spmm full size
BENCH_CAND = 1_000_000                   # bench_scale's decoder candidates


def _hold_spmm(label, raw, plain, g, x, dtype) -> float:
    """``raw`` (the kernel) against ``plain`` on the same tensors, within
    SCALE_TOL, and twice the same bits; returns the largest abs error."""
    out = raw(g, x, dtype)
    err = _hold(label, [("out", out, plain(g, x, dtype))])
    if not torch.equal(out, raw(g, x, dtype)):
        raise AssertionError(f"{label}: two launches differ")
    return err


def _control(label, a, b):
    """A kernel held against a plain version of another rounding must miss
    SCALE_TOL, or the tolerance could not see that rounding."""
    rel = float((a - b).abs().max()) / float(b.abs().max())
    print(f"  control: {label} rel={rel:.3e}")
    if rel <= SCALE_TOL:
        raise AssertionError(f"control: {label} passes the tolerance")


def _spmm_row(name, replaces, err, g, x, raw, plain):
    """Kernel, plain and library times of one layout in bf16 (the path's
    dtype), and its table row.  Bound: the CSR and x read once, the f32
    output written once."""
    ms = _time_ms(lambda: raw(g, x, torch.bfloat16))
    with torch.no_grad():
        plain_ms = _time_ms(lambda: plain(g, x, torch.bfloat16), reps=3)
    csr = torch.sparse_csr_tensor(g.row_ptr, g.src, g.val,
                                  size=(g.n_dst, g.n_src))
    xf = x.float()
    lib_ms = _time_ms(lambda: torch.sparse.mm(csr, xf))
    nbytes = _nbytes(g.row_ptr, g.src, g.val, x.bfloat16()) \
        + g.n_dst * x.shape[1] * 4
    return _scale_row(name, replaces, err, ms, plain_ms, nbytes,
                      2 * g.n_live * x.shape[1], torch.bfloat16, lib_ms,
                      "torch.sparse.mm on the CSR in f32",
                      gathered=(g.n_live, x.shape[1] * 2))


def phase_sparse_kernels(dev):
    """Rows 10 and 11 at their paths' shapes; returns (their table rows
    without launches, bench_scale's grouped graph)."""
    from dream_gnn_tpu_torch.augment.masks import prf_mask_pair
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg
    from dream_gnn_tpu_torch.kernels.spmm_slab import segment_sum_plain
    from dream_gnn_tpu_torch.scripts import bench_scale, bench_spmm

    t0 = time.perf_counter()
    graph = bench_scale.build_graph(BENCH_N, BENCH_E, True, dev)
    torch.cuda.synchronize()
    print(f"== sparse SpMM kernels vs plain: bench_scale --grouped's "
          f"relations {[p.fwd.n_live for p in graph.fwd]} edges over "
          f"{BENCH_N} x {BENCH_N} nodes, built in "
          f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"gather": 0.0, "blocked": 0.0}
    dtypes = (torch.float32, torch.bfloat16)
    for r, pair in enumerate(graph.fwd):
        for rate in (0.0, 0.3):
            p = prf_mask_pair(pair, 777, rate) if rate else pair
            for kind, g in (("fwd", p.fwd), ("bwd", p.bwd)):
                x = torch.randn(g.n_src, 128, device=dev, generator=gen)
                for dtype in dtypes:
                    err["gather"] = max(err["gather"], _hold_spmm(
                        f"gather rating {r} {kind} E={g.n_live} "
                        f"{str(dtype)[6:]} rate={rate}", sg.spmm_gather_raw,
                        sg.spmm_gather_plain, g, x, dtype))
    print("  times in bf16 at bench_scale's shapes:")
    for r, pair in enumerate(graph.fwd):
        for kind in ("fwd", "bwd"):
            g = getattr(pair, kind)
            x = torch.randn(g.n_src, 128, device=dev).bfloat16()
            ms = _time_ms(lambda: sg.spmm_gather_raw(g, x))
            print(f"    gather rating {r} {kind}: E={g.n_live}: {ms:.4f} ms, "
                  f"{_gather_rate(g.n_live, 128 * 2, ms)}")

    t0 = time.perf_counter()
    src, dst, val, x_np = bench_spmm.draw_graph(BENCH_N, BENCH_E)
    pairs = {"blocked": blocked_pair_from_arrays(src, dst, val, BENCH_N,
                                                 BENCH_N, device=dev),
             "gather": grouped_pair_from_arrays(src, dst, val, BENCH_N,
                                                BENCH_N, device=dev)}
    x = torch.from_numpy(x_np).to(dev)
    del src, dst, val, x_np
    torch.cuda.synchronize()
    print(f"  bench_spmm's graph: {BENCH_E} edges, U[0.5, 1.5) weights, "
          f"both layouts in {time.perf_counter() - t0:.2f} s")
    fns = {"blocked": (sb.spmm_blocked_raw, sb.spmm_blocked_plain),
           "gather": (sg.spmm_gather_raw, sg.spmm_gather_plain)}
    for name, pair in pairs.items():
        for rate in (0.0, 0.3):
            p = prf_mask_pair(pair, 4242, rate) if rate else pair
            for kind, g in (("fwd", p.fwd), ("bwd", p.bwd)):
                for dtype in dtypes:
                    err[name] = max(err[name], _hold_spmm(
                        f"{name} bench_spmm {kind} {str(dtype)[6:]} "
                        f"rate={rate}", *fns[name], g, x, dtype))
    gb, gg = pairs["blocked"].fwd, pairs["gather"].fwd
    _control("fp32 gather kernel vs bf16 plain",
             sg.spmm_gather_raw(gg, x, torch.float32),
             sg.spmm_gather_plain(gg, x, torch.bfloat16))
    _control("fp32 blocked kernel vs bf16 plain",
             sb.spmm_blocked_raw(gb, x, torch.float32),
             sb.spmm_blocked_plain(gb, x, torch.bfloat16))
    _control("bf16 blocked kernel vs the grouped rounding (val unrounded)",
             sb.spmm_blocked_raw(gb, x),
             segment_sum_plain(gb.row_ptr, gb.src, gb.val, x, True))
    _control("bf16 gather kernel vs the blocked rounding (val rounded)",
             sg.spmm_gather_raw(gg, x),
             segment_sum_plain(gg.row_ptr, gg.src, gg.val, x, True,
                               round_val=True))
    print(f"  both kernels: two launches give identical bits; times at "
          f"{BENCH_E} edges in bf16:")
    rows = [_spmm_row("spmm_gather", "pallas_spmm_gather.py:117",
                      err["gather"], gg, x, *fns["gather"]),
            _spmm_row("spmm_blocked", "pallas_spmm.py:61", err["blocked"],
                      gb, x, *fns["blocked"])]
    del pairs, gb, gg, x
    torch.cuda.empty_cache()
    _grouped_scatter(dev)
    return rows, graph


def _grouped_scatter(dev):
    """spmm_gather as the scale decoder's table-gradient scatter (a layout
    built with ``build_seq=False``): 1M slots into 100k rows against its
    plain version and bit for bit against seq_scatter; the decoder's
    gradients equal with either layout."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg

    rng = np.random.default_rng(4)
    n_cand = BENCH_CAND
    cand = [torch.from_numpy(rng.integers(0, BENCH_N, n_cand)).to(dev)
            for _ in range(2)]
    lay = sd.build_scale_decoder_layout(*cand, BENCH_N, BENCH_N, device=dev)
    print(f"  the decoder's scatter: {n_cand} slots into {BENCH_N} rows")
    for scat, seq in ((lay.scat_drug, lay.seq_drug),
                      (lay.scat_dis, lay.seq_dis)):
        for x_dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n_cand, 128, device=dev).to(x_dtype)
            for dtype in (torch.float32, torch.bfloat16):
                out = sg.spmm_gather_raw(scat, x, dtype)
                _hold_spmm(f"scatter x {str(x_dtype)[6:]} mode "
                           f"{str(dtype)[6:]}", sg.spmm_gather_raw,
                           sg.spmm_gather_plain, scat, x, dtype)
                if not torch.equal(out, sq.seq_scatter(seq, x, dtype)):
                    raise AssertionError("the grouped scatter differs from "
                                         "seq_scatter")
    print("  grouped scatter == seq_scatter bit for bit")
    x = torch.randn(n_cand, 128, device=dev).bfloat16()
    g = lay.scat_drug
    ms = _time_ms(lambda: sg.spmm_gather_raw(g, x))
    node, xf = lay.drug_of_slot.long(), x.float()
    out = torch.zeros(BENCH_N, 128, device=dev)
    lib_ms = _time_ms(lambda: out.zero_().index_add_(0, node, xf))
    nbytes = _nbytes(g.row_ptr, g.src, g.val, x) + BENCH_N * 128 * 4
    print(f"  scatter: {ms:.4f} ms, bound {nbytes / PEAK_BYTES_S * 1e3:.5f} "
          f"ms (bytes), {_gather_rate(n_cand, 128 * 2, ms)}, index_add_ in "
          f"f32: {lib_ms:.4f} ms")

    # The whole decoder with either layout: the same bits.
    f = torch.float32
    pd, pv = torch.randn(BENCH_N, 128, device=dev) * 0.5, \
        torch.randn(BENCH_N, 128, device=dev) * 0.5
    wts = [torch.rand(128, device=dev) * 0.1, torch.rand(128, 64,
                                                         device=dev) * 0.1,
           torch.rand(64, device=dev) * 0.1, torch.rand(64, device=dev) * 0.2,
           torch.zeros(1, device=dev)]
    seed = torch.tensor([918273], dtype=torch.int32, device=dev)
    gout = torch.randn(n_cand, device=dev)
    lay_g = sd.build_scale_decoder_layout(*cand, BENCH_N, BENCH_N,
                                          build_seq=False, device=dev)
    for dtype in (f, torch.bfloat16):
        res = []
        for layout in (lay, lay_g):
            leaves = [t.clone().requires_grad_(True) for t in (pd, pv, *wts)]
            out = sd.scale_decoder(*leaves, layout, seed, 0.3, True, dtype)
            (out * gout).sum().backward()
            res.append([out.detach()] + [t.grad for t in leaves])
        if not all(torch.equal(a, b) for a, b in zip(*res)):
            raise AssertionError(f"scale decoder ({dtype}): build_seq=False "
                                 f"differs from build_seq=True")
    print(f"  scale decoder fwd+bwd at {n_cand} candidates: build_seq=False "
          f"gives the bits of build_seq=True (fp32, bf16)")


def phase_bench_model():
    """The bench model's eval forward, card vs CPU, over the padded-COO
    and the grouped layout at 10k x 10k nodes and 1M edges."""
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, init_params,
                                                     map_params)
    from dream_gnn_tpu_torch.scripts import bench_scale

    n, n_edges, n_cand = 10_000, 1_000_000, 100_000
    print(f"== bench model eval forward, card vs CPU: {n} x {n} nodes, "
          f"{n_edges} edges, {n_cand} candidates")
    cfg = bench_scale.model_config()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    for grouped in (False, True):
        outs = {}
        for dev in ("cpu", "cuda:0"):
            graph = bench_scale.build_graph(n, n_edges, grouped, dev)
            inputs, _ = bench_scale.build_inputs(graph, n, n_cand, dev)
            with torch.no_grad():
                pred, *_ = forward(map_params(lambda x: x.to(dev), params),
                                   inputs, cfg, train=False)
            outs[dev] = pred.cpu()
        a, b = outs["cuda:0"], outs["cpu"]
        name = "grouped" if grouped else "coo"
        if a.shape != (n_cand,) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} bench logits: shape "
                                 f"{tuple(a.shape)} or non-finite values")
        rel = float((a - b).abs().max()) / float(b.abs().max())
        print(f"  {name} logits {tuple(a.shape)} rel_err={rel:.3e} "
              f"tol=1e-02")
        if rel > 1e-2:
            raise AssertionError(f"{name} bench logits on the card disagree "
                                 f"with the CPU")


def phase_bench_scale():
    """scripts.bench_scale at full size in both layouts, each with every
    launch count set to 0 just before; returns the grouped run's counts."""
    from dream_gnn_tpu_torch.scripts import bench_scale

    steps = bench_scale.STEPS * (1 + bench_scale.REPEATS)
    out = {}
    for flags in ([], ["--grouped"]):
        label = " ".join(["bench_scale", *flags])
        print(f"== {label}: python -m dream_gnn_tpu_torch.scripts."
              f"{label} (full size)")
        torch.cuda.empty_cache()
        _zero_launches()
        res = bench_scale.main(flags)
        torch.cuda.synchronize()
        launches = _launches()
        print(f"  launches on this path: {launches}")
        if flags:
            _expect_launches(launches, "gather", ("fwd", "bwd"), label)
            want = {"fwd": 12 * steps, "bwd": 12 * steps, "raw": 0}
            if launches["gather"] != want:
                raise AssertionError(f"{label}: spmm_gather launches "
                                     f"{launches['gather']}, the path "
                                     f"implies {want} ({steps} steps)")
        else:
            _expect_launches(launches, "none", (), label)
        if not np.isfinite(res["loss"]):
            raise AssertionError(f"{label}: loss {res['loss']}")
        print(f"  loss after {bench_scale.STEPS} steps {res['loss']:.4f}; "
              f"{res['ms_per_step']:.3f} ms/step (best of "
              f"{bench_scale.REPEATS} x {bench_scale.STEPS}, CUDA events), "
              f"{res['edges_per_s']:.4e} edges/s; peak device memory "
              f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB; layout build "
              f"{res['layout_build_s']:.3f} s")
        out[bool(flags)] = launches
    return out[True]


def phase_bench_spmm(graph, n_steps: int = 10):
    """scripts.bench_spmm at full size with its launch counts; then a
    profile of ten bench_scale --grouped steps over ``graph``.  Returns
    bench_spmm's counts."""
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.scripts import bench_scale, bench_spmm
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    print("== bench_spmm: python -m dream_gnn_tpu_torch.scripts.bench_spmm "
          "(full size)")
    torch.cuda.empty_cache()
    _zero_launches()
    res = bench_spmm.main([])
    torch.cuda.synchronize()
    launches = _launches()
    print(f"  launches on this path: {launches}")
    for mod, counts in launches.items():
        for k, n in counts.items():
            if mod in ("gather", "blocked") and k in ("fwd", "bwd"):
                if n <= 0:
                    raise AssertionError(f"bench_spmm never launched {mod} "
                                         f"{k}")
            elif n:
                raise AssertionError(f"bench_spmm launched {mod} {k}")
    for name in ("rel err blocked", "rel err gather"):
        if not res[name] <= 1e-5:
            raise AssertionError(f"bench_spmm {name} {res[name]}")

    print(f"== profile: {n_steps} bench_scale --grouped steps at full size")
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    inputs, labels = bench_scale.build_inputs(graph, BENCH_N, BENCH_CAND, dev)
    model = bench_scale.model_config()
    cfg = TrainConfig(model=model, beta=0.0,
                      augment=AugmentConfig(methods=()))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(init_params(gen, model), gen, cfg)
    step = make_one_step(model, cfg)
    w = torch.ones_like(labels)
    _profile("bench_scale --grouped step",
             lambda: step(state, inputs, labels, w), n_steps, top=None)
    return launches


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
    scale_in = _scale_problem()
    rows += phase_scale_kernels(scale_in[0])
    phase_scale_profile(*scale_in)
    del scale_in
    torch.cuda.empty_cache()
    phase_scale_model()
    launches_s = phase_scale_trainer()
    dev = torch.device("cuda", 0)
    sparse_rows, graph = phase_sparse_kernels(dev)
    phase_bench_model()
    launches_g = phase_bench_scale()
    launches_sp = phase_bench_spmm(graph)
    del graph
    # Rows 10 and 11 after row 9, as in the table of the TPU kernels.
    rows = rows[:9] + sparse_rows + rows[9:]
    # Each kernel's launches on the path that runs it.
    for row, n in zip(rows, (launches["grid"]["fwd"], launches["grid"]["bwd"],
                             launches_b["grid"]["fwd_b"],
                             launches_b["grid"]["bwd_b"],
                             launches_e["edge"]["fwd"],
                             launches_e["edge"]["bwd"],
                             launches_eb["edge"]["fwd_b"],
                             launches_eb["edge"]["bwd_b"],
                             sum(launches_s["spmm"].values()),
                             sum(launches_g["gather"].values()),
                             sum(launches_sp["blocked"].values()),
                             launches_s["seq"]["seq_scatter"],
                             launches_s["scale"]["k2"],
                             launches_s["scale"]["b1"],
                             launches_s["scale"]["mirror"])):
        row["launches"] = n
    if len(rows) != 15:
        raise AssertionError(f"the kernel table has {len(rows)} rows, not 15")
    print(gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
