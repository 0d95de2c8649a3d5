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
   cores), the edge ordering's build time and the size of the backward's
   dPd partial;
5. the fold-batched per-edge kernels at F = 3 folds' real lists, fold f
   equal to the single-fold kernel with seed[f] bit for bit, determinism;
   their times, rates and residency at F = 10 and at F = 100 (the 10 folds
   tiled ten times, as the benchmark's protocol stack), and at both the
   backward's device time split by a profile into its kernel and the
   partial sums;
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
    profile of ten ``bench_scale --grouped`` steps;
24. the ``.mat`` path: the Gdataset preset written with the port's
    ``save_mat`` as ``raw_data/drug_data/Gdataset/Gdataset.mat`` in a
    working directory, where the CLI loads exactly the preset's arrays from
    it and trains 20 steps on the grid kernels;
25. cut and resume: ``--fold_parallel --checkpoint_every 20`` over 60
    steps at the CLI's default width, uninterrupted, then cut right after
    its checkpoint at step 40 and resumed with ``--resume``: the two runs'
    CSVs must be the same (the largest loss difference is printed), and the
    resumed run launches rows 3 and 4; then a stacked checkpoint's write
    and load times;
26. novel predictions in grid and edges mode from a 20-step run's best
    params: the top-200 CSV is written, and the novel forward on the card
    (one launch of row 1, or of row 5 over all 183,676 zero cells) equals
    the plain versions on the CPU within phase 6's tolerance, its top-200
    order the CPU's apart from ties within it;
27. ``--profile_dir``: the trace of the first fold names
    ``grid_fwd_mma_kernel`` and ``grid_bwd_mma_kernel``, and ms/step with
    the trace on and off;
28. ``utils.timing.chained_ms`` times row 3 beside its bound, and its floor
    guard raises on a floor above the reading;
29. the six augment methods (``--aug_methods edge_dropout add_random_edges
    graph_noise feature_noise feature_masking mix_up``) through the CLI at
    full width, 41 steps with an eval every 20, sequential grid (rows 1
    and 2) and ``--decode_mode edges --fold_parallel`` (rows 7 and 8),
    each in turns with the default two methods (two, six, six, two), with
    their launch counts and ms/step beside those of phases 7 and 10, and
    phase 12's profile of a six-method step; the draws of the CUDA
    generator on the 10-fold stack (the add count per rating and fold
    within 5 sigma of its rate, graph noise on nonzero entries only, the
    feature keep rate 0.9 unscaled, mix-up's permutations and
    coefficients); and one augmented step with injected draws through the
    kernels and through their plain versions on the card, sequential and
    stacked, grid and edges: each launch against its plain version on its
    own inputs, and the step's logits and loss, within the bf16 tolerance;
    the gradients' largest errors printed.

30. the sharded scale path over ``torch.distributed``: the composed step
    (the sharded-grouped encoder and the candidate-sharded scale decoder
    through ``make_one_step``, the JAX scale script's full size, bf16, PRF
    edge dropout and decoder dropout 0.3) for 3 steps over one rank (NCCL,
    world size 1) and over 2 ranks (NCCL with one rank a card where there
    are two cards, else gloo ranks sharing cuda:0): the first step's PRF
    masks the same bits in both runs, the losses and every parameter after
    the steps, the first step's gradients and the eval logits before the
    steps (unscrambled by ``global_slot``, against the unsharded layout's)
    within stated tolerances, each rank's launches of rows 10 and 13-15 in
    the first step held against their plain versions on its own inputs and
    each rank's launch counts; then ``bench_scale --sharded-grouped`` at
    full size over the 2 ranks (3 + 3 steps: ms/step, edges/s, layout build,
    each rank's peak memory and launches), and ``--sharded`` and ``--ring``
    at ``--small`` over 2 ranks against the one-device layouts they shard
    (the loss, the launch counts); after each of these runs every
    parameter's copies on the ranks must be the same bits (fault C3: the
    step broadcasts the first rank's gradients, train/step.py), the
    largest difference printed per leaf.

31. the fold-parallel step on a dp x mp mesh (sharding/partition.py):
    the Gdataset stack at the CLI's width (F = 10 folds of seed 42, bf16,
    dropout 0.3, edge dropout and feature noise), 3 steps, in grid and
    edges mode, over 2 x 2 gloo ranks sharing cuda:0 (rank 0 also runs the
    one-rank reference over its 1 x 1 mesh) and over one NCCL rank: every
    draw of the first step on each rank bit for bit the one-rank draw's
    block of folds, the losses and the first step's gradients against one
    rank within stated tolerances, every parameter the same bits on the
    ranks of an mp group after the steps (the step broadcasts nothing over
    mp: the group's first-step gradients, as computed, and one broadcast's
    time are printed), each rank's launches of rows 3-4 or 7-8 in the
    first step held against their plain versions on the rank's block (with
    its column base), then the launch counts, ms/step and peak memory of
    each run; and one launch of rows 1 and 2 through
    ``fused_grid_decoder_spmd2d`` on each rank's block (row and column
    bases) held against its plain version, its gathered logits bit for bit
    one unsharded launch's.

32. GCMC's bilinear decoder, a kernel of the port alone, at the
    ``gcmc-ml10m-train`` cell's size (the cell's made ratings,
    ``gnnbench/inputs/movielens.py``: ~8.1M train ratings of 69,878 users
    and 10,677 movies, D = 75, 4 basis matrices, 10 levels, float32):
    ``launch_fwd`` and ``launch_bwd`` against ``bilinear_fwd_plain`` and
    ``bilinear_bwd_plain`` (the cotangent the softmax cross-entropy's of
    random tables) within 1e-5 of the plain output's largest value, two
    launches the same bits; then each one's time beside its
    bound (``gnnbench/counts_gcmc.py:bilinear_work``, each input read once,
    each output written once, or its operations at the float32 peak, the
    longer) and the plain version's, and a profile of the backward's
    kernels; then ``train.scale --model gcmc-ml10m`` at full size, 20 steps
    with an eval every 10 (valid and test), with its launch counts.

    Its split counter (``kernels/spmm_slab.py:NARROW``) must count every
    segment sum of the run on the narrow path, some of them split.

33. GCMC's float32 segment sums at the same size (phase 32's ratings, the
    encoder graph of the train ratings): what the 40 launches of a
    training step (10 levels, each level's two layout pairs forward and
    transposed, rows of 50) add to the split counter, then each one held
    against ``segment_sum_plain`` within 1e-4 of its largest value and
    launched twice for the same bits; each one's time beside its
    layout's longest row and nnz, its bound
    (``gnnbench/counts_gcmc.py:segment_sum_bytes``), the plain version's
    time and ``torch.sparse.mm``'s; the times' correlation with the
    longest row; a digest of the rows of at most 128 entries and one of
    two wide launches at d = 128; a profile of the launches' kernels.

Each trainer phase sets every launch count to 0 just before it drives its
entry point and reads the counts just after.

The line before the last is the JSON kernel table (each row's
``launches`` on its main path, and ``mesh_launches``, a rank's on phase
31's 2 x 2 mesh; under ``port_only`` phase 32's row, under
``narrow_segment_sum`` phase 33's, with phase 32's launches); the last
line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# The H100's published peaks and the kernels' bounds.
from dream_gnn_tpu_torch.utils.timing import (OPS_B1, OPS_K2, OPS_MIRROR,
                                              PEAK_BYTES_S, PEAK_FLOPS_S,
                                              bound_ms, decoder_bound_ms,
                                              decoder_flops, tensor_bytes)
from dream_gnn_tpu_torch.model.dream_gnn import named_leaves

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
        flops = decoder_flops(fwd, cells, nf)
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
        bound, by = decoder_bound_ms(kind == "fwd", dtype, ND, NV)
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
        bound, by = decoder_bound_ms(kind == "fwd", dtype, ND, NV,
                                     nf=NF)
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
    the edges, their ordering and a cotangent that is 0 on padding."""
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
    x["order"] = inputs.dec_order
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
    bound, by = decoder_bound_ms(kind == "fwd", dtype, ND, NV, cells=ne,
                                 nf=nf, index_bytes=nf * 2 * ne * 4)
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
            out_g = bwd(*args, rate, True, dtype, x["g"], x["order"])
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
        out_g = bwd(*args, rate, True, torch.float32, x["g"], x["order"])
        for name, a, b in [("logits", out, ref)] + list(zip(GRAD_NAMES, out_g,
                                                            ref_g)):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            print(f"  control fp32 {label} kernel vs bf16 plain "
                  f"rate={rate:.1f} {name:6s} rel={rel:.3e}")
            if name in ROUNDED and rel <= TOL[torch.bfloat16]:
                raise AssertionError(f"control: {label} {name} without bf16 "
                                     f"rounding passes the bf16 tolerance")
        del ref, ref_g
    first = bwd(*args, 0.3, True, torch.bfloat16, x["g"], x["order"])
    again = bwd(*args, 0.3, True, torch.bfloat16, x["g"], x["order"])
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
                                     x["order"]))}
    t32 = {"fwd": _time_ms(lambda: fwd(*args, rate, True, torch.float32)),
           "bwd": _time_ms(lambda: bwd(*args, rate, True, torch.float32,
                                       x["g"], x["order"]))}
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
    # The ordering's build, once per edge list (not in the step): its time
    # and its kernels.
    _profile("edge_order (torch ops)",
             lambda: ed.edge_order(x["edges"][0], x["edges"][1], ND, NV), 5)
    pd_bytes = -(-NV // ed.COL_BLOCK) * ND * 128 * 4
    print(f"  dPd partial {pd_bytes / 1e6:.2f} MB a fold (the (E, 128) da1 "
          f"rows it replaces: {ne * 128 * 4 / 1e6:.1f} MB), written once and "
          f"read once: {2 * pd_bytes / PEAK_BYTES_S * 1e3:.4f} ms at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s")
    return [_edge_row(kind, False, err, t, tp, torch.bfloat16, ne)
            for kind in ("fwd", "bwd")]


def phase_edge_kernels_batched(ds):
    """Rows 7-8: checks at F = 3 folds' real lists, fold f against the
    single-fold kernel with seed[f], timing at F = 10 and the kernels alone
    at F = 100; returns their table rows (F = 10) without launches."""
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed

    x = _edge_inputs(ds, NF_CHECK)
    ne = x["edges"].shape[-1]
    print(f"== batched edge kernels vs plain at F={NF_CHECK}, E={ne}")
    err = {"fwd": 0.0, "bwd": 0.0}
    args = _edge_checks(ed, x, True, "batched edges", err)
    for dtype in (torch.float32, torch.bfloat16):
        out = ed.launch_fwd_batched(*args, 0.3, True, dtype)
        grads = ed.launch_bwd_batched(*args, 0.3, True, dtype, x["g"],
                                      x["order"])
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
    rows = [_edge_row(kind, True, err, t, tp, torch.bfloat16, ne, NF)
            for kind in ("fwd", "bwd")]
    del x
    _edge_times_stack(ed, ds)
    return rows


def _edge_times_stack(ed, ds, n_tile: int = 10):
    """Rows 7 and 8 alone at the protocol stack's F = 100 (the 10 folds'
    train lists tiled ten times, as ``--seed_parallel`` and the benchmark
    stack them), bf16, dropout 0.3: times, rates, the backward's split, and
    its peak allocation over what the inputs hold."""
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds, tile

    stacked = tile(stack_folds(ds, list(range(NF))), n_tile)
    nf = NF * n_tile
    x = _decoder_inputs(ds.device, nf)
    x["edges"] = torch.stack([stacked.inputs.dec_src, stacked.inputs.dec_dst],
                             dim=-2).contiguous()
    x["order"] = stacked.inputs.dec_order
    rng = np.random.default_rng(1)
    x["g"] = torch.tensor(rng.normal(0, 1e-3, tuple(
        stacked.edge_weight.shape)).astype(np.float32),
        device=ds.device) * stacked.edge_weight
    del stacked
    args = [x[k] for k in KERNEL_ARGS[:6]] + [x["edges"], x["seed"]]
    ne = x["edges"].shape[-1]
    launches = dict(ed.LAUNCHES)
    t = {"fwd": _time_ms(lambda: ed.launch_fwd_batched(
             *args, 0.3, True, torch.bfloat16)),
         "bwd": _time_ms(lambda: ed.launch_bwd_batched(
             *args, 0.3, True, torch.bfloat16, x["g"], x["order"]))}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ed.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, x["g"],
                          x["order"])
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    ed.LAUNCHES.update(launches)
    peak = PEAK_FLOPS_S[torch.bfloat16]
    for kind in ("fwd", "bwd"):
        rate = decoder_flops(kind == "fwd", ne, nf) / t[kind] * 1e3
        print(f"  edge_decoder_{kind}_batched F={nf} E={ne}: {t[kind]:.4f} ms "
              f"({t[kind] / nf:.4f} ms per fold), {rate / 1e12:.2f} TFLOP/s "
              f"({100 * rate / peak:.1f}% of the bf16 peak)")
    print(f"  edge_decoder_bwd_batched F={nf}: peak allocation "
          f"{added / 2**30:.3f} GiB over its inputs (an (F, E, 128) f32 "
          f"buffer: {nf * ne * 512 / 2**30:.3f} GiB)")
    _edge_bwd_split(ed, x)


def _edge_bwd_split(ed, x, n_calls: int = 10):
    """Row 8's device time per launch (bf16, dropout 0.3), split by a
    profile into its kernel (edge_bwd_mma_kernel) and the wrapper's sums
    over the partials (every other kernel)."""
    from torch.profiler import ProfilerActivity, profile

    args = [x[k] for k in KERNEL_ARGS[:6]] + [x["edges"], x["seed"]]
    launches = dict(ed.LAUNCHES)

    def call():
        ed.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, x["g"],
                              x["order"])

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
    parts = {"kernel": 0.0, "partial sums": 0.0}
    for ms, _, key in rows:
        parts["kernel" if "edge_bwd_mma_kernel" in key
              else "partial sums"] += ms
    if not parts["kernel"]:
        raise AssertionError(f"edge backward profile lacks its kernel: {rows}")
    total = sum(parts.values())
    nf = x["edges"].shape[0]
    print(f"  edge_decoder_bwd_batched F={nf} device time per launch "
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
    from dream_gnn_tpu_torch.kernels import bilinear_decoder as bl
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    return {"grid": gd.LAUNCHES, "edge": ed.LAUNCHES, "spmm": sp.LAUNCHES,
            "seq": sq.LAUNCHES, "scale": sd.LAUNCHES, "gather": sg.LAUNCHES,
            "blocked": sb.LAUNCHES, "bilinear": bl.LAUNCHES,
            "narrow": sp.NARROW}


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
    """Trainer steps through the CLI; returns the kernels' launch counts
    and ms/step."""
    summary, launches = _run_trainer("trainer (Gdataset defaults)",
                                     ["--folds", "0", *TRAIN_41], 1)
    _expect_launches(launches, "grid", ("fwd", "bwd"), "trainer")
    return launches, summary["results"][0]["ms_per_step"]


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
    seed as one stack; returns the launch counts and ms/step."""
    summary, launches = _run_trainer(
        f"edges fold-parallel trainer ({NF} folds)",
        ["--decode_mode", "edges", "--fold_parallel", *TRAIN_41], NF)
    _print_stacked_ms(summary)
    _expect_launches(launches, "edge", ("fwd_b", "bwd_b"),
                     "edges fold-parallel")
    return launches, summary["results"][0]["ms_per_step"]


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


def phase_profile(path, n_steps: int = 10, methods=None) -> float:
    """Where a default training step's time goes (with ``methods``, a step
    with those augment methods); returns kernels/step."""
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    mode = path["decode_mode"]
    aug = "" if methods is None else f", augment methods {' '.join(methods)}"
    print(f"== profile: {n_steps} training steps, Gdataset defaults, "
          f"{mode} mode{aug}")
    cfg = TrainConfig() if methods is None \
        else TrainConfig(augment=AugmentConfig(methods=methods))
    ds = DreamDataset.load("Gdataset", k=cfg.num_neighbor, device="cuda:0")
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), **path)
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    state = init_state(init_params(gen, mcfg), gen, cfg)
    step = make_one_step(mcfg, cfg)
    inputs, _, labels, _ = fold_inputs(ds, 0)
    w = ds.fold(0).train_w
    return _profile(f"sequential {mode}{aug}",
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
    bound, by = bound_ms(nbytes, flops, dtype)
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
    nbytes = tensor_bytes(g.row_ptr, g.src, g.val, x) + g.n_dst * 128 * 4
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
    nbytes = tensor_bytes(g.offsets, val, x) + g.n_dst * 128 * 4
    return _scale_row("seq_scatter", "pallas_seq_scatter.py:144", err, ms,
                      plain_ms, nbytes, g.n_slots * 128, torch.bfloat16,
                      lib_ms, "index_add_ in f32",
                      gathered=(g.n_slots, 128 * 2))


def _unit_order(fn, *args, depths=(128,), long_f64=False):
    """``fn(*args)`` with each torch.matmul of a depth in ``depths`` (K2's
    a2 = rnd(h1d) @ rnd(w2) at 128; the grid and per-edge decoders' a2 and
    dh1 = rnd(da2) @ rnd(w2)^T at 128 and 64) summed one unit at a time in
    unit order, in f32: the order that the tensor-core kernels take where a
    value sits near a bf16 midpoint (a product of two bf16 values is exact
    in f32).  With ``long_f64`` every other product (the decoders' dW2 and
    dw3, sums over all cells or edges) is summed in float64 and rounded to
    f32 once: at F = 10 cuBLAS's f32 batched product over 185,609 cells is
    1.2e-4 of its largest value off that sum, the kernels 4e-6 to 2.6e-5
    (PERF.md)."""
    matmul = torch.matmul

    def unit(x, y):
        k = x.shape[-1]
        if k not in depths or y.dim() < 2 or y.shape[-2] != k:
            if long_f64:
                return matmul(x.double(), y.double()).float()
            return matmul(x, y)
        acc = torch.zeros(*x.shape[:-1], y.shape[-1], device=x.device)
        for u in range(k):
            acc += x[..., u:u + 1] * y[..., u:u + 1, :]
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
                   tensor_bytes(pd, pv, *fwd, *weights, out, a1),
                   OPS_K2 * e, dtype),
        _scale_row("scale_decoder_b1", "pallas_scale_decoder.py:579",
                   err["b1"], ms["b1"], plain["b1"],
                   tensor_bytes(a1, fwd[2], g, *weights, da1)
                   + tensor_bytes(w2, b1, b2, w3),      # the weight gradients
                   OPS_B1 * e, dtype),
        _scale_row("scale_decoder_mirror", "pallas_scale_decoder.py:679",
                   err["mirror"], ms["mirror"], plain["mirror"],
                   tensor_bytes(pd, pv, *mir, g_m, *weights, da1),
                   OPS_MIRROR * e, dtype)]


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
    nbytes = tensor_bytes(g.row_ptr, g.src, g.val, x.bfloat16()) \
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
    nbytes = tensor_bytes(g.row_ptr, g.src, g.val, x) + BENCH_N * 128 * 4
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


# ---------------------------------------------------------------------------
# The protocol's own tooling: the .mat path, checkpoint and resume, novel
# predictions, --profile_dir and chained_ms (phases 24-28).

SHORT_20 = ["--train_max_iter", "21", "--train_valid_interval", "10"]


def phase_mat_path():
    """The CLI where the working directory holds the reference .mat: the
    Gdataset preset written with the port's ``save_mat`` is what it loads,
    and the grid kernels run on it."""
    from dream_gnn_tpu_torch.data.matio import save_mat
    from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
    from dream_gnn_tpu_torch.train import cli

    raw = synthetic_raw_data("Gdataset")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        mat = Path(work, "raw_data", "drug_data", "Gdataset", "Gdataset.mat")
        mat.parent.mkdir(parents=True)
        t0 = time.perf_counter()
        save_mat(str(mat), raw)
        print(f"== .mat path: {mat.relative_to(work)} written "
              f"({mat.stat().st_size / 1e6:.1f} MB, "
              f"{time.perf_counter() - t0:.2f} s)")
        os.chdir(work)
        try:
            args = cli.build_parser().parse_args(["--data_name", "Gdataset"])
            t0 = time.perf_counter()
            ds = cli.resolve_dataset(args, cli.config_from_args(args),
                                     torch.device("cuda", 0))
            print(f"  the CLI resolves the .mat: loaded and built on the "
                  f"card in {time.perf_counter() - t0:.2f} s")
            for name in ("association", "drug_sim", "dis_sim", "drug_embed",
                         "dis_embed"):
                if not np.array_equal(getattr(ds.raw, name),
                                      getattr(raw, name)):
                    raise AssertionError(f"the .mat's {name} is not the "
                                         f"preset's")
            if ds.raw.drug_ids != raw.drug_ids:
                raise AssertionError("the .mat's Wrname is not the preset's")
            print(f"  every array of the file equals the preset's "
                  f"({ds.n_drug} x {ds.n_dis}, "
                  f"{int(ds.raw.association.sum())} positives)")
            del ds
            _, launches = _run_trainer(".mat trainer",
                                       ["--folds", "0", *SHORT_20], 1, 2)
        finally:
            os.chdir(cwd)
    _expect_launches(launches, "grid", ("fwd", "bwd"), ".mat")
    return launches


class _Cut(Exception):
    """Ends a run right after a checkpoint, as a preemption would."""


def _csv_texts(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_text()
            for p in sorted(d.rglob("*.csv"))}


def _hold_csvs(full: dict, cut: dict) -> None:
    """The resumed run's CSVs equal the uninterrupted run's.  Prints the
    largest difference in the loss column (0 when bit-identical)."""
    if set(full) != set(cut):
        raise AssertionError(f"CSV files differ: {sorted(full)} vs "
                             f"{sorted(cut)}")
    worst = {}
    for name in full:
        a, b = full[name].split(), cut[name].split()
        if len(a) != len(b) or a[0] != b[0]:
            raise AssertionError(f"{name}: rows {len(a)} vs {len(b)}")
        for ra, rb in zip(a[1:], b[1:]):
            for col, x, y in zip(a[0].split(","), ra.split(","),
                                 rb.split(",")):
                if col in ("fold", "experiment", "seed"):
                    if x != y:
                        raise AssertionError(f"{name}: {x} != {y}")
                    continue
                if x == y:
                    d = 0.0
                elif x in ("NA", "average") or y in ("NA", "average"):
                    raise AssertionError(f"{name}: {x} != {y}")
                else:
                    d = abs(float(x) - float(y))
                worst[col] = max(worst.get(col, 0.0), d)
    same = all(full[n] == cut[n] for n in full)
    print(f"  {len(full)} CSVs {'identical' if same else 'NOT identical'}; "
          f"largest loss difference {worst.get('loss', 0.0):.4f}, largest "
          f"of any metric {max(worst.values()):.4f}")
    if not same and max(worst.values()) > 1e-4 + 1e-9:
        raise AssertionError(f"resumed CSVs differ beyond their printed "
                             f"4th decimal: {worst}")


def phase_resume():
    """--fold_parallel --checkpoint_every 20 at the CLI's default width:
    an uninterrupted run of 60 steps, a run cut right after its checkpoint
    at step 40, and that run resumed with --resume, which must write the
    uninterrupted run's CSVs; then one stacked checkpoint's write and load
    times.  Returns the resumed run's launch counts."""
    import dream_gnn_tpu_torch.train.loop as loop
    from dream_gnn_tpu_torch.train.cli import main

    flags = ["--data_name", "Gdataset", "--seeds", "77", "--fold_parallel",
             "--train_max_iter", "61", "--train_valid_interval", "20",
             "--checkpoint_every", "20"]
    print(f"== cut and resume: python -m dream_gnn_tpu_torch.train.cli "
          f"{' '.join(flags)}")
    real_save = loop.save_train_state
    times = []

    def cut_after_40(path, state, step, *args, **kw):
        t0 = time.perf_counter()
        real_save(path, state, step, *args, **kw)
        times.append(time.perf_counter() - t0)
        if step == 40:
            raise _Cut

    with tempfile.TemporaryDirectory() as work:
        full, cut = Path(work, "full"), Path(work, "cut")
        main([*flags, "--save_dir", str(full)])
        loop.save_train_state = cut_after_40
        try:
            main([*flags, "--save_dir", str(cut)])
            raise AssertionError("the run went past its checkpoint at 40")
        except _Cut:
            pass
        finally:
            loop.save_train_state = real_save
        ckpt = cut / "seed_77" / "ckpt_stacked.npz"
        print(f"  cut after the checkpoint at step 40: {ckpt.name} "
              f"{ckpt.stat().st_size / 1e6:.1f} MB, written in "
              + ", ".join(f"{1e3 * t:.1f}" for t in times) + " ms")
        _zero_launches()
        main([*flags, "--save_dir", str(cut), "--resume"])
        torch.cuda.synchronize()
        launches = _launches()
        print(f"  launches on the resumed path: {launches}")
        _expect_launches(launches, "grid", ("fwd_b", "bwd_b"), "resumed")
        _hold_csvs(_csv_texts(full), _csv_texts(cut))
        rows = (cut / "seed_77" / "test_metric1.csv").read_text().split()
        if [int(r.split(",")[0]) for r in rows[1:]] != [20, 40, 60]:
            raise AssertionError(f"resumed rows: {rows}")
        _time_checkpoint(ckpt)
    return launches


def _time_checkpoint(ckpt: Path) -> None:
    """Write and load times of a stacked train state of the 10 folds at the
    CLI's default width (host clock, the card synchronised)."""
    from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.train.checkpoint import (load_train_state,
                                                      save_train_state)
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg
    from dream_gnn_tpu_torch.train.optim import PlateauScheduler
    from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                                   init_state_stacked)

    cfg = TrainConfig(model=ModelConfig(**MAIN_PATH))
    ds = DreamDataset.load("Gdataset", device="cuda:0")
    mcfg = derive_model_cfg(cfg, ds)
    folds = list(range(NF))
    gen = torch.Generator(device="cuda:0").manual_seed(1)
    state = init_state_stacked(init_params_stacked(mcfg, [77], folds,
                                                   "cuda:0"), gen, cfg)
    scheds = [PlateauScheduler(cfg.train_lr) for _ in folds]
    path = str(ckpt.parent / "timing.npz")
    t_save, t_load = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_train_state(path, state, 40, scheds, [dict.fromkeys(
            ("aupr", "auroc", "iter", "train_aupr", "train_auroc"), 0.0)]
            * NF)
        t_save.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        load_train_state(path, state, scheds)
        torch.cuda.synchronize()
        t_load.append(time.perf_counter() - t0)
    n = sum(t.numel() for t in state.opt.params)
    print(f"  stacked checkpoint of {NF} folds ({n / 1e6:.2f}M params, "
          f"{Path(path).stat().st_size / 1e6:.1f} MB): write "
          + "/".join(f"{1e3 * t:.1f}" for t in t_save) + " ms, load "
          + "/".join(f"{1e3 * t:.1f}" for t in t_load) + " ms (3 each)")


def phase_novel():
    """--save_model --generate_top_predictions in grid and edges mode, one
    fold: the top-k CSV is written; then the novel forward from the saved
    best params on the card (one grid decoder launch, or one edge decoder
    launch over all 183,676 zero cells) against the plain versions on the
    CPU.  Returns the forwards' launch counts."""
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.eval.novel import novel_scores
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.train import cli
    from dream_gnn_tpu_torch.train.checkpoint import load_params
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg

    ds = {dev: DreamDataset.load("Gdataset", device=dev)
          for dev in ("cuda:0", "cpu")}
    n_zero = ND * NV - int(ds["cpu"].raw.association.sum())
    out = {}
    for path in (MAIN_PATH, EDGES_PATH):
        mode = path["decode_mode"]
        flags = ["--data_name", "Gdataset", "--seeds", "77", "--folds", "0",
                 *SHORT_20, "--decode_mode", mode, "--save_model",
                 "--generate_top_predictions"]
        print(f"== novel predictions, {mode} mode: python -m "
              f"dream_gnn_tpu_torch.train.cli {' '.join(flags)}")
        with tempfile.TemporaryDirectory() as work:
            _zero_launches()
            cli.main([*flags, "--save_dir", work])
            torch.cuda.synchronize()
            print(f"  launches on this path: {_launches()}")
            seed_dir = Path(work, "seed_77")
            rows = (seed_dir / "top200_novel_predictions_fold1.csv") \
                .read_text().split()
            if rows[0] != "drug_id,disease_id,score,drug_name" \
                    or len(rows) != 201:
                raise AssertionError(f"top-200 CSV: {rows[:2]}, "
                                     f"{len(rows)} lines")
            mcfg = derive_model_cfg(cli.config_from_args(
                cli.build_parser().parse_args(flags)), ds["cpu"])
            params = load_params(str(seed_dir / "best_model_fold1.npz"),
                                 init_params(torch.Generator(), mcfg))
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zr, zc, card = novel_scores(params, mcfg, ds["cuda:0"], 0)
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launches()
        kind = "grid" if mode == "grid" else "edge"
        _expect_launches(launches, kind, ("fwd",), f"novel {mode}")
        if launches[kind]["fwd"] != 1 or len(zr) != n_zero:
            raise AssertionError(f"novel {mode}: {launches[kind]['fwd']} "
                                 f"launches over {len(zr)} cells")
        _, _, cpu = novel_scores(params, mcfg, ds["cpu"], 0)
        rel = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        tol = 1e-2 * float(np.abs(cpu).max())
        top = np.argsort(-card)[:200]
        order_err = float(np.abs(cpu[top] - np.sort(cpu)[::-1][:200]).max())
        csv_scores = np.array([float(r.split(",")[2]) for r in rows[1:]])
        csv_err = float(np.abs(csv_scores - card[top]).max())
        print(f"  novel forward on the card over {len(zr)} zero cells: "
              f"{ms:.1f} ms (host clock, one eval forward, the first after "
              f"the run), {launches[kind]['fwd']} {kind} decoder launch; "
              f"card vs CPU rel_err={rel:.3e} tol=1e-02; top-200 order vs "
              f"the CPU's, largest score gap {order_err:.3e} (tol "
              f"{tol:.3e}); the CLI's CSV vs this forward {csv_err:.3e}")
        if rel > 1e-2 or order_err > tol or csv_err > 1e-6 \
                or not np.isfinite(card).all():
            raise AssertionError(f"novel {mode} predictions disagree")
        out[mode] = launches
    return out


def phase_profile_dir():
    """--profile_dir traces the first fold: the trace names the tensor-core
    forward and backward; ms/step with and without the trace."""
    from dream_gnn_tpu_torch.train.cli import main

    flags = ["--data_name", "Gdataset", "--seeds", "77", "--folds", "0",
             *SHORT_20]
    print(f"== --profile_dir: python -m dream_gnn_tpu_torch.train.cli "
          f"{' '.join(flags)} --profile_dir DIR")
    ms = {}
    with tempfile.TemporaryDirectory() as work:
        for label in ("off", "on", "off again"):
            extra = ["--profile_dir", str(Path(work, "prof"))] \
                if label == "on" else []
            t0 = time.perf_counter()
            summary = main([*flags, *extra, "--save_dir",
                            str(Path(work, label))])
            ms[label] = (summary["results"][0]["ms_per_step"],
                         time.perf_counter() - t0)
        traces = list(Path(work, "prof").glob("*.json"))
        if len(traces) != 1:
            raise AssertionError(f"trace files: {traces}")
        text = traces[0].read_text()
        for name in _step_names("grid")["expect"]:
            if name not in text:
                raise AssertionError(f"the trace does not name {name}")
        print(f"  {traces[0].name}: {len(text) / 1e6:.1f} MB, names "
              + " and ".join(_step_names("grid")["expect"]))
    print("  ms/step (CUDA events, 20 steps) and run wall time: "
          + "; ".join(f"trace {k} {v[0]:.3f} ms/step, {v[1]:.1f} s"
                      for k, v in ms.items()))


def phase_chained_ms():
    """Row 3 (the batched grid forward, F = 10, bf16, dropout 0.3) timed by
    ``utils.timing.chained_ms`` beside its bound; the floor guard raises on
    a floor above the reading."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.utils.timing import (ImplausibleTiming,
                                                  chained_ms)

    print(f"== chained_ms: grid_decoder_fwd_batched F={NF}, bf16, dropout "
          f"0.3")
    x = _decoder_inputs(torch.device("cuda", 0), NF)
    rest = [x[k] for k in KERNEL_ARGS[1:]]
    saved = dict(gd.LAUNCHES)

    def fwd(pd, *args):
        return gd.launch_fwd_batched(pd, *args, 0.3, True, torch.bfloat16)

    bound, by = decoder_bound_ms(True, torch.bfloat16, ND, NV, nf=NF)
    ms = chained_ms(fwd, x["pd"], args=rest, n=8, reps=3, floor_ms=bound,
                    name="row 3", verbose=True)
    print(f"  row 3: {ms:.4f} ms a call (chained_ms, 8 links, best of 3), "
          f"bound {bound:.4f} ms ({by})")
    try:
        chained_ms(fwd, x["pd"], args=rest, n=8, reps=3, floor_ms=10 * ms,
                   name="row 3, floor 10x the reading")
    except ImplausibleTiming as e:
        print(f"  floor guard at {10 * ms:.4f} ms raised: {e}")
    else:
        raise AssertionError("the floor guard let a reading under its "
                             "floor through")
    gd.LAUNCHES.update(saved)


# ---------------------------------------------------------------------------
# The six augment methods of the training step (phase 29).

SIX = ("edge_dropout", "add_random_edges", "graph_noise", "feature_noise",
       "feature_masking", "mix_up")


def _within_5_sigma(count: float, n: int, p: float) -> bool:
    return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def _hold_draws(inputs, draws, cfg) -> None:
    """The CUDA generator's draws on the fold stack: add counts per rating,
    direction and fold within 5 sigma of the fold's own rate, graph noise
    on nonzero entries only, the feature keep rate 1 - 0.1 unscaled,
    mix-up's permutations and coefficients."""
    from dream_gnn_tpu_torch.augment.masks import apply_augment

    enc = inputs.enc_graph
    cells = enc.n_drug * enc.n_dis
    by = {(m, f): d for m, f, d in draws}
    add = by["add_random_edges", "edge_masks"]
    worst, expect = 0.0, []
    for r, a in enumerate((enc.a0(), enc.a1)):
        edges = a.sum((-2, -1)).tolist()
        expect = [cells * min(cfg.add_edge_rate * e / cells, 1.0)
                  for e in edges]
        for k in ("fwd_add", "rev_add"):
            counts = add[k][:, r].sum((-2, -1)).tolist()
            for f, (n_p, c) in enumerate(zip(expect, counts)):
                p = n_p / cells
                worst = max(worst, abs(c - n_p) / np.sqrt(n_p * (1 - p)))
                if not _within_5_sigma(c, cells, p):
                    raise AssertionError(f"fold {f} rating {r} {k}: {c:.0f} "
                                         f"added, expected {n_p:.1f}")
    print(f"  add counts: the largest of {4 * len(expect)} deviations is "
          f"{worst:.2f} sigma (rating 1 expects {min(expect):.1f}-"
          f"{max(expect):.1f} added edges a fold and direction)")
    noised, _ = apply_augment(inputs, [d for d in draws
                                       if d[0] == "graph_noise"], cfg)
    for field in ("drug_graph", "dis_graph", "drug_feature_graph",
                  "dis_feature_graph"):
        a, b = getattr(inputs, field).a, getattr(noised, field).a
        if not (bool((b[a == 0] == 0).all()) and bool((b >= 0).all())
                and not torch.equal(a[a != 0], b[a != 0])):
            raise AssertionError(f"graph noise on {field} touched a zero, "
                                 f"went negative or did nothing")
    for field in ("drug_feat", "dis_feat"):
        u = by["feature_masking", field]
        x = getattr(inputs, field)
        masked, _ = apply_augment(inputs, [("feature_masking", field, u)],
                                  cfg)
        y, kept = getattr(masked, field), u > cfg.feature_mask_rate
        if not (torch.equal(y[kept], x[kept]) and bool((y[~kept] == 0).all())):
            raise AssertionError(f"feature masking of {field} rescaled or "
                                 f"kept a masked entry")
        rates = kept.flatten(1).float().mean(1).tolist()
        n = x[0].numel()
        if not all(_within_5_sigma(r * n, n, 0.9) for r in rates):
            raise AssertionError(f"feature keep rates {rates}")
        perm, lam = by["mix_up", field]
        if not torch.equal(perm.sort(-1).values, torch.arange(
                perm.shape[-1], device=perm.device).expand_as(perm)):
            raise AssertionError(f"a mix-up row order of {field} is not a "
                                 f"permutation")
        if lam.shape != (len(rates),) or not bool(((lam >= 0)
                                                   & (lam <= 1)).all()):
            raise AssertionError(f"mix-up coefficients {lam.tolist()}")
        print(f"  {field}: keep rate {min(rates):.4f}-{max(rates):.4f} over "
              f"the folds; mix-up coefficients {np.round(lam.tolist(), 3)}")
    print("  graph noise: zeros stay zeros, values stay >= 0")


def _plain_versions():
    """(module, launch, plain version) of each decoder kernel of rows 1-8;
    a plain version takes its launch's arguments (but the edge backward's
    CSR, which only the kernel uses)."""
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    return [(gd, "launch_fwd", gd.grid_decoder_plain),
            (gd, "launch_bwd", gd.grid_decoder_plain_bwd),
            (gd, "launch_fwd_batched", gd.grid_decoder_batched_plain),
            (gd, "launch_bwd_batched", gd.grid_decoder_batched_plain_bwd),
            (ed, "launch_fwd", ed.edge_decoder_plain),
            (ed, "launch_bwd", lambda *a: ed.edge_decoder_plain_bwd(*a[:-1])),
            (ed, "launch_fwd_batched", ed.edge_decoder_batched_plain),
            (ed, "launch_bwd_batched",
             lambda *a: ed.edge_decoder_batched_plain_bwd(*a[:-1]))]


def _plain_kernels():
    """Every decoder wrapper of rows 1-8 calls its kernel's plain version
    in place of the kernel, on the card's tensors."""
    from contextlib import ExitStack
    from unittest import mock

    stack = ExitStack()
    for mod, name, plain in _plain_versions():
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def _recorded_kernels(calls: list):
    """Every decoder wrapper of rows 1-8 launches its kernel and appends
    (launch, plain version, arguments, outputs) to ``calls``."""
    from contextlib import ExitStack
    from unittest import mock

    stack = ExitStack()
    for mod, name, plain in _plain_versions():
        def record(*args, _launch=getattr(mod, name), _name=name,
                   _plain=plain):
            out = _launch(*args)
            calls.append((_name, _plain, args, out))
            return out
        stack.enter_context(mock.patch.object(mod, name, record))
    return stack


def _augmented_step(ds, mode: str, stacked: bool):
    """One training step at the CLI's default width with the six methods,
    its draws made once and injected, through the kernels and through their
    plain versions; both passes start from one generator state, so their
    dropout masks are the same.  Held within the bf16 tolerance: each
    kernel launch of the step against its plain version on the launch's
    own inputs (its depth-64 and -128 products in unit order, as the card
    tests hold them, and its sums over all cells or edges in float64), and
    the step's logits and loss; printed: the gradients' largest errors,
    which the plain pass's f32 sums in cuBLAS's order move.  Returns the
    largest held error."""
    from dream_gnn_tpu_torch.augment.masks import apply_augment, draw_augment
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, forward_stacked,
                                                     init_params, map_params)
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.losses import total_loss
    from dream_gnn_tpu_torch.train.stacked import init_params_stacked
    from dream_gnn_tpu_torch.train.step import decoder_targets

    dev = torch.device("cuda", 0)
    cfg = TrainConfig(augment=AugmentConfig(methods=SIX))
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), compute_dtype=
                               "bfloat16", decoder_backend="pallas",
                               decode_mode=mode)
    if stacked:
        st = stack_folds(ds, list(range(NF)))
        inputs, labels, weight = st.inputs, st.labels, st.edge_weight
        params0 = init_params_stacked(mcfg, [0], list(range(NF)), dev)
    else:
        inputs, _, labels, _ = fold_inputs(ds, 0)
        weight = ds.fold(0).train_w
        params0 = init_params(torch.Generator(device=dev).manual_seed(0),
                              mcfg)
    draws = draw_augment(torch.Generator(device=dev).manual_seed(1), inputs,
                         cfg.augment)
    calls, outs = [], {}
    for name, route in (("kernels", lambda: _recorded_kernels(calls)),
                        ("plain", _plain_kernels)):
        params = map_params(lambda t: t.detach().clone().requires_grad_(True),
                            params0)
        gen = torch.Generator(device=dev).manual_seed(2)
        with route():
            aug, masks = apply_augment(inputs, draws, cfg.augment)
            pred, *routes = (forward_stacked if stacked else forward)(
                params, aug, mcfg, train=True, generator=gen,
                edge_masks=masks)
            pred, lab, w = decoder_targets(pred, aug, mcfg, labels, weight)
            loss, _ = total_loss(pred, lab, *routes, beta=cfg.beta,
                                 smoothing=cfg.label_smoothing, weight=w)
            loss.sum().backward()
        torch.cuda.synchronize()
        outs[name] = [("logits", pred.detach()), ("loss", loss.detach())] + [
            (k, p.grad) for k, p in named_leaves(params)]

    def err(a, b):
        a, b = a.detach(), b.detach()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    launch_errs, cublas_errs = {}, {}
    for launch, plain, args, out in calls:
        with torch.no_grad():
            ref = _unit_order(plain, *args, depths=(64, 128),
                              long_f64=True)
            cublas = plain(*args)
        if isinstance(out, torch.Tensor):
            out, ref, cublas = (out,), (ref,), (cublas,)
        launch_errs[launch] = max(err(a, b) for a, b in zip(out, ref))
        cublas_errs[launch] = max(err(a, b) for a, b in zip(cublas, ref))
    errs = {k: err(a, b) for (k, a), (_, b) in zip(outs["kernels"],
                                                    outs["plain"])}
    held = dict(launch_errs, logits=errs.pop("logits"),
                loss=errs.pop("loss"))
    grads = sorted(((e, k) for k, e in errs.items()), reverse=True)
    dec = [(e, k) for e, k in grads if k.startswith("decoder")]
    enc = [(e, k) for e, k in grads if not k.startswith("decoder")]
    worst = max(held.values())
    print(f"  injected-draw step, {mode}{' stacked' if stacked else ''}: "
          f"each launch against its plain version on its inputs "
          + ", ".join(f"{k} {v:.3e} (the plain version's own f32 sums in "
                      f"cuBLAS's order {cublas_errs[k]:.3e})"
                      for k, v in launch_errs.items())
          + f"; the step's logits {held['logits']:.3e}, loss "
          f"{held['loss']:.3e} (kernels vs plain on the card, tol "
          f"{TOL[torch.bfloat16]:.0e}); gradients, not held: the decoder's "
          f"{len(dec)} up to {dec[0][0]:.3e} ({dec[0][1]}), the encoder's "
          f"{len(enc)} up to {enc[0][0]:.3e} ({enc[0][1]})")
    if worst > TOL[torch.bfloat16] or len(launch_errs) != 2 \
            or not all(np.isfinite(list(errs.values()))):
        raise AssertionError(f"the augmented step through the kernels is "
                             f"{worst:.3e} off its plain versions "
                             f"({held})")
    return worst


def _six_vs_two(label: str, flags, n_folds: int, module: str, kinds):
    """The CLI with the default two methods and with the six, in turns
    (two, six, six, two); each run's launches hold to ``kinds`` of
    ``module``.  Returns (ms/step of each run, the six-method launches)."""
    ms = {"two": [], "six": []}
    for which in ("two", "six", "six", "two"):
        aug = ["--aug_methods", *SIX] if which == "six" else []
        summary, launches = _run_trainer(
            f"{label}, {which} augment methods", [*flags, *TRAIN_41, *aug],
            n_folds)
        _expect_launches(launches, module, kinds, f"{label} {which}-method")
        ms[which].append(summary["results"][0]["ms_per_step"])
        if which == "six":
            six_launches = launches
    return ms, six_launches


def phase_six_augment_methods(gpu: str, default_ms: dict):
    """The six augment methods through the CLI, their draws on the card and
    one injected-draw step through the kernels against the plain versions;
    ``default_ms`` holds phase 7's and phase 10's ms/step."""
    from dream_gnn_tpu_torch.augment.masks import draw_augment
    from dream_gnn_tpu_torch.config import AugmentConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds

    grid_ms, launches = _six_vs_two("sequential grid", ["--folds", "0"], 1,
                                    "grid", ("fwd", "bwd"))
    edges_ms, launches_e = _six_vs_two(
        f"edges fold-parallel ({NF} folds)",
        ["--decode_mode", "edges", "--fold_parallel"], NF, "edge",
        ("fwd_b", "bwd_b"))

    def runs(ms):
        return " and ".join(f"{x:.3f}" for x in ms)

    print(f"  ms/step ({gpu}; CUDA events, mean of each run's 40 steps; runs "
          f"in turns two, six, six, two): sequential grid six methods "
          f"{runs(grid_ms['six'])}, two {runs(grid_ms['two'])} (phase 7: "
          f"{default_ms['grid']:.3f}); stacked edges F={NF} six "
          f"{runs(edges_ms['six'])}, two {runs(edges_ms['two'])} (phase 10: "
          f"{default_ms['edges']:.3f})")
    print(f"  launches of a six-method run: row 1 {launches['grid']['fwd']}, "
          f"row 2 {launches['grid']['bwd']}, row 7 "
          f"{launches_e['edge']['fwd_b']}, row 8 {launches_e['edge']['bwd_b']}")
    phase_profile(MAIN_PATH, methods=SIX)

    print(f"== six augment methods: the CUDA generator's draws on the "
          f"{NF}-fold stack")
    ds = DreamDataset.load("Gdataset", device="cuda:0")
    inputs = stack_folds(ds, list(range(NF))).inputs
    cfg = AugmentConfig(methods=SIX)
    _hold_draws(inputs, draw_augment(
        torch.Generator(device="cuda:0").manual_seed(3), inputs, cfg), cfg)
    del inputs
    print("== six augment methods: one injected-draw step, kernels vs their "
          "plain versions")
    for mode, stacked in (("grid", False), ("edges", True), ("grid", True),
                          ("edges", False)):
        _augmented_step(ds, mode, stacked)


# ---------------------------------------------------------------------------
# The sharded scale path (phase 30).

SHARDED_RANKS = 2
SHARDED_STEPS = 3
# Tolerances of the S-rank run against the one-rank run on the same card.
# The forward is the same arithmetic (its eval logits came out bit for bit
# equal); the backward sums the sharded regions' weight gradients as S
# partial sums, in another order.  So: the losses of the steps within 1e-4
# (relative); the first step's gradients within 1e-4 of each leaf's
# largest; the eval logits before the steps, against the unsharded
# layout's, within 1e-5.  Adam's step is lr * m / (sqrt(v) + 1e-8): a
# gradient element within 1e-8 of zero, whose last bits the order of the
# sums moves, takes a step of up to lr whose size those bits set, so the
# parameters after the steps are held to lr / 2 (absolute), not relative.
# Measured on the H100 (PR 15): 8.9e-8, 5.1e-6, 0 and 2.05e-4 (lr 2e-3).
SHARDED_TOL = {"loss": 1e-4, "grads1": 1e-4, "logits0": 1e-5,
               "params_abs": 1e-3}


def _held_launches(errs: dict):
    """Every launch of rows 10 and 13-15 (the grouped SpMM's segment sum,
    K2, B1 and the mirror) is held, right after it runs, against its plain
    version on the same inputs: the SpMM's f32 sums to SCALE_TOL, the scale
    kernels to the bf16 tolerance with their depth-64/128 products in unit
    order and their sums over all slots in float64, as phase 29 holds rows
    1-8.  ``errs[kind]`` keeps each kind's largest relative error; the
    plain versions launch nothing, so the counts see only the path's own
    launches."""
    from contextlib import ExitStack
    from unittest import mock

    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg
    from dream_gnn_tpu_torch.kernels.spmm_slab import segment_sum_plain

    def rel(out, ref):
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        return max(float((a.float() - b.float()).abs().max())
                   / max(float(b.float().abs().max()), 1e-30)
                   for a, b in zip(out, ref) if a is not None)

    def held(kind, launch, plain, unit):
        def run(*args, **kw):
            out = launch(*args, **kw)
            with torch.no_grad():
                ref = _unit_order(plain, *args, depths=(64, 128),
                                  long_f64=True) if unit \
                    else plain(*args, **kw)
            errs[kind] = max(errs.get(kind, 0.0), rel(out, ref))
            return out
        return run

    def bwd_plain(*args):
        return sd.scale_bwd_plain(*args[:-1], not args[-1])

    def bwd_kind(launch):
        def run(*args):
            return held("mirror" if args[-1] else "b1", launch, bwd_plain,
                        True)(*args)
        return run

    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        sg, "launch_segment_sum",
        held("spmm_gather", sg.launch_segment_sum, segment_sum_plain,
             False)))
    stack.enter_context(mock.patch.object(
        sd, "launch_k2", held("k2", sd.launch_k2, sd.scale_fwd_plain, True)))
    stack.enter_context(mock.patch.object(sd, "_launch_bwd",
                                          bwd_kind(sd._launch_bwd)))
    return stack


def _mask_hashes(graph, edge_masks, group) -> list:
    """Each relation's PRF keep mask over all its edges, ordered by edge id
    and gathered from every rank: (sha256 prefix, kept count) per relation
    and direction."""
    import hashlib

    from dream_gnn_tpu_torch.augment.masks import prf_keep_mask
    from dream_gnn_tpu_torch.sharding.collectives import all_gather_raw

    out = []
    for side in ("fwd", "rev"):
        for r, pair in enumerate(getattr(graph, side)):
            ids = pair.fwd.edge_id.long()
            keep = prf_keep_mask(edge_masks[f"{side}_salts"][r],
                                 pair.fwd.edge_id, edge_masks["rate"])
            counts = all_gather_raw(torch.tensor([ids.numel()],
                                                 device=ids.device), group)
            pad = int(counts.max()) - ids.numel()
            ids = all_gather_raw(torch.cat([ids, ids.new_full((pad,), -1)]),
                                 group)
            keep = all_gather_raw(torch.cat([keep, keep.new_zeros(pad)])
                                  .to(torch.uint8), group)
            full = torch.zeros(int(counts.sum()), dtype=torch.uint8,
                               device=ids.device)
            full[ids[ids >= 0]] = keep[ids >= 0]
            out.append((hashlib.sha256(full.cpu().numpy().tobytes())
                        .hexdigest()[:16], int(full.sum())))
    return out


def _sharded_step_rank(device, out_dir: str, tag: str) -> dict:
    """One rank of phase 30's composed training step at the JAX scale
    script's full size: the sharded-grouped encoder and the
    candidate-sharded scale decoder through ``make_one_step``, bf16, PRF
    edge dropout and decoder dropout 0.3, SHARDED_STEPS steps (the first
    with every launch held against its plain version), with an eval
    forward before and after.  Rank 0 writes the parameters after the
    steps, the first step's gradients and both evals' logits (in candidate
    order; on one rank also the unsharded layout's) to
    ``out_dir/{tag}.pt``; returns the numbers, every rank's where a rank
    has its own."""
    import torch.distributed as dist

    from dream_gnn_tpu_torch.augment.masks import EDGE_MASKS, draw_augment
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.kernels.scale_decoder import \
        build_scale_decoder_layout
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, init_params,
                                                     param_leaves)
    from dream_gnn_tpu_torch.scripts import bench_scale
    from dream_gnn_tpu_torch.sharding.collectives import replica_spread
    from dream_gnn_tpu_torch.sharding.mesh import make_mesh
    from dream_gnn_tpu_torch.sharding.multihost import describe
    from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import \
        build_scale_decoder_layout_sharded
    from dream_gnn_tpu_torch.sharding.scale_graph import \
        build_enc_graph_sharded_grouped
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    mesh = make_mesh(dp=dist.get_world_size())
    group, n_ranks = mesh.group("dp"), mesh.shape["dp"]
    n, n_edges, n_cand = bench_scale.SIZES["full"]
    t0 = time.perf_counter()
    graph = build_enc_graph_sharded_grouped(*bench_scale._edges(n, n_edges),
                                            n, n, mesh, "dp", device=device)
    inputs, labels = bench_scale.build_inputs(graph, n, n_cand, device)
    slay = build_scale_decoder_layout_sharded(
        inputs.dec_src, inputs.dec_dst, n, n, n_ranks, mesh=mesh, axis="dp",
        device=device)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    inputs = dataclasses.replace(inputs, dec_layout=slay)
    lab, w = slay.slot_labels(labels)
    model = dataclasses.replace(bench_scale.model_config(),
                                decoder_backend="pallas")
    cfg = TrainConfig(model=model, beta=0.0,
                      augment=AugmentConfig(methods=("edge_dropout",)))
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(init_params(gen, model), gen, cfg)
    one_step = make_one_step(model, cfg)
    # The first step's PRF masks: its draw, from a copy of the generator.
    peek = torch.Generator(device=device)
    peek.set_state(gen.get_state())
    masks = [d for _, f, d in draw_augment(peek, inputs, cfg.augment)
             if f == EDGE_MASKS][0]
    hashes = _mask_hashes(graph, masks, group)

    def eval_logits():
        """The eval forward's logits in candidate order; on one rank also
        the unsharded layout's."""
        with torch.no_grad():
            pred = forward(state.params, inputs, model, train=False)[0]
            out = {"sharded": slay.gather(pred).cpu()}
            if n_ranks == 1:
                lay = build_scale_decoder_layout(
                    inputs.dec_src, inputs.dec_dst, n, n, build_seq=False)
                one = forward(state.params, dataclasses.replace(
                    inputs, dec_layout=lay), model, train=False)[0]
                out["unsharded"] = one[lay.inv_slot.long()].cpu()
        return out

    logits0 = eval_logits()
    errs = {}
    _zero_launches()
    with _held_launches(errs):
        losses = [float(one_step(state, inputs, lab, w))]
    grads1 = [torch.zeros(0) if p.grad is None else p.grad.detach().cpu()
              for p in param_leaves(state.params)]
    # The path's own peak, over the steps the plain versions do not run in.
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [float(one_step(state, inputs, lab, w))
               for _ in range(SHARDED_STEPS - 1)]
    stop.record()
    torch.cuda.synchronize(device)
    launches = _launches()
    ms = start.elapsed_time(stop) / (SHARDED_STEPS - 1)
    peak = torch.cuda.max_memory_allocated(device)

    logits3 = eval_logits()
    names, leaves = zip(*named_leaves(state.params))
    replicas = dict(zip(names, replica_spread(leaves, group)))
    per_rank = [None] * n_ranks
    dist.all_gather_object(per_rank, dict(
        errs=errs, launches={k: launches[k] for k in ("gather", "scale")},
        peak=peak, build_s=build_s))
    if dist.get_rank() == 0:
        torch.save({"params": [p.detach().cpu()
                               for p in param_leaves(state.params)],
                    "names": [k for k, _ in named_leaves(state.params)],
                    "grads1": grads1, "logits0": logits0,
                    "logits3": logits3},
                   os.path.join(out_dir, f"{tag}.pt"))
    return dict(losses=losses, ms=ms, hashes=hashes, ranks=per_rank,
                replicas=replicas, describe=describe())


def _rel(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _hold_sharded_run(res, n_ranks, label):
    """Each rank's held launches and launch counts of phase 30's run."""
    want = {"gather": {"fwd": 12 * SHARDED_STEPS, "bwd": 12 * SHARDED_STEPS,
                       "raw": 2 * SHARDED_STEPS},
            "scale": {"k2": SHARDED_STEPS, "b1": SHARDED_STEPS,
                      "mirror": SHARDED_STEPS}}
    tol = {"spmm_gather": SCALE_TOL, "k2": TOL[torch.bfloat16],
           "b1": TOL[torch.bfloat16], "mirror": TOL[torch.bfloat16]}
    if len(res["ranks"]) != n_ranks:
        raise AssertionError(f"{label}: {len(res['ranks'])} ranks reported")
    for r, rank in enumerate(res["ranks"]):
        print(f"  {label} rank {r}: launches {rank['launches']}; each launch "
              f"of the first step against its plain version: "
              + ", ".join(f"{k} {v:.3e}" for k, v in sorted(
                  rank["errs"].items()))
              + f"; peak {rank['peak'] / 2 ** 30:.2f} GiB; layout build "
              f"{rank['build_s']:.2f} s")
        if rank["launches"] != want:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{rank['launches']}, the path implies "
                                 f"{want}")
        if set(rank["errs"]) != set(tol) or any(
                not rank["errs"][k] <= tol[k] for k in tol):
            raise AssertionError(f"{label} rank {r}: a launch disagrees with "
                                 f"its plain version: {rank['errs']}")


def _hold_replicas(label: str, replicas: dict) -> None:
    """Each parameter's largest difference between its copies on the
    ranks after the steps, which must be 0 (fault C3: replicated weights
    drifting apart; the step broadcasts the first rank's gradients)."""
    differ = {k: v for k, v in replicas.items() if v != 0.0}
    print(f"  {label}: the ranks' copies of the {len(replicas)} parameters "
          f"after the steps, the largest difference per leaf: "
          + ", ".join(f"{k} {v:.3e}" for k, v in replicas.items())
          + f"; {len(differ)} of {len(replicas)} leaves differ")
    if differ:
        raise AssertionError(f"{label}: the ranks' replicated parameters "
                             f"drifted apart: {differ}")


def _bench_sharded(flags, label):
    """``bench_scale`` in a multi-device mode; returns its numbers."""
    from dream_gnn_tpu_torch.scripts import bench_scale

    print(f"== {label}: python -m dream_gnn_tpu_torch.scripts.bench_scale "
          f"{' '.join(flags)}")
    t0 = time.perf_counter()
    res = bench_scale.main(flags)
    print(f"  {time.perf_counter() - t0:.1f} s of wall time")
    if not np.isfinite(res["loss"]):
        raise AssertionError(f"{label}: loss {res['loss']}")
    return res


def phase_sharded(gpu: str):
    """Phase 30, the sharded scale path (see the module doc)."""
    from dream_gnn_tpu_torch.sharding.multihost import spawn

    backend = "nccl" if torch.cuda.device_count() >= SHARDED_RANKS \
        else "gloo"
    host = "" if backend == "nccl" else (
        " (gloo ranks sharing one card: the times measure host staging, "
        "not a multi-GPU fabric)")
    print(f"== sharded scale path: {SHARDED_RANKS} ranks over {backend}, "
          f"one rank over nccl; {torch.cuda.device_count()} card(s); {gpu}")
    torch.cuda.empty_cache()    # the ranks are other processes on the card
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    runs, t_run = {}, {}
    for tag, n_ranks, be in (("one", 1, "nccl"),
                             ("sharded", SHARDED_RANKS, backend)):
        t0 = time.perf_counter()
        runs[tag] = spawn(_sharded_step_rank, n_ranks, be, (out_dir, tag))
        t_run[tag] = time.perf_counter() - t0
        res = runs[tag]
        print(f"  {tag}: {res['describe']}; losses "
              + ", ".join(f"{x:.6f}" for x in res["losses"])
              + f"; {res['ms']:.1f} ms/step (steps 2-{SHARDED_STEPS}, CUDA "
              f"events{'' if n_ranks == 1 else host}); "
              f"{t_run[tag]:.1f} s of wall time")
        _hold_sharded_run(res, n_ranks, tag)
        _hold_replicas(tag, res["replicas"])
    one, two = (torch.load(os.path.join(out_dir, f"{t}.pt"))
                for t in ("one", "sharded"))
    if runs["one"]["hashes"] != runs["sharded"]["hashes"]:
        raise AssertionError(f"the PRF masks differ: {runs['one']['hashes']}"
                             f" vs {runs['sharded']['hashes']}")
    print(f"  the first step's PRF masks, every relation's by edge id, the "
          f"same bits in both runs: {runs['one']['hashes']}")
    leaf = {k: sorted(((_rel(a, b), name) for name, a, b in zip(
                two["names"], two[k], one[k])), reverse=True)
            for k in ("grads1", "params")}
    unsharded = [_rel(one[t]["sharded"], one[t]["unsharded"])
                 for t in ("logits0", "logits3")]
    errs = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(
            runs["sharded"]["losses"], runs["one"]["losses"])),
        "grads1": leaf["grads1"][0][0],
        "logits0": _rel(two["logits0"]["sharded"],
                        one["logits0"]["unsharded"]),
        "params_abs": max(float((a - b).abs().max()) for a, b in
                          zip(two["params"], one["params"]))}
    print(f"  {SHARDED_RANKS} ranks vs one: "
          + ", ".join(f"{k} {v:.3e} (tol {SHARDED_TOL[k]:.0e})"
                      for k, v in errs.items())
          + f"; worst leaves (rel to the leaf's largest): gradients "
          + ", ".join(f"{k} {e:.2e}" for e, k in leaf["grads1"][:3])
          + ", parameters " + ", ".join(f"{k} {e:.2e}"
                                        for e, k in leaf["params"][:3])
          + f"; eval logits after the steps (not held: Adam's steps above) "
          f"{_rel(two['logits3']['sharded'], one['logits3']['unsharded']):.3e}"
          f"; one rank's sharded eval logits vs its unsharded layout's "
          + ", ".join(f"{v:.3e}" for v in unsharded))
    if any(not errs[k] <= SHARDED_TOL[k] for k in errs) or \
            max(unsharded) > SHARDED_TOL["logits0"]:
        raise AssertionError(f"the sharded run disagrees with one rank: "
                             f"{errs}")

    steps = ["--steps", str(SHARDED_STEPS), "--repeats", "1"]
    ranks = ["--nproc", str(SHARDED_RANKS), "--backend", backend]
    res = _bench_sharded(["--sharded-grouped", *ranks, *steps],
                         "bench_scale --sharded-grouped (full size)")
    n_steps = 2 * SHARDED_STEPS
    print(f"  {res['ms_per_step']:.1f} ms/step{host}, "
          f"{res['edges_per_s']:.4e} edges/s, layout build "
          f"{res['layout_build_s']:.2f} s, peak memory per rank "
          + ", ".join(f"{p / 2 ** 30:.2f} GiB"
                      for p in res["peak_memory_bytes"])
          + f"; launches per rank {res['launches']}")
    _hold_replicas("bench_scale --sharded-grouped", res["replica_spread"])
    want = {"fwd": 12 * n_steps, "bwd": 12 * n_steps, "raw": 0}
    if any(ln != want for ln in res["launches"]):
        raise AssertionError(f"bench_scale --sharded-grouped launches "
                             f"{res['launches']}, the path implies {want}")
    # --sharded and --ring at --small against the one-device layouts they
    # shard (the padded COO and the grouped one), run in this process.
    for flag, one_flags, per_step in (("--sharded", [], 0),
                                      ("--ring", ["--grouped"],
                                       12 * SHARDED_RANKS)):
        small = ["--small", *steps]
        one_rank = _bench_sharded([*small, *one_flags],
                                  f"bench_scale --small {' '.join(one_flags)}"
                                  f", one device")
        multi = _bench_sharded([flag, *small, *ranks],
                               f"bench_scale {flag} --small, "
                               f"{SHARDED_RANKS} ranks")
        rel = abs(multi["loss"] - one_rank["loss"]) / abs(one_rank["loss"])
        want = {"fwd": per_step * n_steps, "bwd": per_step * n_steps,
                "raw": 0}
        print(f"  {flag}: loss after {SHARDED_STEPS} steps "
              f"{multi['loss']:.6f} vs one device {one_rank['loss']:.6f} "
              f"(rel {rel:.3e}, tol {SHARDED_TOL['loss']:.0e}); "
              f"{multi['ms_per_step']:.1f} ms/step{host} vs "
              f"{one_rank['ms_per_step']:.1f}; launches per rank "
              f"{multi['launches']}")
        _hold_replicas(f"bench_scale {flag} --small",
                        multi["replica_spread"])
        if rel > SHARDED_TOL["loss"] or any(ln != want
                                            for ln in multi["launches"]):
            raise AssertionError(f"bench_scale {flag}: loss {rel:.3e} off "
                                 f"one device's, or launches "
                                 f"{multi['launches']} not {want}")


# ---------------------------------------------------------------------------
# The fold-parallel step on a dp x mp mesh (phase 31).

MESH_DP, MESH_MP = 2, 2
MESH_STEPS = 3
MESH_SEED = 42
# Tolerances of the 2 x 2 run against the one-rank run on the same card.
# Both draw the same masks (checked bit for bit) and run the same
# arithmetic, but for the decoder's weight and table gradients, summed as
# mp partial sums in another order, and cuBLAS's batched products over 5
# folds where one rank has 10: the losses of the steps within 1e-4
# (relative), the first step's gradients within 1e-4 of each leaf's
# largest, as phase 30 holds the sharded scale path.  Measured on the
# H100: losses 1.5e-6, gradients 8.5e-5 (decoder.w1, grid) and 2.2e-5
# (decoder.w2, edges).
MESH_TOL = {"loss": 1e-4, "grads1": 1e-4}


def _digest(x: torch.Tensor) -> str:
    import hashlib

    raw = x.detach().contiguous().cpu().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _mesh_held_launches(errs: dict):
    """Every launch of rows 1-4, 7 and 8 is held, right after it runs,
    against its plain version on the same inputs (the rank's block and its
    row and column bases), as phase 29 holds them: the depth-64/128
    products in unit order, the sums over all cells or edges in float64.
    ``errs[kind]`` keeps each kind's largest relative error; the plain
    versions launch nothing."""
    from contextlib import ExitStack
    from unittest import mock

    def rel(out, ref):
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        return max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                   for a, b in zip(out, ref))

    stack = ExitStack()
    for mod, name, plain in _plain_versions():
        if name in ("launch_fwd", "launch_bwd") and mod.__name__.endswith(
                "edge_decoder"):
            continue                     # rows 5 and 6: not on this path
        kind = f"{mod.__name__.rsplit('.', 1)[1].split('_')[0]} {name[7:]}"

        def held(*args, _launch=getattr(mod, name), _plain=plain,
                 _kind=kind):
            out = _launch(*args)
            with torch.no_grad():
                ref = _unit_order(_plain, *args, depths=(64, 128),
                                  long_f64=True)
            errs[_kind] = max(errs.get(_kind, 0.0), rel(out, ref))
            return out
        stack.enter_context(mock.patch.object(mod, name, held))
    return stack


def _recorded_draws(log: list):
    """Every training draw (utils/draws.py) appended to ``log`` as (fold
    axis, the rank's block of it)."""
    from unittest import mock

    from dream_gnn_tpu_torch.utils import draws

    plain = draws._draw

    def record(fn, shape, fold_dim):
        x = plain(fn, shape, fold_dim)
        log.append((fold_dim, x))
        return x
    return mock.patch.object(draws, "_draw", record)


def _mesh_run(mesh, ds, mode: str, device, out_dir: str, tag: str,
              hold: bool) -> dict:
    """F = 10 folds of seed 42 at the CLI's width over ``mesh``: the first
    step's loss and gradients with every draw recorded (and, with ``hold``,
    every decoder launch held against its plain version), then MESH_STEPS
    steps of ``make_multichip_train_fns``, the last two timed; the largest
    difference within the rank's mp group of each first-step gradient
    (the fused decoders' step broadcasts none) and of each parameter after
    the steps, and the time of one broadcast of the gradients over the
    group, the one the step would make to align them.  Writes the first
    step's gradients to ``out_dir/{tag}_grads{rank}.pt``."""
    import torch.distributed as dist

    from dream_gnn_tpu_torch.config import TrainConfig
    from dream_gnn_tpu_torch.sharding.collectives import (broadcast_first_,
                                                           replica_spread)
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.sharding.partition import (
        make_multichip_train_fns, shard_stacked)
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg
    from dream_gnn_tpu_torch.train.stacked import stacked_loss

    cfg = TrainConfig()
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds),
                               **dict(MAIN_PATH, decode_mode=mode))
    init_state, run_steps, _ = make_multichip_train_fns(mesh, mcfg, cfg)
    state = init_state(MESH_SEED, range(NF), device)
    tr = shard_stacked(mesh, stack_folds(ds, list(range(NF))), mode)
    gen = torch.Generator(device=device)
    gen.set_state(state.generator.get_state())
    log, errs = [], {}
    with _recorded_draws(log):
        if hold:
            with _mesh_held_launches(errs):
                losses = stacked_loss(state.params, tr.inputs, mcfg, cfg,
                                      gen, tr.labels, tr.edge_weight, mesh)
                losses.sum().backward()
        else:
            losses = stacked_loss(state.params, tr.inputs, mcfg, cfg, gen,
                                  tr.labels, tr.edge_weight, mesh)
            losses.sum().backward()
    named = named_leaves(state.params)
    torch.save([(k, p.grad.detach().cpu()) for k, p in named],
               os.path.join(out_dir, f"{tag}_grads{dist.get_rank()}.pt"))
    grads = [p.grad for _, p in named]
    grad_spread = replica_spread(grads, mesh.group("mp"))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    broadcast_first_(grads, mesh.group("mp"))
    torch.cuda.synchronize(device)
    bcast_ms = (time.perf_counter() - t0) * 1e3
    for _, p in named:
        p.grad = None
    _zero_launches()
    step_losses = [run_steps(state, tr, 1).cpu()]
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    step_losses += [run_steps(state, tr, 1) for _ in range(MESH_STEPS - 1)]
    stop.record()
    torch.cuda.synchronize(device)
    return dict(loss0=losses.detach().cpu(),
                step_losses=torch.stack([x.cpu() for x in step_losses]),
                draws=[(d, _digest(x)) for d, x in log],
                one_blocks=[[_digest(x.narrow(d, b * NF // MESH_DP,
                                              NF // MESH_DP))
                             for d, x in log] for b in range(MESH_DP)]
                if mesh.shape["dp"] == 1 else None,
                errs=errs, launches=_launches(),
                ms=start.elapsed_time(stop) / (MESH_STEPS - 1),
                grad_spread=grad_spread, bcast_ms=bcast_ms,
                peak=torch.cuda.max_memory_allocated(device),
                spread=max(replica_spread([p for _, p in named],
                                          mesh.group("mp"))))


def _spmd2d_held(mesh, device) -> dict:
    """One launch of rows 1 and 2 through ``fused_grid_decoder_spmd2d``
    (drug rows over dp, diseases over mp) at the Gdataset grid, bf16,
    dropout 0.3, each held against its plain version on the rank's block;
    the gathered logits against one unsharded launch of row 1, bit for
    bit."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.sharding.decoder_spmd import \
        fused_grid_decoder_spmd2d

    x = _decoder_inputs(device)
    args = [x[k].clone().requires_grad_(k not in ("seed",))
            for k in KERNEL_ARGS]
    errs = {}
    _zero_launches()
    with _mesh_held_launches(errs):
        logits = fused_grid_decoder_spmd2d(mesh, "dp", "mp", *args, 0.3,
                                           True, torch.bfloat16)
        logits.backward(x["g"])
    launches = _launches()["grid"]
    whole = gd.launch_fwd(*[x[k] for k in KERNEL_ARGS], 0.3, True,
                          torch.bfloat16)
    return dict(errs=errs, launches=launches,
                same=bool(torch.equal(logits.detach(), whole)))


def _mesh_step_rank(device, out_dir: str, dp: int, mp: int) -> dict:
    """One rank of phase 31: the grid and edges runs over the (dp, mp)
    mesh, and on rank 0 of a multi-rank spawn the same runs over its
    (1, 1) mesh; then the 2-D grid decoder once.  Returns, on rank 0, every
    rank's numbers."""
    import torch.distributed as dist

    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.sharding.mesh import make_mesh
    from dream_gnn_tpu_torch.sharding.multihost import describe
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    mesh = make_mesh(dp=dp, mp=mp)
    mesh1 = make_mesh(dp=1, mp=1) if dp * mp > 1 else None
    rank = dist.get_rank()
    ds = DreamDataset.load("Gdataset", device=device)
    mine = {}
    for mode in ("grid", "edges"):
        mine[mode] = _mesh_run(mesh, ds, mode, device, out_dir,
                               f"{mode}_mesh", True)
        if mesh1 is not None and rank == 0:
            mine[f"{mode} one"] = _mesh_run(mesh1, ds, mode, device, out_dir,
                                            f"{mode}_one", False)
    if dp > 1 and mp > 1:
        mine["spmd2d"] = _spmd2d_held(mesh, device)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(ranks=every, describe=describe())


def _hold_mesh_runs(res: dict, out_dir: str, label: str, gpu: str) -> dict:
    """Phase 31's checks of one spawn; returns each mode's launches of a
    rank."""
    kinds = {"grid": ("fwd_b", "bwd_b"), "edges": ("fwd_b", "bwd_b")}
    mods = {"grid": "grid", "edges": "edge"}
    out = {}
    for mode in ("grid", "edges"):
        one = res["ranks"][0].get(f"{mode} one")
        for r, rank in enumerate(res["ranks"]):
            run = rank[mode]
            counts = run["launches"][mods[mode]]
            want = {k: MESH_STEPS if k in kinds[mode] else 0 for k in counts}
            other = "edge" if mode == "grid" else "grid"
            print(f"  {label} {mode} rank {r}: {run['ms']:.1f} ms/step "
                  f"(steps 2-{MESH_STEPS}, CUDA events; {gpu}), peak "
                  f"{run['peak'] / 2 ** 30:.2f} GiB, launches {counts} in "
                  f"{MESH_STEPS} steps; each launch of the first step "
                  f"against its plain version: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in run["errs"].items())
                  + "; losses " + ", ".join(
                      f"{float(x):.6f}" for x in run["step_losses"][:, 0])
                  + f" (fold 0 of the rank); the mp group's first-step "
                  f"gradients, as computed: "
                  f"{sum(v != 0.0 for v in run['grad_spread'])} of "
                  f"{len(run['grad_spread'])} leaves apart, largest "
                  f"difference {max(run['grad_spread']):.1e}; one "
                  f"broadcast of them {run['bcast_ms']:.2f} ms (host "
                  f"clock); parameters after the steps: largest difference "
                  f"{run['spread']:.1e}")
            if counts != want or any(run["launches"][other].values()):
                raise AssertionError(f"{label} {mode} rank {r}: launches "
                                     f"{run['launches']}, the path implies "
                                     f"{want}")
            held = {f"{mods[mode]} {k}" for k in ("fwd_batched",
                                                  "bwd_batched")}
            if set(run["errs"]) != held or any(
                    not v <= TOL[torch.bfloat16]
                    for v in run["errs"].values()):
                raise AssertionError(f"{label} {mode} rank {r}: a launch "
                                     f"disagrees with its plain version: "
                                     f"{run['errs']}")
            if run["spread"] != 0.0:
                raise AssertionError(f"{label} {mode} rank {r}: the mp "
                                     f"group's replicas differ by "
                                     f"{run['spread']}")
            if not torch.isfinite(run["step_losses"]).all():
                raise AssertionError(f"{label} {mode}: losses "
                                     f"{run['step_losses']}")
        out[mode] = res["ranks"][0][mode]["launches"][mods[mode]]
        if one is None:
            continue
        # The mesh against rank 0 alone: masks, losses, gradients.
        size = NF // MESH_DP
        errs = {"loss": 0.0, "grads1": 0.0}
        leaf = {}
        for r, rank in enumerate(res["ranks"]):
            run, block = rank[mode], r // MESH_MP
            if [h for _, h in run["draws"]] != one["one_blocks"][block]:
                raise AssertionError(f"{label} {mode} rank {r}: its draws "
                                     f"are not one rank's block of folds")
            sl = slice(block * size, (block + 1) * size)
            errs["loss"] = max(errs["loss"], _rel(run["loss0"],
                                                  one["loss0"][sl]),
                               _rel(run["step_losses"],
                                    one["step_losses"]))
            grads = torch.load(os.path.join(out_dir,
                                            f"{mode}_mesh_grads{r}.pt"))
            ref = torch.load(os.path.join(out_dir, f"{mode}_one_grads0.pt"))
            for (name, a), (_, b) in zip(grads, ref):
                leaf[name] = max(leaf.get(name, 0.0), _rel(a, b[sl]))
        errs["grads1"] = max(leaf.values())
        worst = sorted(((v, k) for k, v in leaf.items()), reverse=True)
        print(f"  {label} {mode}: {len(one['draws'])} draws of the first "
              f"step (augmentation, dropout, decoder seeds), each rank's bit "
              f"for bit one rank's block of folds; 4 ranks vs one: "
              + ", ".join(f"{k} {v:.3e} (tol {MESH_TOL[k]:.0e})"
                          for k, v in errs.items())
              + "; worst leaves " + ", ".join(f"{k} {v:.3e}"
                                              for v, k in worst[:3])
              + "; one rank "
              f"{one['ms']:.1f} ms/step, peak {one['peak'] / 2 ** 30:.2f} "
              f"GiB")
        if any(not errs[k] <= MESH_TOL[k] for k in errs):
            raise AssertionError(f"{label} {mode}: the mesh disagrees with "
                                 f"one rank: {errs}")
    return out


def phase_mesh(gpu: str) -> dict:
    """Phase 31, the fold-parallel step on a dp x mp mesh (see the module
    doc); returns the launches a rank of rows 1-4, 7 and 8 over the 2 x 2
    mesh's runs."""
    from dream_gnn_tpu_torch.sharding.multihost import spawn

    n = MESH_DP * MESH_MP
    print(f"== mesh step: {MESH_DP} x {MESH_MP} gloo ranks sharing cuda:0 "
          f"(their times measure host staging, not a multi-GPU fabric) with "
          f"rank 0's one-rank reference, then one NCCL rank; Gdataset F = "
          f"{NF} folds of seed {MESH_SEED}, bf16, dropout 0.3, edge dropout "
          f"and feature noise, {MESH_STEPS} steps; {gpu}")
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.perf_counter()
    res = spawn(_mesh_step_rank, n, "gloo", (out_dir, MESH_DP, MESH_MP))
    print(f"  {res['describe']}; {time.perf_counter() - t0:.1f} s of wall "
          f"time")
    launches = _hold_mesh_runs(res, out_dir, f"{MESH_DP}x{MESH_MP}", gpu)
    for r, rank in enumerate(res["ranks"]):
        s2 = rank["spmd2d"]
        print(f"  spmd2d rank {r}: launches {s2['launches']}; against the "
              f"plain version on the rank's block: "
              + ", ".join(f"{k} {v:.3e}" for k, v in s2["errs"].items())
              + f"; gathered logits bit for bit one unsharded launch: "
              f"{s2['same']}")
        want = {"fwd": 1, "bwd": 1, "fwd_b": 0, "bwd_b": 0}
        if s2["launches"] != want or not s2["same"] or set(s2["errs"]) != {
                "grid fwd", "grid bwd"} or any(
                not v <= TOL[torch.bfloat16] for v in s2["errs"].values()):
            raise AssertionError(f"spmd2d rank {r}: {s2}")
    t0 = time.perf_counter()
    res1 = spawn(_mesh_step_rank, 1, "nccl", (out_dir, 1, 1))
    print(f"  {res1['describe']}; {time.perf_counter() - t0:.1f} s of wall "
          f"time")
    _hold_mesh_runs(res1, out_dir, "nccl 1x1", gpu)
    return dict(launches, spmd2d=res["ranks"][0]["spmd2d"]["launches"])


# ---------------------------------------------------------------------------
# GCMC alone on MovieLens-10M (train.scale --model gcmc-ml10m).

BILINEAR_TOL = 1e-5   # of the plain output's largest value, float32 sums


def _bilinear_profile(fwd, bwd, n_calls: int = 5):
    """Device ms a call of each kernel the forward and backward launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fwd()
            bwd()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / n_calls / 1e3
            for ev in prof.key_averages()
            if "_kernel" in ev.key and ev.device_time_total > 0}


def phase_bilinear():
    """Phase 32: the bilinear decoder at the gcmc-ml10m cell's size, then
    the GCMC trainer's launches; returns the kernel's row and the
    trainer's split counter (``kernels/spmm_slab.py:NARROW``)."""
    from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd
    from dream_gnn_tpu_torch.train import scale
    from gnnbench import counts_gcmc
    from gnnbench.inputs.movielens import ratings

    dev = torch.device("cuda", 0)
    cfg = json.loads(Path(__file__).with_name("gnnbench").joinpath(
        "configs", "gcmc-ml10m.json").read_text())
    nu, nm, r = cfg["n_users"], cfg["n_movies"], cfg["num_ratings"]
    b, d = cfg["gen_r_num_basis_func"], cfg["gcn_out_units"]
    raw = ratings(cfg, 2_200_032_001, dev)
    tr = raw["train"]
    t0 = time.perf_counter()
    lay = bd.build_bilinear_layout(raw["users"][tr], raw["movies"][tr], nu,
                                   nm, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    e = lay.n_edges
    print(f"== bilinear decoder at gcmc-ml10m's size: {e} train ratings, "
          f"the most rated movie "
          f"{int(torch.bincount(lay.dst.long(), minlength=nm).max())}, the "
          f"heaviest user "
          f"{int(torch.bincount(lay.src.long(), minlength=nu).max())}; "
          f"layout {build_s:.3f} s")
    lab = lay.slot_labels(raw["levels"][tr])
    del raw, tr
    gen = torch.Generator(device=dev).manual_seed(32)
    u = torch.randn(nu, d, device=dev, generator=gen)
    v = torch.randn(nm, d, device=dev, generator=gen)
    p = torch.randn(b, d, d, device=dev, generator=gen) * d ** -0.5
    a = torch.randn(r, b, device=dev, generator=gen)
    up = (u @ bd.basis_cat(p)).reshape(nu, b, d)
    # The cotangent of the cell's loss: the softmax cross-entropy's.
    logits = bd.bilinear_fwd_plain(up, v, a, lay).requires_grad_(True)
    torch.nn.functional.cross_entropy(logits.T, lab).backward()
    g = logits.grad
    del logits, lab

    def fwd():
        return bd.launch_fwd(up, v, a, lay)

    def bwd():
        return bd.launch_bwd(g, up, u, v, a, lay)

    def plain_fwd():
        return bd.bilinear_fwd_plain(up, v, a, lay)

    def plain_bwd():
        return bd.bilinear_bwd_plain(g, up, u, v, a, lay)

    _zero_launches()
    out, grads = fwd(), bwd()
    err = max(_hold("bilinear fwd", [("logits", out, plain_fwd())],
                    BILINEAR_TOL),
              _hold("bilinear bwd", list(zip(("dUP", "da", "W"), grads,
                                             plain_bwd())), BILINEAR_TOL))
    if not (torch.equal(fwd(), out)
            and all(torch.equal(x, y) for x, y in zip(bwd(), grads))):
        raise AssertionError("two bilinear launches differ in their bits")
    if _launches()["bilinear"] != {"fwd": 2, "bwd": 2}:
        raise AssertionError(f"bilinear launches {_launches()['bilinear']}"
                             f" where 2 and 2 were made")
    print("  two launches of each: the same bits")
    del out, grads
    ms = (_time_ms(fwd), _time_ms(bwd))
    plain_ms = (_time_ms(plain_fwd, reps=3), _time_ms(plain_bwd, reps=3))
    bounds = [bound_ms(nbytes, ops["float32"], torch.float32)
              for ops, nbytes in counts_gcmc.bilinear_work(e, nu, nm, r, b,
                                                           d)]
    bound = sum(t for t, _ in bounds)
    for name, t, (least, by), t_plain in zip(("forward", "backward"), ms,
                                             bounds, plain_ms):
        print(f"  {name}: {t:.4f} ms, bound {least:.4f} ms ({by}), plain "
              f"{t_plain:.2f} ms")
    print(f"  forward + backward {sum(ms):.4f} ms, bound {bound:.4f} ms: "
          f"{100 * bound / sum(ms):.2f}% of the roofline")
    for name, t in _bilinear_profile(fwd, bwd).items():
        print(f"  {name[:60]:60s} {t:.4f} ms a call")

    argv = ["--model", "gcmc-ml10m", "--iters", "21", "--valid_interval",
            "10"]
    print(f"== GCMC trainer: python -m dream_gnn_tpu_torch.train.scale "
          f"{' '.join(argv)} (full size)")
    with tempfile.TemporaryDirectory() as save_dir:
        _zero_launches()
        rc = scale.main([*argv, "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches = _launches()
        summary = json.loads(Path(save_dir, "summary.json").read_text())
        csv = Path(save_dir, "test_metric0.csv").read_text().split()
    if rc != 0 or len(csv) != 3:
        raise AssertionError(f"GCMC trainer: rc {rc}, rows {csv}")
    # Each forward sums 10 levels in two directions; an eval is a forward
    # of the valid and one of the test side.
    steps, evals = 20, 2 * 2
    narrow = launches.pop("narrow")
    want = {mod: {k: 0 for k in counts} for mod, counts in launches.items()}
    want.update(spmm={"fwd": 2 * r * (steps + evals), "bwd": 2 * r * steps},
                bilinear={"fwd": steps + evals, "bwd": steps})
    print(f"  launches on this path: {launches}")
    if launches != want:
        raise AssertionError(f"GCMC trainer launches {launches}, the path "
                             f"implies {want}")
    # Every segment sum of the path is on the narrow path (rows of 50),
    # and the movies' long rows are split.
    print(f"  split counter (kernels/spmm_slab.py:NARROW): {narrow}")
    if narrow["launches"] != sum(want["spmm"].values()) \
            or narrow["split_launches"] == 0:
        raise AssertionError(f"GCMC trainer: {narrow['launches']} narrow "
                             f"launches of {sum(want['spmm'].values())}, "
                             f"{narrow['split_launches']} of them split")
    print(f"  {summary['ms_per_step']:.3f} ms/step (mean of the 20 steps, "
          f"CUDA events); peak device memory "
          f"{summary['peak_memory_bytes'] / 2 ** 30:.2f} GiB; layout build "
          f"{summary['layout_build_s']:.3f} s; best valid RMSE "
          f"{summary['best_valid_rmse']:.4f}")
    return dict(name="bilinear_decoder", route="cuda",
                source="dream_gnn_tpu_torch/kernels/csrc/bilinear_decoder.cu",
                replaces=None, launches=launches["bilinear"],
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=[t for t, _ in bounds],
                bound_by=[by for _, by in bounds], library_ms=None), narrow


def _segment_sum_profile(calls) -> dict:
    """Device ms of each kernel over one run of ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / 1e3 for ev in prof.key_averages()
            if "segment_sum" in ev.key and ev.device_time_total > 0}


def _corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, float), np.asarray(b, float))[0, 1])


def phase_gcmc_segment_sums(narrow: dict):
    """Phase 33: the GCMC layer's float32 segment sums of one training step
    at the gcmc-ml10m cell's size, launch by launch; returns the narrow
    path's row, whose launches and split counts are those of phase 32's
    trainer run (``narrow``)."""
    import hashlib

    from dream_gnn_tpu_torch.graph.slabbed import build_enc_graph_slabbed
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp
    from gnnbench import counts_gcmc
    from gnnbench.inputs.movielens import ratings

    dev = torch.device("cuda", 0)
    cfg = json.loads(Path(__file__).with_name("gnnbench").joinpath(
        "configs", "gcmc-ml10m.json").read_text())
    nu, nm, r = cfg["n_users"], cfg["n_movies"], cfg["num_ratings"]
    d = cfg["gcn_agg_units"] // r
    raw = ratings(cfg, 2_200_032_001, dev)
    tr = raw["train"]
    t0 = time.perf_counter()
    graph = build_enc_graph_slabbed(
        torch.stack([raw["users"][tr], raw["movies"][tr]]), raw["levels"][tr],
        nu, nm, ratings=range(r), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del raw, tr
    # The step's 40 launches: each relation's two layout pairs, forward
    # (pair.fwd) and the transposed backward (pair.bwd).
    layouts = [(f"{side}[{i}].{k}", getattr(pair, k))
               for i in range(r)
               for side, pair in (("fwd", graph.fwd[i]), ("rev", graph.rev[i]))
               for k in ("fwd", "bwd")]
    print(f"== GCMC segment sums at gcmc-ml10m's size: {len(layouts)} "
          f"launches, float32 rows of {d}, "
          f"{sum(g.n_live for _, g in layouts) // 4} train ratings; graph "
          f"{build_s:.3f} s")
    # What the step's launches add to the split counter, from the sizes
    # the layouts' pieces carry (phase 32's trainer draws its ratings
    # uniformly, and splits few rows).
    pcs = [g.pieces for _, g in layouts]
    step_split = dict(launches=len(pcs),
                      split_launches=sum(pc.n_split > 0 for pc in pcs),
                      split_rows=sum(pc.n_split for pc in pcs),
                      split_pieces=sum(pc.n_split + pc.n_extra for pc in pcs))
    print(f"  split counter over one step's launches: {step_split}")
    if step_split["split_launches"] == 0:
        raise AssertionError("no launch of the step splits a row")
    gen = torch.Generator(device=dev).manual_seed(33)
    rows, calls, libs, short = [], [], [], hashlib.sha256()
    worst = lib_worst = 0.0
    for name, g in layouts:
        x = torch.randn(g.n_src, d, device=dev, generator=gen)

        def fn(g=g, x=x):
            return sp.launch_segment_sum(g.row_ptr, g.src, g.val, x, False,
                                         pieces=g.pieces)

        out = fn()
        ref = sp.segment_sum_plain(g.row_ptr, g.src, g.val, x, False)
        worst = max(worst, _hold(name, [("out", out, ref)]))
        if not torch.equal(out, fn()):
            raise AssertionError(f"{name}: two launches differ in their bits")
        lens = (g.row_ptr[1:] - g.row_ptr[:-1]).long()
        # Rows of at most 128 entries sum in one piece: their bits are the
        # one-warp-a-row kernel's.
        short.update(out[lens <= 128].cpu().numpy().tobytes())
        # The library's f32 CSR product of the same sum.
        a = torch.sparse_csr_tensor(g.row_ptr, g.src, g.val,
                                    size=(g.n_dst, g.n_src))
        lib_worst = max(lib_worst, _rel(torch.sparse.mm(a, x), out))
        ms = _time_ms(fn)
        lib_ms = _time_ms(lambda a=a, x=x: torch.sparse.mm(a, x))
        plain_ms = _time_ms(lambda: sp.segment_sum_plain(
            g.row_ptr, g.src, g.val, x, False), reps=3)
        bound = counts_gcmc.segment_sum_bytes(
            g.n_src, g.n_dst, g.n_live, d) / PEAK_BYTES_S * 1e3
        rows.append(dict(name=name, movies=g.n_dst == nm, nnz=g.n_live,
                         longest=int(lens.max()), ms=ms, plain_ms=plain_ms,
                         lib_ms=lib_ms, bound=bound))
        calls.append(fn)
        libs.append(lib_ms)
        print(f"  {name:10s} into {'movies' if g.n_dst == nm else 'users '} "
              f"nnz {g.n_live:8d} longest row {int(lens.max()):6d}: "
              f"{ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.2f}%), plain {plain_ms:.3f} ms, "
              f"torch.sparse.mm {lib_ms:.4f} ms")
    print(f"  every launch: two launches the same bits; torch.sparse.mm "
          f"within {lib_worst:.3e} of the largest value")
    total = sum(x["ms"] for x in rows)
    bound = sum(x["bound"] for x in rows)
    print(f"  one step's {len(rows)} launches: {total:.4f} ms, bound "
          f"{bound:.4f} ms ({100 * bound / total:.2f}%), plain "
          f"{sum(x['plain_ms'] for x in rows):.2f} ms, torch.sparse.mm "
          f"{sum(libs):.4f} ms")
    for dst in (True, False):
        sel = [x for x in rows if x["movies"] == dst]
        print(f"  into {'movies' if dst else 'users'}: {len(sel)} launches, "
              f"{sum(x['ms'] for x in sel):.4f} ms; correlation of the time "
              f"with the longest row "
              f"{_corr([x['ms'] for x in sel], [x['longest'] for x in sel]):.3f}"
              f", with nnz "
              f"{_corr([x['ms'] for x in sel], [x['nnz'] for x in sel]):.3f}")
    print(f"  digest of the rows of at most 128 entries: "
          f"{short.hexdigest()[:16]}")
    for name, t in _segment_sum_profile(calls).items():
        print(f"  {name[:90]:90s} {t:.4f} ms over the {len(calls)} launches")
    # The wide path (d % 8 == 0) at the scale cell's width: its bits.
    g = graph.fwd[r - 1].fwd
    wide = hashlib.sha256()
    for x_dtype, rounded in ((torch.bfloat16, True), (torch.float32, False)):
        x = torch.randn(g.n_src, 128, device=dev, generator=gen).to(x_dtype)
        wide.update(sp.launch_segment_sum(g.row_ptr, g.src, g.val, x, rounded)
                    .cpu().numpy().tobytes())
    print(f"  digest of two wide launches at d = 128 (bf16 and f32 x): "
          f"{wide.hexdigest()[:16]}")
    return dict(name="segment_sum narrow path (GCMC, f32, d = 50)",
                route="cuda", source="dream_gnn_tpu_torch/kernels/csrc/spmm.cu",
                launches=narrow["launches"],
                split_launches=narrow["split_launches"], step_split=step_split,
                max_abs_err=worst, ms=total,
                plain_ms=sum(x["plain_ms"] for x in rows), bound_ms=bound,
                bound_by="bytes", library_ms=sum(libs),
                library="torch.sparse.mm on the CSR in f32")


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
    launches, ms_grid = phase_trainer()
    launches_b = phase_trainer_stacked()
    launches_e = phase_trainer_edges()
    launches_eb, ms_edges = phase_trainer_edges_stacked()
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
    torch.cuda.empty_cache()
    tooling = {".mat": phase_mat_path(), "resume": phase_resume(),
               **{f"novel {k}": v for k, v in phase_novel().items()}}
    phase_profile_dir()
    phase_chained_ms()
    phase_six_augment_methods(gpu, {"grid": ms_grid, "edges": ms_edges})
    phase_sharded(gpu)
    mesh = phase_mesh(gpu)
    bilinear, narrow = phase_bilinear()
    narrow = phase_gcmc_segment_sums(narrow)
    print("  launches of rows 1, 3, 4 and 5 on the tooling paths: "
          + "; ".join(f"{k}: row 1 {v['grid']['fwd']}, row 3 "
                      f"{v['grid']['fwd_b']}, row 4 {v['grid']['bwd_b']}, "
                      f"row 5 {v['edge']['fwd']}"
                      for k, v in tooling.items()))
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
    # A rank's launches on the 2 x 2 mesh's paths of phase 31: rows 1 and 2
    # through the 2-D grid decoder, rows 3-4 and 7-8 in its three steps.
    for i, n in ((0, mesh["spmd2d"]["fwd"]), (1, mesh["spmd2d"]["bwd"]),
                 (2, mesh["grid"]["fwd_b"]), (3, mesh["grid"]["bwd_b"]),
                 (6, mesh["edges"]["fwd_b"]), (7, mesh["edges"]["bwd_b"])):
        rows[i]["mesh_launches"] = n
    for row in rows:
        row.setdefault("mesh_launches", 0)
    if len(rows) != 15:
        raise AssertionError(f"the kernel table has {len(rows)} rows, not 15")
    print(gpu)
    print(json.dumps({"kernels": rows, "port_only": [bilinear],
                      "narrow_segment_sum": narrow}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
