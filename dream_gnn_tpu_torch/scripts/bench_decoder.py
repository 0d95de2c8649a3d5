"""The decoder kernels, for comparing two checkouts of the port on one
card: the grid and per-edge decoders at Gdataset width and the scale
decoder at its 1M-slot shape; each forward's time in bf16 and in fp32, and
a digest of every kernel output at fixed inputs.

    python -m dream_gnn_tpu_torch.scripts.bench_decoder
    PYTHONPATH=<other checkout> python <this file>

The second form runs the other checkout's kernels with this script.  The
inputs are chip_smoke.py's: random Gdataset-sized tables and weights
(``default_rng(0)``) over the 593 x 313 grid, or over fold 0's train list
(167,168 edges); one fold, and the 10 folds of seed 0 stacked; dropout 0.3
in training.  The scale decoder runs on chip_smoke.py's 100k-row tables
and weights (``default_rng(2)``) over 1M random candidates, dropout 0.3:
K2 in training (a1 spilled) and in eval (no dropout, no spill), then B1
from the training spill and the mirror.  A time is the mean of 20 launches
after 3 warm-ups (CUDA events), with the operations of the forward (16,768
a cell, edge or slot) over it.  A digest is the first 16 hex digits of the
sha256 of an output's bytes, for the logits and the six gradients of every
grid and per-edge kernel, and for K2's training logits and spill, its eval
logits, B1's five outputs and the mirror's da1, in both dtypes: two
checkouts whose kernels do the same arithmetic in the same order print the
same digests.  The card's name and power limit come first.
"""

from __future__ import annotations

import hashlib
import subprocess

import numpy as np
import torch

ND, NV, NF = 593, 313, 10
SCALE_N, SCALE_E = 100_000, 1_000_000   # the scale decoder's tables, slots
FWD_OPS = 2 * 128 * 64 + 2 * 128 + 2 * 64      # a cell's forward operations
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _inputs(dev, nf):
    """chip_smoke.py's decoder inputs: (kernel args, g over the grid)."""
    rng = np.random.default_rng(0)
    lead = () if nf is None else (nf,)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    args = [t(rng.normal(0, 0.5, (*lead, ND, 128))),
            t(rng.normal(0, 0.5, (*lead, NV, 128))),
            t(rng.uniform(-0.06, 0.06, (*lead, 128))),
            t(rng.uniform(-0.09, 0.09, (*lead, 128, 64))),
            t(rng.uniform(-0.09, 0.09, (*lead, 64))),
            t(rng.uniform(-0.12, 0.12, (*lead, 64)))]
    g = t(rng.normal(0, 1e-3, (*lead, ND, NV)))
    seed = torch.tensor([918273] if nf is None
                        else rng.integers(0, 2 ** 31 - 1, nf),
                        dtype=torch.int32, device=dev)
    return args + [seed], g


def _edges(ds, nf):
    """Fold 0's train list, or the stacked lists of folds 0 .. nf-1, and a
    cotangent that is 0 on padding."""
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import fold_inputs

    if nf is None:
        inputs, _, _, _ = fold_inputs(ds, 0)
        w = ds.fold(0).train_w
    else:
        stacked = stack_folds(ds, list(range(nf)))
        inputs, w = stacked.inputs, stacked.edge_weight
    edges = torch.stack([inputs.dec_src, inputs.dec_dst], dim=-2).contiguous()
    rng = np.random.default_rng(1)
    g = torch.tensor(rng.normal(0, 1e-3, tuple(w.shape)).astype(np.float32),
                     device=ds.device) * w
    return edges, inputs.dec_order, g


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


def _digest(x: torch.Tensor) -> str:
    raw = x.detach().contiguous().cpu().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _report(label, fwd, bwd, cells):
    """Times of ``fwd(dtype)`` in both dtypes, and the digests of its
    logits and of ``bwd(dtype)``'s gradients."""
    for name, dtype in DTYPES.items():
        ms = _time_ms(lambda: fwd(dtype))
        out = [fwd(dtype), *bwd(dtype)]
        torch.cuda.synchronize()
        print(f"{label} {name}: fwd {ms:.4f} ms, "
              f"{cells * FWD_OPS / ms / 1e9:.2f} TFLOP/s; digests fwd "
              f"{_digest(out[0])} bwd "
              + " ".join(_digest(x) for x in out[1:]), flush=True)


def _scale(dev, rate=0.3):
    """K2's times in training and in eval, and the digests of K2, B1 and the
    mirror, in both dtypes, at the scale decoder's 1M-slot shape."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    rng = np.random.default_rng(2)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    pd = t(rng.normal(0, 0.5, (SCALE_N, 128)))
    pv = t(rng.normal(0, 0.5, (SCALE_N, 128)))
    b1, w2 = t(rng.uniform(-.06, .06, 128)), t(rng.uniform(-.09, .09,
                                                             (128, 64)))
    b2, w3 = t(rng.uniform(-.09, .09, 64)), t(rng.uniform(-.12, .12, 64))
    seed = torch.tensor([918273], dtype=torch.int32, device=dev)
    layout = sd.build_scale_decoder_layout(
        rng.integers(0, SCALE_N, SCALE_E), rng.integers(0, SCALE_N, SCALE_E),
        SCALE_N, SCALE_N, build_seq=False, device=dev)
    g = t(rng.normal(0, 1e-3, SCALE_E))
    g_m = g[layout.gout_perm.long()]
    fwd = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
    for name, dtype in DTYPES.items():
        def k2(train, dtype=dtype):
            return sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, rate,
                                train, dtype, train)

        ms = {train: _time_ms(lambda: k2(train)) for train in (True, False)}
        out, a1 = k2(True)
        common = (w2, b2, w3, seed, rate, True, dtype)
        outs = [out, a1, k2(False)[0],
                *sd.launch_b1(a1, pd, pv, layout, g, b1, *common),
                sd.launch_mirror(pd, pv, layout, g_m, b1, *common)]
        torch.cuda.synchronize()
        rates = ", ".join(f"{'train' if tr else 'eval'} {ms[tr]:.4f} ms "
                          f"{SCALE_E * FWD_OPS / ms[tr] / 1e9:.2f} TFLOP/s"
                          for tr in (True, False))
        print(f"scale E={SCALE_E} {name}: K2 {rates}; digests k2 "
              + " ".join(_digest(x) for x in outs[:3]) + " b1 "
              + " ".join(_digest(x) for x in outs[3:8]) + " mirror "
              + _digest(outs[8]), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_decoder: no CUDA device")
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.kernels import edge_decoder as ed
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    rate = 0.3
    for nf in (None, NF):
        args, g = _inputs(dev, nf)
        fwd, bwd = (gd.launch_fwd, gd.launch_bwd) if nf is None \
            else (gd.launch_fwd_batched, gd.launch_bwd_batched)
        _report(f"grid F={nf or 1}",
                lambda d: fwd(*args, rate, True, d),
                lambda d: bwd(*args, rate, True, d, g), (nf or 1) * ND * NV)
    ds = DreamDataset.load("Gdataset", device=dev)
    for nf in (None, NF):
        args, _ = _inputs(dev, nf)
        edges, order, g = _edges(ds, nf)
        args = args[:6] + [edges, args[6]]
        fwd, bwd = (ed.launch_fwd, ed.launch_bwd) if nf is None \
            else (ed.launch_fwd_batched, ed.launch_bwd_batched)
        _report(f"edge F={nf or 1} E={edges.shape[-1]}",
                lambda d: fwd(*args, rate, True, d),
                lambda d: bwd(*args, rate, True, d, g, order),
                (nf or 1) * edges.shape[-1])
    del ds
    torch.cuda.empty_cache()
    _scale(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
