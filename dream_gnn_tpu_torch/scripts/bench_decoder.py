"""The grid and per-edge decoder kernels at Gdataset width, for comparing
two checkouts of the port on one card: each forward's time in bf16 and in
fp32, and a digest of every kernel output at fixed inputs.

    python -m dream_gnn_tpu_torch.scripts.bench_decoder
    PYTHONPATH=<other checkout> python <this file>

The second form runs the other checkout's kernels with this script.  The
inputs are chip_smoke.py's: random Gdataset-sized tables and weights
(``default_rng(0)``) over the 593 x 313 grid, or over fold 0's train list
(167,168 edges); one fold, and the 10 folds of seed 0 stacked; dropout 0.3
in training.  A time is the mean of 20 launches after 3 warm-ups (CUDA
events), with the operations of the forward (16,768 a cell or edge) over
it.  A digest is the first 16 hex digits of the sha256 of an output's
bytes, for the logits and the six gradients of every kernel in both
dtypes: two checkouts whose kernels do the same arithmetic in the same
order print the same digests.  The card's name and power limit come
first.
"""

from __future__ import annotations

import hashlib
import subprocess

import numpy as np
import torch

ND, NV, NF = 593, 313, 10
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
    return edges, inputs.dec_csr, g


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
    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()[:16]


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
        edges, csr, g = _edges(ds, nf)
        args = args[:6] + [edges, args[6]]
        fwd, bwd = (ed.launch_fwd, ed.launch_bwd) if nf is None \
            else (ed.launch_fwd_batched, ed.launch_bwd_batched)
        _report(f"edge F={nf or 1} E={edges.shape[-1]}",
                lambda d: fwd(*args, rate, True, d),
                lambda d: bwd(*args, rate, True, d, g, csr),
                (nf or 1) * edges.shape[-1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
