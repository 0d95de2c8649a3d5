"""Kernel timing with a floor guard, and the H100 bounds of the port's
kernels.

Port of ``dream_gnn_tpu/utils/timing.py``.  Two rules hold for every
kernel time the port publishes:

1. **Amortised chained calls.**  ``chained_ms`` runs N calls of the
   function in a chain (call k+1's input is perturbed by a scalar read
   from call k's output, so no call can be skipped, cached or reordered)
   and times the chain with CUDA events; per call = (T_N - T_1) / (N - 1),
   so the constant cost of starting and ending a chain cancels.  Best of
   ``reps`` chains, each on its own input buffer.  On the CPU (a CPU
   tensor) the host clock takes the events' place.
2. **Floor guard.**  The caller states the least time the card could take
   for the call, and ``chained_ms`` refuses a reading below it: an
   instrument that reads faster than the hardware is broken, not fast.

The bounds are the larger of the bytes a call must move (each input read
once, each output written once) over the H100's memory rate and the
operations it does over the peak rate for their dtype, at NVIDIA's
published H100 SXM peaks.  The JAX module's TPU v5e rates and its panel
bytes (the TPU kernels' geometry) do not carry over.  ``chip_smoke.py``
takes its bounds from here.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from dream_gnn_tpu_torch.kernels.grid_decoder import H1, H2

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Operations per candidate slot of the scale decoder's kernels: forward (K2):
# the a2 product, a1 and the logit dot; B1: the recomputed forward, the dh1
# and dW2 products, g * w3 and the db2, dw3, db1 sums; the mirror: the
# recomputed forward, the dh1 product, g * w3 and the da1 mask.
OPS_K2 = 2 * H1 * H2 + 2 * H1 + 2 * H2
OPS_B1 = OPS_K2 + 2 * (2 * H1 * H2) + 4 * H2 + 3 * H1
OPS_MIRROR = OPS_K2 + 2 * H1 * H2 + 2 * H2 + H1


class ImplausibleTiming(RuntimeError):
    """A measured time beat its floor: the measurement is wrong."""


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of ``nbytes`` over
    the memory rate and ``flops`` over the peak for ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decoder_flops(fwd: bool, cells: int, nf: int = 1) -> int:
    """Operations of the grid or per-edge decoder MLP over ``cells`` grid
    cells or edges per fold, forward or backward."""
    per_cell = 2 * H1 * H2 + 2 * H1 + 2 * H2       # a2 product, a1, w3 dot
    if not fwd:
        # The recomputed forward, the dh1 and dW2 products, then g * w3,
        # the db2 and dw3 sums and the dPd, dPv and db1 sums.
        per_cell += 2 * (2 * H1 * H2) + 4 * H2 + 3 * H1
    return nf * cells * per_cell


def decoder_bound_ms(fwd: bool, dtype, nd: int, nv: int,
                     cells: Optional[int] = None, nf: int = 1,
                     index_bytes: int = 0) -> tuple:
    """(least ms, bound) of the grid decoder (``cells`` None: the nd x nv
    grid) or the per-edge decoder (``cells`` edges, whose ids are
    ``index_bytes``), over ``nf`` folds: the node tables, the weights and
    the logits (forward) or the cotangent and the gradients (backward)."""
    cells = nd * nv if cells is None else cells
    table_bytes = nf * (nd + nv) * H1 * 4
    weight_bytes = nf * (H1 + H1 * H2 + 2 * H2) * 4
    nbytes = table_bytes + weight_bytes + nf * cells * 4 + index_bytes
    if not fwd:
        nbytes += table_bytes + weight_bytes             # the gradients
    return bound_ms(nbytes, decoder_flops(fwd, cells, nf), dtype)


def chained_ms(fn: Callable, x: torch.Tensor, *, args=(), n: int = 8,
               reps: int = 3, floor_ms: Optional[float] = None,
               name: str = "", verbose: bool = False) -> float:
    """Per-call milliseconds of ``fn(x, *args)`` by amortised chained calls
    (see the module's docstring).  ``fn`` returns a tensor, and its cost
    must not depend on the tiny perturbation of ``x`` (a float tensor).  Raises
    ``ImplausibleTiming`` if the reading is below ``floor_ms``."""
    if n < 2:
        raise ValueError("need n >= 2 chain links to amortise")
    cuda = x.device.type == "cuda"

    def chain(xi, links: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        s = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(links):
            out = fn(xi + (s * 1e-30).to(xi.dtype), *args)
            s = out.reshape(-1)[0].float()
        if cuda:
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop)
        float(s)
        return (time.perf_counter() - t0) * 1e3

    # A buffer of its own for each repeat and one more for the warm-up.
    xs = [x * (1.0 + 1e-6 * (i + 1)) for i in range(reps + 1)]
    warm, xs = xs[-1], xs[:-1]
    chain(warm, 1)
    chain(warm, n)
    t1 = min(chain(xi, 1) for xi in xs)
    tn = min(chain(xi, n) for xi in xs)
    ms = (tn - t1) / (n - 1)
    if verbose:
        print(f"  [chained {name}] T_1={t1:.4f} ms T_{n}={tn:.4f} ms -> "
              f"{ms:.4f} ms/call", flush=True)
    if floor_ms is not None and ms < floor_ms:
        raise ImplausibleTiming(
            f"{name or 'kernel'}: measured {ms:.5f} ms a call, below the "
            f"floor {floor_ms:.5f} ms; the measurement (not the kernel) is "
            f"broken, so it is not reported")
    return ms
