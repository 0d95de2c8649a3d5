"""The blocked layout's SpMM: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_spmm_kernel`` of
``dream_gnn_tpu/kernels/pallas_spmm.py`` (``spmm_blocked``,
``_spmm_blocked_raw``)::

    out[n] = sum over the edges e into dst row n of val_e * x[src_e]

over one direction of a relation (graph/blocked.py: a dst-sorted CSR).  The
backward of ``spmm_blocked`` runs the same kernel over the transposed
layout (``pair.bwd``); edge values get no gradient (pallas_spmm.py:122-146).

Rounding, as the Pallas kernel rounds (sums in f32).  In bf16 the weight
rides the gather one-hot, which is cast to bf16 with x (pallas_spmm.py:73,
78-79), and the gathered message is cast again for the scatter matmul: each
message is rnd(rnd(val) * rnd(x)).  That rounds val, which the grouped SpMM
(kernels/spmm_gather.py) does not; with weights other than powers of two
the results differ.  In fp32 each message is val * x.

The kernel is the segmented row sum of ``csrc/spmm.cu`` in its
``MODE_RX_RV`` rounding (val rounded in the kernel, as it loads it).
Dispatch: CUDA tensors launch the kernel, CPU tensors run the plain
version; there is no fallback.  ``LAUNCHES`` counts the kernel's launches:
``fwd`` over ``pair.fwd``, ``bwd`` over ``pair.bwd``, ``raw`` by direct
calls of ``spmm_blocked_raw``.
"""

from __future__ import annotations

import torch

from dream_gnn_tpu_torch.graph.blocked import BlockedCoo, BlockedCooPair
from dream_gnn_tpu_torch.kernels.spmm_slab import (launch_segment_sum,
                                                    segment_sum_plain)

LAUNCHES = {"fwd": 0, "bwd": 0, "raw": 0}


def _prepare(g: BlockedCoo, x: torch.Tensor, dtype) -> torch.Tensor:
    """Checks the call; returns x in ``dtype``, as the kernel reads it."""
    if x.dim() != 2 or x.shape[0] != g.n_src:
        raise ValueError(f"spmm_blocked: x must be ({g.n_src}, d), got "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm_blocked: dtype {dtype} unsupported")
    return x.to(dtype).contiguous()


def spmm_blocked_plain(g: BlockedCoo, x: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch on x's device: what
    ``spmm_blocked_raw`` runs for a CPU tensor."""
    rounded = dtype == torch.bfloat16
    return segment_sum_plain(g.row_ptr, g.src, g.val, _prepare(g, x, dtype),
                             rounded, round_val=rounded)


def _blocked(g: BlockedCoo, x: torch.Tensor, dtype, kind: str):
    if not x.is_cuda:
        return spmm_blocked_plain(g, x, dtype)
    rounded = dtype == torch.bfloat16
    out = launch_segment_sum(g.row_ptr, g.src, g.val, _prepare(g, x, dtype),
                             rounded, round_val=rounded)
    LAUNCHES[kind] += 1
    return out


def spmm_blocked_raw(g: BlockedCoo, x: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(g.n_dst, d) f32 SpMM of x (g.n_src, d) over one blocked layout, the
    contract of the JAX ``_spmm_blocked_raw`` (pallas_spmm.py:90)."""
    return _blocked(g, x, dtype, "raw")


class _SpmmBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair, dtype):
        ctx.pair, ctx.dtype = pair, dtype
        return _blocked(pair.fwd, x, dtype, "fwd")

    @staticmethod
    def backward(ctx, gout):
        return _blocked(ctx.pair.bwd, gout, ctx.dtype, "bwd"), None, None


def spmm_blocked(pair: BlockedCooPair, x: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable SpMM over a relation's blocked layout pair, the
    contract of the JAX ``spmm_blocked`` (pallas_spmm.py:123): x (n_src, d)
    -> (n_dst, d) f32; its gradient runs over ``pair.bwd``."""
    return _SpmmBlocked.apply(x, pair, dtype)
