"""The grouped layout's SpMM: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_spmm_gather_kernel`` of
``dream_gnn_tpu/kernels/pallas_spmm_gather.py`` (``spmm_gather``,
``_spmm_gather_raw``)::

    out[n] = sum over the edges e into dst row n of val_e * x[src_e]

over one direction of a relation (graph/grouped.py: a dst-sorted CSR).  It
serves the grouped encoder (nn/gcmc.py) and, as ``spmm_gather_raw``, the
scale decoder's table-gradient scatter when its layout is built without
the sequential scatter (kernels/scale_decoder.py, ``build_seq=False``).  The
backward of ``spmm_gather`` runs the same kernel over the transposed layout
(``pair.bwd``); edge values get no gradient (pallas_spmm_gather.py:369-391).

Rounding, as the Pallas kernel rounds (sums in f32):
- bf16 with packed panels (the default for an even d): x is packed to bf16
  and val stays f32, so each message is rnd(rnd(x) * val)
  (pallas_spmm_gather.py:313-327 and 270-272);
- bf16 without packing (an odd d, or ``packed=False``): the f32 panel times
  val, rounded: rnd(x * val);
- fp32 with ``packed=True``: x rounded to bf16, messages x * val in f32
  (tests/test_pallas_spmm_gather.py:68-80);
- fp32: x * val in f32.
The model calls it with its default bf16 dtype whatever the compute dtype
(nn/gcmc.py:224-225 of the JAX package).

``group_batch`` is TPU geometry (groups per scatter matmul): it is accepted
and validated against the layout's ``gpc`` as the Pallas kernel does
(:299-310), and changes nothing.  The Pallas function's measurement-only
``_ablate`` modes (:292-298), a TPU probe whose outputs are wrong by
design, are not ported.

The kernel is the segmented row sum of ``csrc/spmm.cu`` (one warp per dst
row, sums in a fixed order, no atomics, the same bits from run to run), in the
rounding mode above.  Dispatch: CUDA tensors launch the kernel, CPU tensors
run the plain version; there is no fallback.  ``LAUNCHES`` counts the
kernel's launches: ``fwd`` over ``pair.fwd``, ``bwd`` over ``pair.bwd``,
``raw`` by direct calls of ``spmm_gather_raw``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.grouped import GroupedCoo, GroupedCooPair
from dream_gnn_tpu_torch.kernels.spmm_slab import (launch_segment_sum,
                                                    segment_sum_plain)

LAUNCHES = {"fwd": 0, "bwd": 0, "raw": 0}

GROUP_BATCH = 16      # the Pallas kernel's default groups per scatter matmul
PACK_PANELS = True    # bf16 packed panels by default in bf16 mode


def _prepare(g: GroupedCoo, x: torch.Tensor, dtype, group_batch, packed):
    """Checks the call as the Pallas wrapper does (:299-315); returns x as
    the kernel reads it (bf16 with packed panels, else f32), whether the
    messages are rounded, and whether x is."""
    if x.dim() != 2 or x.shape[0] != g.n_src:
        raise ValueError(f"spmm_gather: x must be ({g.n_src}, d), got "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm_gather: dtype {dtype} unsupported")
    gpc = g.gpc
    gb = min(GROUP_BATCH, gpc) if group_batch is None else group_batch
    if gb > gpc:
        raise ValueError(f"group_batch {gb} > layout gpc {gpc}")
    if gpc % gb:
        raise ValueError(f"group_batch {gb} must divide gpc {gpc}")
    if packed is None:
        packed = PACK_PANELS and dtype == torch.bfloat16
    packed = packed and x.shape[1] % 2 == 0
    xk = x.to(torch.bfloat16 if packed else torch.float32).contiguous()
    return xk, dtype == torch.bfloat16, packed


def spmm_gather_plain(g: GroupedCoo, x: torch.Tensor, dtype=torch.bfloat16,
                      group_batch: Optional[int] = None,
                      packed: Optional[bool] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch on x's device: what
    ``spmm_gather_raw`` runs for a CPU tensor."""
    xk, rounded, packed = _prepare(g, x, dtype, group_batch, packed)
    return segment_sum_plain(g.row_ptr, g.src, g.val, xk, rounded,
                             round_x=packed)


def _gather(g: GroupedCoo, x: torch.Tensor, dtype, group_batch, packed,
            kind: str) -> torch.Tensor:
    if not x.is_cuda:
        return spmm_gather_plain(g, x, dtype, group_batch, packed)
    xk, rounded, packed = _prepare(g, x, dtype, group_batch, packed)
    out = launch_segment_sum(g.row_ptr, g.src, g.val, xk, rounded,
                             round_x=packed)
    LAUNCHES[kind] += 1
    return out


def spmm_gather_raw(g: GroupedCoo, x: torch.Tensor, dtype=torch.bfloat16,
                    group_batch: Optional[int] = None,
                    packed: Optional[bool] = None) -> torch.Tensor:
    """(g.n_dst, d) f32 SpMM of x (g.n_src, d) over one grouped layout, the
    contract of the JAX ``_spmm_gather_raw`` (pallas_spmm_gather.py:287)."""
    return _gather(g, x, dtype, group_batch, packed, "raw")


class _SpmmGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair, dtype):
        ctx.pair, ctx.dtype = pair, dtype
        return _gather(pair.fwd, x, dtype, None, None, "fwd")

    @staticmethod
    def backward(ctx, gout):
        return (_gather(ctx.pair.bwd, gout, ctx.dtype, None, None, "bwd"),
                None, None)


def spmm_gather(pair: GroupedCooPair, x: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable SpMM over a relation's grouped layout pair, the
    contract of the JAX ``spmm_gather`` (pallas_spmm_gather.py:370): x
    (n_src, d) -> (n_dst, d) f32; its gradient runs over ``pair.bwd``."""
    return _SpmmGather.apply(x, pair, dtype)
