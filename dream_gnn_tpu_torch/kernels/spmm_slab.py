"""The scale path's encoder SpMM: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_slab_kernel`` of
``dream_gnn_tpu/kernels/pallas_spmm_slab.py`` (``spmm_slab``)::

    out[n] = sum over the edges e into dst row n of val_e * x[src_e]

over one direction of a relation (graph/slabbed.py: a dst-sorted CSR).  The
backward runs the same kernel over the transposed layout (``pair.bwd``);
edge values get no gradient (pallas_spmm_slab.py:244-266).

Rounding.  The Pallas kernel packs x into bf16 panels, and the model calls
it with its default ``dtype=bfloat16`` whatever the compute dtype
(nn/gcmc.py:204-205 of the JAX package), so the encoder's messages are
bf16 even in an fp32 model: in bf16 mode each message is rnd(rnd(x) * val)
and the backward rounds its cotangent the same way; the sums are f32.  The
wrapper rounds x once to bf16, which also halves the bytes the kernel
gathers.  ``dtype=float32`` keeps everything in f32.

The kernel (``csrc/spmm.cu``, shared with kernels/seq_scatter.py,
kernels/spmm_gather.py and kernels/spmm_blocked.py) is a segmented row
sum in two paths chosen by the width d.  When d % 8 == 0 one warp sums a
dst row: its lane groups sum the row's edges in a fixed interleaved order
and combine their partial sums by shuffles.  Otherwise (GCMC's float32
rows of 50) one warp sums a piece of a row, at most ``graph/csr.py:PIECE``
consecutive entries, in list order and in one pass over them: a row's
first piece writes its output, and each further piece of a longer row a
partial row, which a second launch adds to the output in piece order.
The pieces come with the layout (``CsrLayout.pieces``,
``SeqScatter.pieces``), built once with torch ops on the device, so that a
launch does no host work for them.  Neither path uses atomics, so two runs
give the same bits.
The f32 sum runs in another order than the plain version's
``index_add_``; the tolerance of the tests (1e-4 relative) covers that.

Dispatch.  ``spmm_slab`` launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors; there is no fallback from one to the
other.  ``LAUNCHES`` counts the kernel's launches: ``fwd`` over
``pair.fwd``, ``bwd`` over ``pair.bwd``.  ``NARROW`` counts every launch of
the narrow path (``launches``), those with a split row
(``split_launches``), and the rows split and their pieces summed over the
launches (``split_rows``, ``split_pieces``), from the sizes the pieces
carry: reading it costs no sync.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.csr import SegmentPieces
from dream_gnn_tpu_torch.graph.slabbed import SlabbedCoo, SlabbedCooPair
from dream_gnn_tpu_torch.kernels import cuda_build
from dream_gnn_tpu_torch.kernels.grid_decoder import round_to, stream_ptr
from dream_gnn_tpu_torch.utils.profiling import span

LAUNCHES = {"fwd": 0, "bwd": 0}
NARROW = {"launches": 0, "split_launches": 0, "split_rows": 0,
          "split_pieces": 0}

_lib = None


def rounding_mode(rounded: bool, round_x: bool = True,
                  round_val: bool = False) -> int:
    """The kernel's ``mode`` (``enum Mode`` of csrc/spmm.cu): with
    ``rounded`` each message is rounded to bf16, after rounding x when
    ``round_x`` and val when ``round_val``; without, x * val in f32."""
    if not rounded:
        return 0
    if round_val:
        if not round_x:
            raise ValueError("the segment sum rounds val only with x")
        return 3
    return 1 if round_x else 2


def segment_sum_plain(ptr: torch.Tensor, src: Optional[torch.Tensor],
                      val: Optional[torch.Tensor], x: torch.Tensor,
                      rounded: bool, round_x: bool = True,
                      round_val: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (n_rows, d) f32 sums over
    the CSR ``ptr``; entry p reads row ``src[p]`` of x, or row p when
    ``src`` is None, with weight ``val[p]``, or 1 when ``val`` is None.
    ``rounded`` rounds each message to bf16: rnd(rnd(x) * val), or
    rnd(x * val) without ``round_x``, or rnd(rnd(x) * rnd(val)) with
    ``round_val``."""
    with span("segment_sum"):
        rounding_mode(rounded, round_x, round_val)
        n_rows = ptr.shape[0] - 1
        counts = (ptr[1:] - ptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=x.device), counts)
        xs = x[src.long()] if src is not None else x[:rows.shape[0]]
        xs = xs.float()
        dtype = torch.bfloat16 if rounded else torch.float32
        msg = round_to(xs, dtype) if round_x else xs
        if val is not None:
            v = round_to(val, dtype) if round_val else val
            msg = msg * v[:, None]
        msg = round_to(msg, dtype)
        out = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        return out.index_add_(0, rows, msg)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum.argtypes = [p] * 5 + [i] * 4 + [p, p, i, p, p, i, i,
                                                        p, p]
        lib.segment_sum.restype = i
        _lib = lib
    return _lib


def _check(x, name, dtypes, shape, dev):
    if x.device != dev or x.dtype not in dtypes or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"segment sum kernel: {name} must be a contiguous "
                         f"{'/'.join(str(d) for d in dtypes)} {shape} tensor "
                         f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def launch_segment_sum(ptr: torch.Tensor, src: Optional[torch.Tensor],
                       val: Optional[torch.Tensor], x: torch.Tensor,
                       rounded: bool, round_x: bool = True,
                       round_val: bool = False,
                       pieces: Optional[SegmentPieces] = None) -> torch.Tensor:
    """One launch of the kernel of ``csrc/spmm.cu`` on CUDA tensors: ptr
    (n_rows + 1,) int32, src (nnz,) int32 or None, val (nnz,) f32 or None
    (weight 1), x (rows, d) bf16 or f32; the rounding as in
    ``segment_sum_plain``.  Returns (n_rows, d) f32.  The callers count
    it.  When d % 8 == 0 the kernel reads x in 16-byte loads, so an x that
    does not start 16-byte aligned (a view at an odd offset) is copied
    first: how a row is split and summed depends on d only.  Otherwise it
    sums ``pieces``, those of ptr's rows (``graph/csr.py:segment_pieces``
    of ptr), which it then needs, and counts the launch in ``NARROW``."""
    with span("segment_sum"):
        mode = rounding_mode(rounded, round_x, round_val)
        dev = x.device
        nnz = (src if src is not None else val if val is not None
               else x).shape[0]
        n_rows, d = ptr.shape[0] - 1, x.shape[-1]
        _check(ptr, "ptr", (torch.int32,), (n_rows + 1,), dev)
        if val is not None:
            _check(val, "val", (torch.float32,), (nnz,), dev)
        if src is not None:
            _check(src, "src", (torch.int32,), (nnz,), dev)
        elif x.shape[0] < nnz:
            raise ValueError("segment sum kernel: x has fewer rows than "
                             "entries")
        _check(x, "x", (torch.float32, torch.bfloat16), (x.shape[0], d), dev)
        pc, args = None, _NO_PIECES
        if d % 8 == 0:
            if x.data_ptr() % 16 != 0:
                x = x.clone()
        else:
            pc = pieces
            # Without src and val, nnz is x's rows: the entries at most.
            off = pc is not None and (
                pc.nnz > nnz if src is None and val is None else
                pc.nnz != nnz)
            if pc is None or pc.n_rows != n_rows or off:
                raise ValueError(
                    f"segment sum kernel: a width of {d} needs the pieces of "
                    f"ptr's {n_rows} rows and {nnz} entries "
                    f"(graph/csr.py:segment_pieces), got "
                    f"{None if pc is None else (pc.n_rows, pc.nnz)}")
            # The split rows' partial rows, (n_extra, d) f32.
            part = torch.empty((pc.n_extra, d), dtype=torch.float32,
                               device=dev) if pc.n_extra else None
            args = pc.c_args + (None if part is None else part.data_ptr(),)
        lib = _load()
        out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
        err = lib.segment_sum(ptr.data_ptr(),
                              src.data_ptr() if src is not None else None,
                              val.data_ptr() if val is not None else None,
                              x.data_ptr(), out.data_ptr(),
                              n_rows, d, int(x.dtype == torch.bfloat16), mode,
                              *args, stream_ptr(dev))
        if err != 0:
            raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
        if pc is not None:
            NARROW["launches"] += 1
            NARROW["split_launches"] += pc.n_split > 0
            NARROW["split_rows"] += pc.n_split
            NARROW["split_pieces"] += pc.n_split + pc.n_extra
        return out


# The entry point's piece arguments of a launch on the wide path.
_NO_PIECES = (None, None, 0, None, None, 0, 0, None)


def spmm_csr(g: SlabbedCoo, x: torch.Tensor, dtype=torch.bfloat16,
             kind: str = "fwd") -> torch.Tensor:
    """(g.n_dst, d) f32 aggregation of x (g.n_src, d) over one layout:
    the kernel for CUDA tensors (counted under ``kind``), the plain
    version for CPU tensors."""
    if x.dim() != 2 or x.shape[0] != g.n_src:
        raise ValueError(f"spmm_slab: x must be ({g.n_src}, d), got "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm_slab: dtype {dtype} unsupported")
    rounded = dtype == torch.bfloat16
    x = x.to(dtype).contiguous()
    if x.is_cuda:
        out = launch_segment_sum(g.row_ptr, g.src, g.val, x, rounded,
                                 pieces=g.pieces)
        LAUNCHES[kind] += 1
        return out
    return segment_sum_plain(g.row_ptr, g.src, g.val, x, rounded)


class _SpmmSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pair, dtype):
        ctx.pair, ctx.dtype = pair, dtype
        return spmm_csr(pair.fwd, x, dtype, "fwd")

    @staticmethod
    def backward(ctx, gout):
        return spmm_csr(ctx.pair.bwd, gout, ctx.dtype, "bwd"), None, None


def spmm_slab(pair: SlabbedCooPair, x: torch.Tensor,
              dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable SpMM over a relation's layout pair, the contract of
    the JAX ``spmm_slab`` (pallas_spmm_slab.py:245): x (n_src, d) ->
    (n_dst, d) f32; its gradient runs over ``pair.bwd``."""
    return _SpmmSlab.apply(x, pair, dtype)
