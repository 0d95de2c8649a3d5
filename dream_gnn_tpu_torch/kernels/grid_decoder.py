"""Fused dense-grid MLP decoder: a hand-written CUDA kernel and its plain
PyTorch version, for one fold or a stack of F folds.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel``
(``fused_grid_decoder``) and ``_fwd_kernel_b`` / ``_bwd_kernel_b``
(``fused_grid_decoder_batched``) of
``dream_gnn_tpu/kernels/pallas_grid_decoder.py``.  For every (drug i,
disease j) cell of the grid, of every fold, it computes

    a1 = Pd[i] + Pv[j] + b1;        h1d = relu(a1) * m1
    a2 = rnd(h1d) @ rnd(w2) + b2;   h2d = relu(a2) * m2
    out[i, j] = h2d . w3            (without b3; the caller adds it)

where ``rnd`` rounds to bf16 when ``dtype`` is bf16 (products accumulate
in f32), at the same points as the Pallas kernels
(pallas_grid_decoder.py:91-92 forward, :158-168 backward).

Dropout masks.  The TPU kernels seed the on-core PRNG per tile; no GPU
reproduces those bits.  Here a mask is a stateless function of
``(seed, layer, i, j, k)``, with ``layer`` 1 or 2 and ``k`` the unit, in
uint32 arithmetic::

    fmix32(x) = murmur3 finaliser (augment/masks.py:92-110 of the JAX package)
    bits      = fmix32(fmix32(fmix32(fmix32(seed ^ layer) ^ i) ^ j) ^ k)
    keep      = bits >= uint32(rate * 4294967295)
    m         = keep * float32(1 / (1 - rate))

The keep threshold and scale follow pallas_decoder.py:75-76.  The plain
version evaluates the same hash in int64 masked to 32 bits, so kernel and
plain version draw the same masks bit for bit, and the forward and the
backward kernels draw the same masks whatever their tiling.  A stack of
folds carries one seed per fold and no fold term in the hash: fold f of a
batched call draws the masks of a single-fold call with ``seed[f]``.

What bounds the kernel on an H100.  At Gdataset width (593 x 313 cells,
H1 = 128, H2 = 64) the forward does about 16.6 kFLOP per cell, about
3.1 GFLOP in all, against about 1.2 MB of traffic: operations bound it,
by a wide margin.  The backward does about three times the work.  A stack
of F folds does F times the work in one launch.  In bf16 the forward
(``grid_fwd_mma_kernel``) and the backward (``grid_bwd_mma_kernel``) run
their products on the tensor cores (``mma.sync`` bf16 -> f32, the
operands the plain version rounds to); in fp32 both run theirs on the
CUDA cores in f32, since fp32 operands would reach the tensor cores only
as TF32.  ``csrc/grid_decoder.cu`` says why and how; ``PERF.md`` carries
the measured times beside the bound.

Dispatch.  ``fused_grid_decoder`` and ``fused_grid_decoder_batched`` run
the kernel for CUDA tensors and the plain version only for CPU tensors;
there is no fallback from one to the other.  ``LAUNCHES`` counts kernel
launches: ``fwd``/``bwd`` single-fold, ``fwd_b``/``bwd_b`` batched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dream_gnn_tpu_torch.kernels import cuda_build
from dream_gnn_tpu_torch.utils import draws as rng

H1, H2 = 128, 64          # widths the CUDA kernel is built for

LAUNCHES = {"fwd": 0, "bwd": 0, "fwd_b": 0, "bwd_b": 0}

_lib = None

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Dropout hash, plain version (int64 holding uint32 values).

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_bits(seed: torch.Tensor, layer: int, i: torch.Tensor,
              j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """int64 tensor of the uint32 hash bits defined above, for int64
    ``seed``, ``i``, ``j`` and ``k`` that broadcast together."""
    x = fmix32((seed & _M32) ^ layer)
    x = fmix32(x ^ i)
    x = fmix32(x ^ j)
    return fmix32(x ^ k)


def dropout_bits(seed: torch.Tensor, layer: int, nd: int, nv: int,
                 h: int, row_base: int = 0, col_base: int = 0) -> torch.Tensor:
    """The hash bits of every grid cell: (nd, nv, h) for a seed of shape
    (1,), and (F, nd, nv, h) for one of shape (F, 1).  With bases, the
    cells are rows row_base .. row_base + nd - 1 and columns col_base ..
    col_base + nv - 1 of a larger grid: that block of its bits."""
    dev = seed.device
    i = torch.arange(row_base, row_base + nd, device=dev,
                     dtype=torch.int64).view(nd, 1, 1)
    j = torch.arange(col_base, col_base + nv, device=dev,
                     dtype=torch.int64).view(1, nv, 1)
    k = torch.arange(h, device=dev, dtype=torch.int64).view(1, 1, h)
    s = seed.reshape(*seed.shape[:-1], 1, 1, 1).to(torch.int64)
    return hash_bits(s, layer, i, j, k)


def keep_threshold(rate: float) -> int:
    """uint32 keep threshold, truncated as ``jnp.uint32(rate * (2**32-1))``."""
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_mask(seed: torch.Tensor, layer: int, nd: int, nv: int, h: int,
                 rate: float, row_base: int = 0,
                 col_base: int = 0) -> torch.Tensor:
    """f32 mask with values 0 or 1/(1-rate), shaped as ``dropout_bits``."""
    keep = dropout_bits(seed, layer, nd, nv, h, row_base,
                        col_base) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


# ---------------------------------------------------------------------------
# Plain PyTorch version.

def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to ``dtype`` and return f32 (identity for f32)."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


# The plain version is written once for an optional leading fold axis:
# tables (..., N, H1), weights (..., H1, H2), biases (..., H), the seed
# (..., 1).  Grid intermediates are (..., nd, nv, H); the per-cell products
# run over the flattened grid, (..., nd * nv, H) @ (..., H, H'), so that a
# fold's weights meet only that fold's cells.

def _cells(x):
    return x.flatten(-3, -2)


def _plain_parts(pd, pv, b1, w2, b2, seed, rate, train, dtype, bases=(0, 0)):
    """(a1, h1d, m1, a2, h2d, m2) over the whole grid, as _tile_forward;
    ``bases`` = (row_base, col_base) of the masks."""
    nd, nv = pd.shape[-2], pv.shape[-2]
    h1, h2 = w2.shape[-2:]
    use_drop = train and rate > 0.0
    a1 = (pd[..., :, None, :] + pv[..., None, :, :]) + b1[..., None, None, :]
    h1a = torch.relu(a1)
    m1 = dropout_mask(seed, 1, nd, nv, h1, rate, *bases) if use_drop \
        else None
    h1d = h1a * m1 if use_drop else h1a
    a2 = torch.matmul(_cells(round_to(h1d, dtype)), round_to(w2, dtype)) \
        .unflatten(-2, (nd, nv)) + b2[..., None, None, :]
    h2a = torch.relu(a2)
    m2 = dropout_mask(seed, 2, nd, nv, h2, rate, *bases) if use_drop \
        else None
    h2d = h2a * m2 if use_drop else h2a
    return a1, h1d, m1, a2, h2d, m2


def grid_decoder_plain(pd, pv, b1, w2, b2, w3, seed, rate: float,
                       train: bool, dtype=torch.bfloat16, row_base: int = 0,
                       col_base: int = 0) -> torch.Tensor:
    """Forward of the kernel in plain PyTorch; differentiable by autograd.
    The bases place the grid as a block of a larger one (its masks)."""
    *_, h2d, _ = _plain_parts(pd, pv, b1, w2, b2, seed, rate, train, dtype,
                              (row_base, col_base))
    return torch.sum(h2d * w3[..., None, None, :], dim=-1)


def grid_decoder_plain_bwd(pd, pv, b1, w2, b2, w3, seed, rate: float,
                           train: bool, dtype, g, row_base: int = 0,
                           col_base: int = 0):
    """Explicit backward, step for step as the Pallas ``_bwd_kernel``.
    Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    use_drop = train and rate > 0.0
    a1, h1d, m1, a2, h2d, m2 = _plain_parts(pd, pv, b1, w2, b2, seed, rate,
                                            train, dtype,
                                            (row_base, col_base))
    g = g[..., None]
    dw3 = torch.matmul(round_to(g, dtype).flatten(-3).unsqueeze(-2),
                       _cells(round_to(h2d, dtype)))[..., 0, :]
    dh2 = g * w3[..., None, None, :]
    if use_drop:
        dh2 = dh2 * m2
    da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
    dw2 = torch.matmul(_cells(round_to(h1d, dtype)).mT,
                       _cells(round_to(da2, dtype)))
    db2 = torch.sum(da2, dim=(-3, -2))
    dh1 = torch.matmul(_cells(round_to(da2, dtype)),
                       round_to(w2, dtype).mT).unflatten(-2, a1.shape[-3:-1])
    if use_drop:
        dh1 = dh1 * m1
    da1 = torch.where(a1 > 0.0, dh1, torch.zeros_like(dh1))
    return (torch.sum(da1, dim=-2), torch.sum(da1, dim=-3),
            torch.sum(da1, dim=(-3, -2)), dw2, db2, dw3)


def grid_decoder_batched_plain(pd, pv, b1, w2, b2, w3, seed, rate: float,
                               train: bool, dtype=torch.bfloat16,
                               row_base: int = 0,
                               col_base: int = 0) -> torch.Tensor:
    """Forward of the batched kernel in plain PyTorch: the single-fold
    version over a leading fold axis, fold f with ``seed[f]``."""
    return grid_decoder_plain(pd, pv, b1, w2, b2, w3, seed[:, None], rate,
                              train, dtype, row_base, col_base)


def grid_decoder_batched_plain_bwd(pd, pv, b1, w2, b2, w3, seed, rate: float,
                                   train: bool, dtype, g, row_base: int = 0,
                                   col_base: int = 0):
    """Explicit backward of the batched version, as ``_bwd_kernel_b``.
    Returns (dpd, dpv, db1, dw2, db2, dw3), each with a leading fold axis."""
    return grid_decoder_plain_bwd(pd, pv, b1, w2, b2, w3, seed[:, None], rate,
                                  train, dtype, g, row_base, col_base)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch.

def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("grid_decoder")
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        lib.grid_decoder_fwd.argtypes = [p] * 8 + [i, i, u, f, i, i, i, i, p]
        lib.grid_decoder_fwd.restype = i
        lib.grid_decoder_bwd.argtypes = [p] * 14 + [i, i, u, f, i, i, i, i,
                                                    p]
        lib.grid_decoder_bwd.restype = i
        lib.grid_decoder_bwd_layout.argtypes = [i, i, p]
        lib.grid_decoder_bwd_layout.restype = None
        lib.grid_decoder_fwd_batched.argtypes = [p] * 8 + [i, i, i, u, f, i,
                                                           i, i, i, p]
        lib.grid_decoder_fwd_batched.restype = i
        lib.grid_decoder_bwd_batched.argtypes = [p] * 14 + [i, i, i, u, f, i,
                                                            i, i, i, p]
        lib.grid_decoder_bwd_batched.restype = i
        lib.grid_decoder_bwd_layout_batched.argtypes = [i, i, i, p]
        lib.grid_decoder_bwd_layout_batched.restype = None
        for kind in ("fwd", "bwd"):
            getattr(lib, f"grid_decoder_{kind}_occupancy").argtypes = [i, p]
            getattr(lib, f"grid_decoder_{kind}_occupancy").restype = i
        _lib = lib
    return _lib


def check_inputs(pd, pv, b1, w2, b2, w3, seed, dtype, folds=(),
                 kernel="grid decoder kernel"):
    """Device, type, shape and contiguity of a decoder kernel's tables,
    weights and seeds; ``folds`` is () for a single-fold call and (F,) for
    a batched one.  Raises ValueError naming ``kernel``."""
    dev = pd.device
    nd = pd.shape[-2] if pd.dim() >= 2 else -1
    nv = pv.shape[-2] if pv.dim() >= 2 else -1
    for name, x, shape in (("proj_drug", pd, (*folds, nd, H1)),
                           ("proj_dis", pv, (*folds, nv, H1)),
                           ("b1", b1, (*folds, H1)),
                           ("w2", w2, (*folds, H1, H2)),
                           ("b2", b2, (*folds, H2)), ("w3", w3, (*folds, H2))):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a "
                             f"contiguous f32 {shape} tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    n_seeds = folds[0] if folds else 1
    if seed.device != dev or seed.dtype != torch.int32 \
            or tuple(seed.shape) != (n_seeds,):
        raise ValueError(f"{kernel}: seed must be ({n_seeds},) int32 on {dev}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: dtype {dtype} unsupported")


def stream_ptr(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def drop_args(rate, train):
    use_drop = bool(train and rate > 0.0)
    return (keep_threshold(rate) if use_drop else 0,
            keep_scale(rate) if use_drop else 1.0, int(use_drop))


def _launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, folds,
                bases):
    check_inputs(pd, pv, b1, w2, b2, w3, seed, dtype, folds)
    lib = _load()
    nd, nv = pd.shape[-2], pv.shape[-2]
    out = torch.empty((*folds, nd, nv), dtype=torch.float32,
                      device=pd.device)
    ptrs = [x.data_ptr() for x in (pd, pv, b1, w2, b2, w3, seed, out)]
    tail = (nd, nv, *drop_args(rate, train), int(dtype == torch.bfloat16),
            *bases, stream_ptr(pd.device))
    if folds:
        err = lib.grid_decoder_fwd_batched(*ptrs, folds[0], *tail)
    else:
        err = lib.grid_decoder_fwd(*ptrs, *tail)
    if err != 0:
        raise RuntimeError(f"grid_decoder_fwd{'_batched' if folds else ''} "
                           f"launch failed: CUDA error {err}")
    LAUNCHES["fwd_b" if folds else "fwd"] += 1
    return out


def _launch_bwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g, folds,
                bases):
    check_inputs(pd, pv, b1, w2, b2, w3, seed, dtype, folds)
    nd, nv = pd.shape[-2], pv.shape[-2]
    if g.device != pd.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (*folds, nd, nv) or not g.is_contiguous():
        raise ValueError("grid decoder kernel: g must be a contiguous f32 "
                         f"{(*folds, nd, nv)} tensor on {pd.device}")
    lib = _load()
    layout = (ctypes.c_int * 4)()
    if folds:
        lib.grid_decoder_bwd_layout_batched(folds[0], nd, nv,
                                            ctypes.addressof(layout))
    else:
        lib.grid_decoder_bwd_layout(nd, nv, ctypes.addressof(layout))
    n_jt, n_split, nd_pad, nv_pad = layout
    n_blk = n_split * n_jt
    kw = dict(dtype=torch.float32, device=pd.device)
    parts = [torch.empty((*folds, *shape), **kw) for shape in (
        (n_jt, nd_pad, H1), (n_split, nv_pad, H1), (n_blk, H1),
        (n_blk, H1, H2), (n_blk, H2), (n_blk, H2))]
    ptrs = [x.data_ptr() for x in (pd, pv, b1, w2, b2, w3, seed, g, *parts)]
    tail = (nd, nv, *drop_args(rate, train), int(dtype == torch.bfloat16),
            *bases, stream_ptr(pd.device))
    if folds:
        err = lib.grid_decoder_bwd_batched(*ptrs, folds[0], *tail)
    else:
        err = lib.grid_decoder_bwd(*ptrs, *tail)
    if err != 0:
        raise RuntimeError(f"grid_decoder_bwd{'_batched' if folds else ''} "
                           f"launch failed: CUDA error {err}")
    LAUNCHES["bwd_b" if folds else "bwd"] += 1
    # Sum each slab over its partial axis, in a fixed order.
    dpd, dpv, db1, dw2, db2, dw3 = (x.sum(len(folds)) for x in parts)
    return dpd[..., :nd, :], dpv[..., :nv, :], db1, dw2, db2, dw3


def occupancy(lib, name: str, dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` kernel behind the C occupancy entry
    point ``name`` of ``lib`` resident on one SM of the current card, by
    CUDA's occupancy API."""
    occ = (ctypes.c_int * 2)()
    err = getattr(lib, name)(int(dtype == torch.bfloat16),
                             ctypes.addressof(occ))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return occ[0], occ[0] * occ[1]


def fwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` forward kernel resident on one SM."""
    return occupancy(_load(), "grid_decoder_fwd_occupancy", dtype)


def bwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` backward kernel resident on one SM."""
    return occupancy(_load(), "grid_decoder_bwd_occupancy", dtype)


def launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype,
               row_base=0, col_base=0):
    """One forward kernel launch; returns (Nd, Nv) f32 without b3.  The
    bases are the grid's first global row and column, for the masks."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, (),
                       (row_base, col_base))


def launch_bwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g,
               row_base=0, col_base=0):
    """One backward kernel launch plus the sums over its partial slabs.
    Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g,
                       (), (row_base, col_base))


def launch_fwd_batched(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype,
                       row_base=0, col_base=0):
    """One batched forward launch over F folds; returns (F, Nd, Nv) f32
    without b3."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype,
                       (pd.shape[0],), (row_base, col_base))


def launch_bwd_batched(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g,
                       row_base=0, col_base=0):
    """One batched backward launch plus the sums over its partial slabs.
    Returns (dpd, dpv, db1, dw2, db2, dw3), each with a leading F."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g,
                       (pd.shape[0],), (row_base, col_base))


class _FusedGridDecoder(torch.autograd.Function):
    """One fold (``batched`` False) or a fold stack, with the bases of the
    masks."""

    @staticmethod
    def forward(ctx, pd, pv, b1, w2, b2, w3, seed, rate, train, dtype,
                batched, row_base, col_base):
        ctx.save_for_backward(pd, pv, b1, w2, b2, w3, seed)
        ctx.cfg = (rate, train, dtype)
        ctx.batched, ctx.bases = batched, (row_base, col_base)
        args = (pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, row_base,
                col_base)
        if pd.is_cuda:
            return (launch_fwd_batched if batched else launch_fwd)(*args)
        return (grid_decoder_batched_plain if batched
                else grid_decoder_plain)(*args)

    @staticmethod
    def backward(ctx, g):
        args = (*ctx.saved_tensors, *ctx.cfg, g.contiguous(), *ctx.bases)
        if g.is_cuda:
            grads = (launch_bwd_batched if ctx.batched else launch_bwd)(*args)
        else:
            grads = (grid_decoder_batched_plain_bwd if ctx.batched
                     else grid_decoder_plain_bwd)(*args)
        return (*grads,) + (None,) * 7


def fused_grid_decoder(proj_drug, proj_dis, b1, w2, b2, w3, seed,
                       rate: float, train: bool, dtype=torch.bfloat16,
                       row_base: int = 0, col_base: int = 0):
    """Grid decoder MLP, the contract of the JAX ``fused_grid_decoder``.

    proj_drug (Nd, 128) f32, proj_dis (Nv, 128) f32, b1 (128,),
    w2 (128, 64), b2 (64,), w3 (64,), seed (1,) int32 on the same device.
    Returns (Nd, Nv) f32 logits without b3.  CUDA tensors run the kernel,
    CPU tensors the plain version.  ``row_base`` and ``col_base`` place the
    grid as a block of a larger one: it draws that block's dropout masks.
    """
    return _FusedGridDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), seed, rate, train,
        dtype, False, row_base, col_base)


def fused_grid_decoder_batched(proj_drug, proj_dis, b1, w2, b2, w3, seed,
                               rate: float, train: bool,
                               dtype=torch.bfloat16, row_base: int = 0,
                               col_base: int = 0):
    """Fold-batched grid decoder MLP, the contract of the JAX
    ``fused_grid_decoder_batched`` (pallas_grid_decoder.py:489-501).

    proj_drug (F, Nd, 128), proj_dis (F, Nv, 128), b1 (F, 128),
    w2 (F, 128, 64), b2 (F, 64), w3 (F, 64), seed (F,) int32, all f32 but
    the seed, on one device.  Returns (F, Nd, Nv) f32 logits without b3.
    CUDA tensors run one kernel launch, CPU tensors the plain version.  The
    bases as ``fused_grid_decoder``'s.
    """
    return _FusedGridDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), seed, rate, train,
        dtype, True, row_base, col_base)


def node_projections(params, drug_feat, dis_feat, dtype):
    """(Pd, Pv): bf16 operands with an f32 product, as XLA's
    ``preferred_element_type=f32``.  torch's bf16 @ bf16 returns bf16,
    which would round the output, so the rounded operands are multiplied
    in f32 instead; a bf16 x bf16 product is exact in f32.  Features and
    ``w1`` may carry a leading fold axis."""
    d = drug_feat.shape[-1]
    w1 = params["w1"]
    return (torch.matmul(round_to(drug_feat, dtype),
                         round_to(w1[..., :d, :], dtype)),
            torch.matmul(round_to(dis_feat, dtype),
                         round_to(w1[..., d:, :], dtype)))


def dropout_seeds(n: int, device, rate: float, train: bool,
                  generator=None) -> torch.Tensor:
    """(n,) int32 dropout seeds: one draw from ``generator`` when training
    with dropout, else zeros (no draw)."""
    if train and rate > 0.0:
        if generator is None:
            raise ValueError("dropout in training needs a generator")
        return rng.randint(generator, np.iinfo(np.int32).max, (n,), device,
                           torch.int32)
    return torch.zeros((n,), dtype=torch.int32, device=device)


def decoder_apply_grid_fused(params, drug_feat, dis_feat, *,
                             dropout_rate: float, train: bool = False,
                             generator=None, dtype=torch.bfloat16):
    """Fused counterpart of ``nn.decoder.decoder_apply_grid``: node
    projections in PyTorch, the per-cell MLP in the kernel, plus b3.
    Returns (Nd, Nv) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    seed = dropout_seeds(1, proj_drug.device, dropout_rate, train, generator)
    logits = fused_grid_decoder(proj_drug, proj_dis, params["b1"],
                                params["w2"], params["b2"],
                                params["w3"][:, 0], seed, dropout_rate,
                                train, dtype)
    return logits + params["b3"][0]


def decoder_apply_grid_fused_batched(params, drug_feat, dis_feat, *,
                                     dropout_rate: float, train: bool = False,
                                     generator=None, dtype=torch.bfloat16,
                                     mesh=None):
    """Fold-batched fused grid decode, the counterpart of the JAX
    ``decoder_apply_grid_fused_batched`` (pallas_grid_decoder.py:675-712).
    Params leaves and features (F, N, d) carry a leading fold axis; the F
    dropout seeds come from one draw of ``generator``.  With a ``mesh``
    they are this rank's folds, and the kernel runs on the rank's block of
    disease columns over ``mp``
    (sharding/decoder_spmd.py:fused_grid_decoder_batched_spmd).  Returns
    (F, Nd, Nv) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    seed = dropout_seeds(proj_drug.shape[0], proj_drug.device, dropout_rate,
                         train, generator)
    weights = (params["b1"], params["w2"], params["b2"], params["w3"][..., 0])
    if mesh is None:
        logits = fused_grid_decoder_batched(proj_drug, proj_dis, *weights,
                                            seed, dropout_rate, train, dtype)
    else:
        from dream_gnn_tpu_torch.sharding.decoder_spmd import \
            fused_grid_decoder_batched_spmd
        logits = fused_grid_decoder_batched_spmd(
            mesh, proj_drug, proj_dis, *weights, seed, dropout_rate, train,
            dtype)
    return logits + params["b3"][:, :, None]
