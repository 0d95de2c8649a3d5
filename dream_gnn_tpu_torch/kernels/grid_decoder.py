"""Fused dense-grid MLP decoder: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``dream_gnn_tpu/kernels/pallas_grid_decoder.py`` (``fused_grid_decoder``).
For every (drug i, disease j) cell of the grid it computes

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
backward kernels draw the same masks whatever their tiling.

What bounds the kernel on an H100.  At Gdataset width (593 x 313 cells,
H1 = 128, H2 = 64) the forward does about 16.6 kFLOP per cell, about
3.1 GFLOP in all, against about 1.2 MB of traffic: operations bound it,
by a wide margin.  The backward does about three times the work.  This
first version runs the products on the CUDA cores in f32 and leaves the
tensor cores unused; ``PERF.md`` carries its measured times beside the
bound.

Dispatch.  ``fused_grid_decoder`` runs the kernel for CUDA tensors and the
plain version only for CPU tensors; there is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

H1, H2 = 128, 64          # widths the CUDA kernel is built for

LAUNCHES = {"fwd": 0, "bwd": 0}

_SRC = Path(__file__).resolve().parent / "csrc" / "grid_decoder.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LIB_PATH = BUILD_DIR / "libgrid_decoder.so"
_lib = None

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Dropout hash, plain version (int64 holding uint32 values).

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_bits(seed: torch.Tensor, layer: int, nd: int, nv: int,
                 h: int) -> torch.Tensor:
    """(nd, nv, h) int64 tensor of the uint32 hash bits defined above."""
    dev = seed.device
    i = torch.arange(nd, device=dev, dtype=torch.int64).view(nd, 1, 1)
    j = torch.arange(nv, device=dev, dtype=torch.int64).view(1, nv, 1)
    k = torch.arange(h, device=dev, dtype=torch.int64).view(1, 1, h)
    x = fmix32((seed.reshape(1, 1, 1).to(torch.int64) & _M32) ^ layer)
    x = fmix32(x ^ i)
    x = fmix32(x ^ j)
    return fmix32(x ^ k)


def keep_threshold(rate: float) -> int:
    """uint32 keep threshold, truncated as ``jnp.uint32(rate * (2**32-1))``."""
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def dropout_mask(seed: torch.Tensor, layer: int, nd: int, nv: int, h: int,
                 rate: float) -> torch.Tensor:
    """(nd, nv, h) f32 mask with values 0 or 1/(1-rate)."""
    keep = dropout_bits(seed, layer, nd, nv, h) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


# ---------------------------------------------------------------------------
# Plain PyTorch version.

def round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to ``dtype`` and return f32 (identity for f32)."""
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def _plain_parts(pd, pv, b1, w2, b2, seed, rate, train, dtype):
    """(a1, h1d, m1, a2, h2d, m2) over the whole grid, as _tile_forward."""
    nd, nv = pd.shape[0], pv.shape[0]
    use_drop = train and rate > 0.0
    a1 = (pd[:, None, :] + pv[None, :, :]) + b1
    h1 = torch.relu(a1)
    m1 = dropout_mask(seed, 1, nd, nv, w2.shape[0], rate) if use_drop else None
    h1d = h1 * m1 if use_drop else h1
    a2 = torch.matmul(round_to(h1d, dtype), round_to(w2, dtype)) + b2
    h2 = torch.relu(a2)
    m2 = dropout_mask(seed, 2, nd, nv, w2.shape[1], rate) if use_drop else None
    h2d = h2 * m2 if use_drop else h2
    return a1, h1d, m1, a2, h2d, m2


def grid_decoder_plain(pd, pv, b1, w2, b2, w3, seed, rate: float,
                       train: bool, dtype=torch.bfloat16) -> torch.Tensor:
    """Forward of the kernel in plain PyTorch; differentiable by autograd."""
    *_, h2d, _ = _plain_parts(pd, pv, b1, w2, b2, seed, rate, train, dtype)
    return torch.sum(h2d * w3, dim=-1)


def grid_decoder_plain_bwd(pd, pv, b1, w2, b2, w3, seed, rate: float,
                           train: bool, dtype, g):
    """Explicit backward, step for step as the Pallas ``_bwd_kernel``.
    Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    use_drop = train and rate > 0.0
    a1, h1d, m1, a2, h2d, m2 = _plain_parts(pd, pv, b1, w2, b2, seed, rate,
                                            train, dtype)
    h1, h2 = w2.shape
    g = g[:, :, None]
    dw3 = torch.matmul(round_to(g, dtype).reshape(1, -1),
                       round_to(h2d, dtype).reshape(-1, h2))[0]
    dh2 = g * w3
    if use_drop:
        dh2 = dh2 * m2
    da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
    dw2 = torch.matmul(round_to(h1d, dtype).reshape(-1, h1).T,
                       round_to(da2, dtype).reshape(-1, h2))
    db2 = torch.sum(da2, dim=(0, 1))
    dh1 = torch.matmul(round_to(da2, dtype), round_to(w2, dtype).T)
    if use_drop:
        dh1 = dh1 * m1
    da1 = torch.where(a1 > 0.0, dh1, torch.zeros_like(dh1))
    return (torch.sum(da1, dim=1), torch.sum(da1, dim=0),
            torch.sum(da1, dim=(0, 1)), dw2, db2, dw3)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch.

def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the grid decoder kernel cannot "
                           "be built")
    return found


def build(force: bool = False) -> str:
    """Compile csrc/grid_decoder.cu into a shared library, when ``force``
    or when the source is newer than the library, and return nvcc's
    output (its -Xptxas -v report of registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not force and _LIB_PATH.exists() \
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return ""
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        lib.grid_decoder_fwd.argtypes = [p] * 8 + [i, i, u, f, i, i, p]
        lib.grid_decoder_fwd.restype = i
        lib.grid_decoder_bwd.argtypes = [p] * 14 + [i, i, u, f, i, i, p]
        lib.grid_decoder_bwd.restype = i
        lib.grid_decoder_bwd_layout.argtypes = [i, i, p]
        lib.grid_decoder_bwd_layout.restype = None
        _lib = lib
    return _lib


def _check(pd, pv, b1, w2, b2, w3, seed, dtype):
    dev = pd.device
    for name, x, shape in (("proj_drug", pd, (pd.shape[0], H1)),
                           ("proj_dis", pv, (pv.shape[0], H1)),
                           ("b1", b1, (H1,)), ("w2", w2, (H1, H2)),
                           ("b2", b2, (H2,)), ("w3", w3, (H2,))):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"grid decoder kernel: {name} must be a "
                             f"contiguous f32 {shape} tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if seed.device != dev or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("grid decoder kernel: seed must be one int32 on "
                         f"{dev}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grid decoder kernel: dtype {dtype} unsupported")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype):
    """One forward kernel launch; returns (Nd, Nv) f32 without b3."""
    _check(pd, pv, b1, w2, b2, w3, seed, dtype)
    lib = _load()
    nd, nv = pd.shape[0], pv.shape[0]
    out = torch.empty((nd, nv), dtype=torch.float32, device=pd.device)
    use_drop = bool(train and rate > 0.0)
    err = lib.grid_decoder_fwd(
        pd.data_ptr(), pv.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), seed.data_ptr(), out.data_ptr(), nd, nv,
        keep_threshold(rate) if use_drop else 0,
        keep_scale(rate) if use_drop else 1.0, int(use_drop),
        int(dtype == torch.bfloat16), _stream(pd.device))
    if err != 0:
        raise RuntimeError(f"grid_decoder_fwd launch failed: CUDA error {err}")
    LAUNCHES["fwd"] += 1
    return out


def launch_bwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype, g):
    """One backward kernel launch plus the sums over its partial slabs.
    Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    _check(pd, pv, b1, w2, b2, w3, seed, dtype)
    nd, nv = pd.shape[0], pv.shape[0]
    if g.device != pd.device or g.dtype != torch.float32 \
            or tuple(g.shape) != (nd, nv) or not g.is_contiguous():
        raise ValueError("grid decoder kernel: g must be a contiguous f32 "
                         f"({nd}, {nv}) tensor on {pd.device}")
    lib = _load()
    layout = (ctypes.c_int * 4)()
    lib.grid_decoder_bwd_layout(nd, nv, ctypes.addressof(layout))
    n_jt, n_split, nd_pad, nv_pad = layout
    n_blk = n_split * n_jt
    kw = dict(dtype=torch.float32, device=pd.device)
    dpd_part = torch.empty((n_jt, nd_pad, H1), **kw)
    dpv_part = torch.empty((n_split, nv_pad, H1), **kw)
    db1_part = torch.empty((n_blk, H1), **kw)
    dw2_part = torch.empty((n_blk, H1, H2), **kw)
    db2_part = torch.empty((n_blk, H2), **kw)
    dw3_part = torch.empty((n_blk, H2), **kw)
    use_drop = bool(train and rate > 0.0)
    err = lib.grid_decoder_bwd(
        pd.data_ptr(), pv.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), seed.data_ptr(), g.data_ptr(),
        dpd_part.data_ptr(), dpv_part.data_ptr(), db1_part.data_ptr(),
        dw2_part.data_ptr(), db2_part.data_ptr(), dw3_part.data_ptr(),
        nd, nv, keep_threshold(rate) if use_drop else 0,
        keep_scale(rate) if use_drop else 1.0, int(use_drop),
        int(dtype == torch.bfloat16), _stream(pd.device))
    if err != 0:
        raise RuntimeError(f"grid_decoder_bwd launch failed: CUDA error {err}")
    LAUNCHES["bwd"] += 1
    return (dpd_part.sum(0)[:nd], dpv_part.sum(0)[:nv], db1_part.sum(0),
            dw2_part.sum(0), db2_part.sum(0), dw3_part.sum(0))


class _FusedGridDecoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pd, pv, b1, w2, b2, w3, seed, rate, train, dtype):
        ctx.save_for_backward(pd, pv, b1, w2, b2, w3, seed)
        ctx.cfg = (rate, train, dtype)
        if pd.is_cuda:
            return launch_fwd(pd, pv, b1, w2, b2, w3, seed, rate, train, dtype)
        return grid_decoder_plain(pd, pv, b1, w2, b2, w3, seed, rate, train,
                                  dtype)

    @staticmethod
    def backward(ctx, g):
        args = (*ctx.saved_tensors, *ctx.cfg, g.contiguous())
        grads = launch_bwd(*args) if g.is_cuda else grid_decoder_plain_bwd(*args)
        return (*grads, None, None, None, None)


def fused_grid_decoder(proj_drug, proj_dis, b1, w2, b2, w3, seed,
                       rate: float, train: bool, dtype=torch.bfloat16):
    """Grid decoder MLP, the contract of the JAX ``fused_grid_decoder``.

    proj_drug (Nd, 128) f32, proj_dis (Nv, 128) f32, b1 (128,),
    w2 (128, 64), b2 (64,), w3 (64,), seed (1,) int32 on the same device.
    Returns (Nd, Nv) f32 logits without b3.  CUDA tensors run the kernel,
    CPU tensors the plain version.
    """
    return _FusedGridDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), seed, rate, train,
        dtype)


def node_projections(params, drug_feat, dis_feat, dtype):
    """(Pd, Pv): bf16 operands with an f32 product, as XLA's
    ``preferred_element_type=f32``.  torch's bf16 @ bf16 returns bf16,
    which would round the output, so the rounded operands are multiplied
    in f32 instead; a bf16 x bf16 product is exact in f32."""
    d = drug_feat.shape[1]
    w1 = params["w1"]
    return (torch.matmul(round_to(drug_feat, dtype), round_to(w1[:d], dtype)),
            torch.matmul(round_to(dis_feat, dtype), round_to(w1[d:], dtype)))


def decoder_apply_grid_fused(params, drug_feat, dis_feat, *,
                             dropout_rate: float, train: bool = False,
                             generator=None, dtype=torch.bfloat16):
    """Fused counterpart of ``nn.decoder.decoder_apply_grid``: node
    projections in PyTorch, the per-cell MLP in the kernel, plus b3.
    Returns (Nd, Nv) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    dev = proj_drug.device
    if train and dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout in training needs a generator")
        seed = torch.randint(0, np.iinfo(np.int32).max, (1,),
                             generator=generator, device=dev,
                             dtype=torch.int32)
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=dev)
    logits = fused_grid_decoder(proj_drug, proj_dis, params["b1"],
                                params["w2"], params["b2"],
                                params["w3"][:, 0], seed, dropout_rate,
                                train, dtype)
    return logits + params["b3"][0]
