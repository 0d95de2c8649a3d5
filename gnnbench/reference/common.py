"""Pieces of the plain reference that every configuration shares: the
decoder's stateless dropout hash, the step's loss, clip and Adam, and the
evaluation metrics.  Plain PyTorch and NumPy; nothing here imports the
program.

The semantics are those of the reference model (DREAM-GNN ``train.py``,
``layers.py``, ``utils.py``) as the configuration states them, with the
port's documented choices where the reference model leaves one open:
the decoder's dropout masks are a hash of (seed, layer, row, column, unit)
or of (seed, candidate, unit) (the port's kernels/grid_decoder.py and
kernels/scale_decoder.py docstrings), and the optimizer is the optax
chain clip -> add_decayed_weights -> scale_by_adam.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to its own type (the identity
    for float32); autograd rounds the cotangent likewise, as a cast
    does.  An 8-bit float type is taken with a scale per tensor, as 8-bit
    training takes it (see ``Fp8Round``)."""
    if dtype == torch.float32:
        return x
    if dtype.itemsize == 1:
        return Fp8Round.apply(x, dtype)
    return x.to(dtype).to(x.dtype)


def fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` scaled so that its largest magnitude is the type's largest,
    rounded to ``dtype``, and scaled back."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, torch.finfo(dtype).max / amax,
                        torch.ones_like(amax))
    return ((x * scale).to(dtype).to(x.dtype) / scale).to(x.dtype)


class Fp8Round(torch.autograd.Function):
    """Rounds the value to an 8-bit float type, and the cotangent too, each
    with a scale of its own (its largest magnitude at the type's largest),
    so that small cotangents keep their precision instead of flushing to
    zero."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return fp8_round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, ctx.dtype), None


class RoundValue(torch.autograd.Function):
    """Rounds the value to ``dtype``; the cotangent passes unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return rnd(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class RoundGrad(torch.autograd.Function):
    """The identity, whose cotangent is rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rnd(g, ctx.dtype), None


class DecoderMLP(torch.autograd.Function):
    """The decoder's layers after its first: per cell, from a1,

        h1d = relu(a1) * m1;  a2 = rnd(h1d) @ rnd(w2) + b2
        h2d = relu(a2) * m2;  out = h2d . w3

    with the backward the port's decoder kernels document (their plain
    versions, kernels/grid_decoder.py and kernels/edge_decoder.py):
    dw3 = rnd(g) . rnd(h2d), dW2 = rnd(h1d)^T rnd(da2), dh1 = rnd(da2)
    rnd(w2)^T.  Shapes: a1 (b, C, h1), masks like their layers or None,
    w2 (b, h1, h2), b2 and w3 (b, h2); out (b, C)."""

    @staticmethod
    def _parts(a1, m1, m2, w2, b2, dtype):
        h1d = torch.relu(a1)
        if m1 is not None:
            h1d = h1d * m1
        a2 = torch.matmul(rnd(h1d, dtype), rnd(w2, dtype)) + b2[:, None]
        h2d = torch.relu(a2)
        if m2 is not None:
            h2d = h2d * m2
        return h1d, a2, h2d

    @staticmethod
    def forward(ctx, a1, m1, m2, w2, b2, w3, dtype):
        _, _, h2d = DecoderMLP._parts(a1, m1, m2, w2, b2, dtype)
        ctx.save_for_backward(a1, m1, m2, w2, b2, w3)
        ctx.dtype = dtype
        return torch.sum(h2d * w3[:, None], dim=-1)

    @staticmethod
    def backward(ctx, g):
        a1, m1, m2, w2, b2, w3 = ctx.saved_tensors
        dt = ctx.dtype
        h1d, a2, h2d = DecoderMLP._parts(a1, m1, m2, w2, b2, dt)
        g = g[..., None]
        dw3 = torch.sum(rnd(g, dt) * rnd(h2d, dt), dim=1)
        dh2 = g * w3[:, None]
        if m2 is not None:
            dh2 = dh2 * m2
        da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
        dw2 = torch.matmul(rnd(h1d, dt).mT, rnd(da2, dt))
        dh1 = torch.matmul(rnd(da2, dt), rnd(w2, dt).mT)
        if m1 is not None:
            dh1 = dh1 * m1
        da1 = torch.where(a1 > 0.0, dh1, torch.zeros_like(dh1))
        return da1, None, None, dw2, da2.sum(1), dw3, None


# ---------------------------------------------------------------------------
# The decoder's dropout hash: uint32 arithmetic held in int64.

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    return int(min(max(rate, 0.0), 1.0) * 4294967295.0)


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def cell_mask(seed: torch.Tensor, layer: int, i: torch.Tensor,
              j: torch.Tensor, h: int, rate: float) -> torch.Tensor:
    """Mask of grid cells (i, j) over ``h`` units: keep iff
    fmix32(fmix32(fmix32(fmix32(seed ^ layer) ^ i) ^ j) ^ k) >= the
    threshold.  ``seed``, ``i`` and ``j`` broadcast together; the units
    make a last axis."""
    k = torch.arange(h, device=i.device, dtype=torch.int64)
    x = fmix32((seed.to(torch.int64) & M32) ^ layer)
    x = fmix32(x ^ i.to(torch.int64))
    x = fmix32(x ^ j.to(torch.int64))
    bits = fmix32(x[..., None] ^ k)
    return (bits >= keep_threshold(rate)).to(torch.float32) * keep_scale(rate)


def slot_masks(eid: torch.Tensor, seed: int, h1: int, h2: int, rate: float):
    """Masks of candidates ``eid`` of the scale decoder: base = eid *
    0x9E3779B9 ^ seed, unit u keeps iff fmix32(base ^ u * 0x7FEB352D) >=
    the threshold."""
    base = mul32(eid.to(torch.int64) & M32, 0x9E3779B9) ^ (int(seed) & M32)
    unit = torch.arange(h1 + h2, device=eid.device, dtype=torch.int64)
    bits = fmix32(base[:, None] ^ mul32(unit, 0x7FEB352D)[None, :])
    m = (bits >= keep_threshold(rate)).to(torch.float32) * keep_scale(rate)
    return m[:, :h1], m[:, h1:]


def dropout(x: torch.Tensor, u: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with the uniform draw ``u`` of x's shape."""
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


INT32_MAX = 2147483647


def draw(gen: torch.Generator, order, device) -> dict:
    """The draws of ``order``, [(name, kind, shape)], in order: ``rand``
    and ``randn`` float32, ``seed`` int32 in [0, 2**31 - 1), ``salt`` int64
    in [0, 2**31 - 1), as the port draws them."""
    out = {}
    for name, kind, shape in order:
        if kind == "rand":
            out[name] = torch.rand(shape, generator=gen, device=device)
        elif kind == "randn":
            out[name] = torch.randn(shape, generator=gen, device=device)
        elif kind == "seed":
            out[name] = torch.randint(0, INT32_MAX, shape, generator=gen,
                                      device=device, dtype=torch.int32)
        else:
            out[name] = torch.randint(0, 2 ** 31 - 1, shape, generator=gen,
                                      device=device)
    return out


# ---------------------------------------------------------------------------
# Loss, clip, Adam.

def bce_with_logits(logits, targets, weight):
    """Weighted mean of the stable BCE over the last axis."""
    loss = (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.sum(loss * weight, dim=-1) / torch.sum(weight, dim=-1)


def common_loss(e1, e2):
    """MSE between the Gram matrices of the centred, row-normalised
    embeddings of the two routes (reference utils.py:87-95)."""
    def gram(e):
        e = e - e.mean(dim=-2, keepdim=True)
        e = e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True),
                                1e-12)
        return e @ e.mT
    return torch.mean((gram(e1) - gram(e2)) ** 2, dim=(-2, -1))


def clip_per_model_(grads, max_norm: float):
    """Scale each model's slice of the (n, ...) gradients so that its
    global norm is at most ``max_norm``; None stands for a leaf that takes
    no gradient."""
    grads = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.flatten(1), dim=1) for g in grads]),
        dim=0)
    scale = max_norm / torch.clamp_min(norm, max_norm)
    for g in grads:
        g.mul_(scale.reshape(-1, *([1] * (g.dim() - 1))))


class Adam:
    """L2 in the gradient, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside
    the square root), one learning rate for every model.  A leaf whose
    gradient is None (it takes no part in the loss) is left as it is."""

    def __init__(self, params, lr: float, weight_decay: float):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        """Returns the gradients as the moments take them (after the
        decay term)."""
        self.t += 1
        seen = []
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if g is None:
                seen.append(torch.zeros_like(p))
                continue
            g = g + self.wd * p if self.wd else g
            seen.append(g)
            mu.mul_(0.9).add_(g, alpha=0.1)
            nu.mul_(0.999).addcmul_(g, g, value=0.001)
            mu_hat = mu / (1.0 - 0.9 ** self.t)
            den = torch.sqrt(nu / (1.0 - 0.999 ** self.t)) + 1e-8
            p.sub_(self.lr * mu_hat / den)
        return seen


# ---------------------------------------------------------------------------
# Metrics: scikit-learn's roc_auc_score and auc(recall, precision) over
# precision_recall_curve, in float64 on the host.

def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    return float(np.sum(np.diff(x) * (y[1:] + y[:-1]) / 2.0))


def _curve(y: np.ndarray, s: np.ndarray):
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    last = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tps = np.cumsum(y)[last]
    fps = 1.0 + last - tps
    return fps, tps


def auroc(y: np.ndarray, s: np.ndarray) -> float:
    fps, tps = _curve(y.astype(np.float64), s.astype(np.float64))
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return _trapezoid(tpr, fpr)


def aupr(y: np.ndarray, s: np.ndarray) -> float:
    fps, tps = _curve(y.astype(np.float64), s.astype(np.float64))
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    # The curve stops at the first threshold of full recall.
    stop = int(np.argmax(tps >= tps[-1]))
    p = np.r_[precision[stop::-1], 1.0]
    r = np.r_[recall[stop::-1], 0.0]
    return -_trapezoid(p, r)
