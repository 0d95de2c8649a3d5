"""The bf16 scale decoder backward depends on the order of two f32 sums:
dh1's, at a bf16 midpoint of the stored da1, and a2's, at its gate at 0;
and on no third, because h2d rounds nowhere in it.

The scale counterpart of tests/test_torch_port_edge_sum_order.py.  The
tensor cores sum a k-step's products in their own order, so the CUDA
kernel (``scale_bwd_mma_kernel`` in
dream_gnn_tpu_torch/kernels/csrc/scale_decoder.cu) sums again in unit
order the da1 that sit near a bf16 midpoint (``seq_dh1``) and the a2 that
sit near 0 (``seq_a2``).  Unlike the per-edge backward, whose dw3 sums
rnd(h2d), the scale backward's dw3 sums h2d * g unrounded
(pallas_scale_decoder.py:446), so an a2 at a bf16 midpoint of h2d moves
dw3 by f32 noise only, and the kernel needs no midpoint test on a2.

Each case is one slot with a1 = 1 in every unit, g = 1 and w3 = 1, built
so that two orders of one sum differ by less than an f32 ulp of their
largest term and land on either side of a step; the products are exact
bf16 x bf16 values, and each order is summed explicitly, so no BLAS enters
the product in question.  B1 (``a1`` the saved spill, weight gradients)
and the mirror (a1 from the table rows) share the plain backward.
"""

import pytest
import torch

from dream_gnn_tpu_torch.kernels import scale_decoder as sd

H1, H2 = 128, 64
TOL = 1e-4          # the card tests' max|kernel - plain| / max|plain|
_MATMUL = torch.matmul


def _one_slot(w2, b2):
    """The plain backward's arguments but ``a1``: one candidate (0, 0)
    whose table rows give a1 = (1 + 0) + 0 = 1 in every unit."""
    pd = torch.ones(1, H1)
    pv = torch.zeros(1, H1)
    b1 = torch.zeros(H1)
    w3 = torch.ones(H2)
    ids = torch.zeros(1, dtype=torch.int32)
    seed = torch.zeros(1, dtype=torch.int32)
    g = torch.ones(1)
    return pd, pv, ids, ids, ids, g, b1, w2, b2, w3, seed


def _ordered_matmul(depth, order):
    """torch.matmul, but the product of depth ``depth`` ((1, depth) @
    (depth, n)) summed one term at a time in ``order``, in f32."""
    def mm(x, y):
        if x.shape != (1, depth) or y.shape[0] != depth:
            return _MATMUL(x, y)
        acc = torch.zeros(1, y.shape[1])
        for k in order:
            acc = acc + x[:, k:k + 1] * y[k:k + 1, :]
        return acc

    return mm


def _backward(monkeypatch, args, depth, dtype, mirror):
    """The plain backward of one slot with the depth-``depth`` product
    summed forward and in reverse: {order: outputs}.  B1 returns (da1,
    dw2, db2, dw3, db1), the mirror (da1,)."""
    out = {}
    for name, order in (("forward", range(depth)),
                        ("reversed", range(depth - 1, -1, -1))):
        monkeypatch.setattr(torch, "matmul", _ordered_matmul(depth, order))
        a1 = None if mirror else torch.ones(1, H1, dtype=sd._store_dtype(dtype))
        res = sd.scale_bwd_plain(a1, *args, 0.0, True, dtype, not mirror)
        out[name] = res if not mirror else (res,)
        monkeypatch.undo()
    return out["forward"], out["reversed"]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scale_stored_da1_sees_the_order_of_the_dh1_sum(monkeypatch, dtype,
                                                        mirror):
    """dh1[0] = rnd(da2) . rnd(w2)[0] with da2 = 1 and w2[0, :5] = (1, 2^-8,
    2^-25, 2^-25, 2^-25): forward, the small terms round away one by one
    and dh1[0] = 1 + 2^-8, a bf16 midpoint that rounds to even, 1;
    reversed, they add up to 3/4 ulp first and dh1[0] = 1 + 2^-8 + 2^-23,
    which rounds up to 1 + 2^-7.  The stored bf16 da1 moves by one bf16
    step, far beyond the tolerance; db1, which sums the unrounded da1,
    by one f32 ulp."""
    w2 = torch.zeros(H1, H2)
    w2[0, :5] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    fwd, rev = _backward(monkeypatch, _one_slot(w2, torch.ones(H2)), H2,
                         dtype, mirror)
    if not mirror:                  # dW2, db2 and dw3 do not see dh1
        for a, b in zip(fwd[1:4], rev[1:4]):
            assert torch.equal(a, b)
        assert _rel(fwd[4], rev[4]) <= 2.0 ** -22
    da1_f, da1_r = fwd[0].float(), rev[0].float()
    assert torch.equal(da1_f[0, 1:], da1_r[0, 1:])
    if dtype == torch.bfloat16:
        assert float(da1_f[0, 0]) == 1.0
        assert float(da1_r[0, 0]) == 1.0 + 2.0 ** -7
        assert _rel(da1_r, da1_f) > TOL
    else:
        # Without the bf16 rounding the two sums differ by one f32 ulp.
        assert _rel(da1_r, da1_f) <= 2.0 ** -22


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scale_a2_gate_sees_the_order_of_the_a2_sum(monkeypatch, dtype,
                                                    mirror):
    """a2[0] = rnd(h1d) . rnd(w2)[:, 0] + b2[0] with h1d = 1, w2[:4, 0] =
    (1, 2^-25, 2^-25, 2^-25) and b2[0] = -1: forward the product is 1 and
    a2[0] = 0, so the gate a2 > 0 is shut; reversed it is 1 + 2^-23 and
    the gate is open.  da2[0] moves from 0 to g * w3[0] = 1, and with it
    db2, dW2's column 0 and every da1; dw3 moves by h2d = 2^-23 only."""
    w2 = torch.zeros(H1, H2)
    w2[:4, 0] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    b2 = torch.zeros(H2)
    b2[0] = -1.0
    fwd, rev = _backward(monkeypatch, _one_slot(w2, b2), H1, dtype, mirror)
    # da1 = dh1: 63 open columns of 2^-10, and w2[k, 0] more where the
    # gate of column 0 is open.
    assert bool((fwd[0].float() == 63 * 2.0 ** -10).all())
    assert float(rev[0].float()[0, 0]) == float(
        sd.round_to(torch.tensor(1.0 + 63 * 2.0 ** -10), dtype))
    assert _rel(rev[0], fwd[0]) > TOL
    if not mirror:
        dw2, db2, dw3 = zip(fwd[1:4], rev[1:4])
        assert float(db2[0][0]) == 0.0 and float(db2[1][0]) == 1.0
        assert torch.equal(db2[0][1:], db2[1][1:])
        assert not bool(dw2[0][:, 0].any()) and float(dw2[1][0, 0]) == 1.0
        assert torch.equal(dw2[0][:, 1:], dw2[1][:, 1:])
        assert float((dw3[1] - dw3[0]).abs().max()) == 2.0 ** -23


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scale_dw3_ignores_a2_at_a_midpoint_of_h2d(monkeypatch, dtype,
                                                   mirror):
    """a2[0] = 1 + 2^-8 forward and 1 + 2^-8 + 2^-23 reversed (w2[:5, 0] =
    (1, 2^-8, 2^-25, 2^-25, 2^-25), b2 = 0): the two sides of a bf16
    midpoint of h2d = a2, which moves the per-edge backward's dw3 by one
    bf16 step (tests/test_torch_port_edge_sum_order.py).  The scale
    backward does not round h2d: dw3 moves by one f32 ulp, and nothing
    else moves at all."""
    w2 = torch.zeros(H1, H2)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    fwd, rev = _backward(monkeypatch, _one_slot(w2, torch.zeros(H2)), H1,
                         dtype, mirror)
    for i, (a, b) in enumerate(zip(fwd, rev)):
        if i == 3:                  # dw3
            assert float(a[0]) == 1.0 + 2.0 ** -8
            assert float(b[0]) == 1.0 + 2.0 ** -8 + 2.0 ** -23
            assert torch.equal(a[1:], b[1:])
            assert _rel(b, a) <= 2.0 ** -22
        else:
            assert torch.equal(a, b)
