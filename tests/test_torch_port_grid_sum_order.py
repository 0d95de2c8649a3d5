"""The bf16 grid decoder backward's dw3 depends on the order of the f32 sum
behind a2.

dw3 sums rnd(g) * rnd(h2d) over the cells, and rnd rounds h2d = relu(a2)
* m2 to bf16.  Where a2 lies within the last bits of its f32 sum of a
bf16 rounding midpoint, the order of that sum decides which bf16 value
h2d takes: dw3 moves by one bf16 step of h2d, far beyond the 1e-4
tolerance that the card tests hold the CUDA kernel to, while every other
gradient stays the same.  The tensor cores sum a k-step's products in
their own order, so the kernel sums such a2 again in unit order
(``seq_a2`` in dream_gnn_tpu_torch/kernels/csrc/grid_decoder.cu).

The case is built so that the two orders differ by one f32 ulp of a2 and
land on either side of a midpoint; the products are exact bf16 x bf16
values, and each order is summed explicitly, so no BLAS enters the a2
product.
"""

import pytest
import torch

from dream_gnn_tpu_torch.kernels import grid_decoder as gd

H1, H2 = 128, 64
_MATMUL = torch.matmul


def _one_cell():
    """A 1 x 1 grid with h1d = 1 in every unit and a2[0] = 1 + 2^-8 +
    (three terms of 2^-25): forward, the small terms round away one by one
    and a2 = 1 + 2^-8, a bf16 midpoint that rounds to even, 1; reversed,
    they add up to 3/4 ulp first and a2 = 1 + 2^-8 + 2^-23, which rounds
    up to 1 + 2^-7.  The other columns sum 128 terms of 2^-10 exactly."""
    pd = torch.ones(1, H1)
    pv = torch.zeros(1, H1)
    b1 = torch.zeros(H1)
    w2 = torch.zeros(H1, H2)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    b2 = torch.zeros(H2)
    w3 = torch.ones(H2)
    seed = torch.zeros(1, dtype=torch.int32)
    g = torch.ones(1, 1)
    return pd, pv, b1, w2, b2, w3, seed, g


def _ordered_matmul(order):
    """torch.matmul, but the a2 product ((cells, H1) @ (H1, H2)) summed one
    unit at a time in ``order``, in f32."""
    def mm(x, y):
        if x.shape[-1] != H1 or y.shape[-2:] != (H1, H2):
            return _MATMUL(x, y)
        acc = torch.zeros(*x.shape[:-1], H2)
        for k in order:
            acc = acc + x[..., k:k + 1] * y[..., k, :]
        return acc

    return mm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dw3_sees_the_order_of_the_a2_sum(monkeypatch, dtype):
    *args, g = _one_cell()
    grads = {}
    for name, order in (("forward", range(H1)),
                        ("reversed", range(H1 - 1, -1, -1))):
        monkeypatch.setattr(torch, "matmul", _ordered_matmul(order))
        grads[name] = gd.grid_decoder_plain_bwd(*args, 0.0, True, dtype, g)
    monkeypatch.undo()
    fwd, rev = grads["forward"], grads["reversed"]
    for a, b in zip(fwd[:5], rev[:5]):          # dPd, dPv, db1, dW2, db2
        assert torch.equal(a, b)
    rel = float((fwd[5] - rev[5]).abs().max()) / float(fwd[5].abs().max())
    if dtype == torch.bfloat16:
        # One bf16 step of h2d = 1: 2^-7 against max |dw3| = 1.
        assert fwd[5][0] == 1.0 and rev[5][0] == 1.0 + 2.0 ** -7
        assert rel > 1e-4
    else:
        # Without the bf16 rounding the two sums differ by one f32 ulp.
        assert rel <= 2.0 ** -22
