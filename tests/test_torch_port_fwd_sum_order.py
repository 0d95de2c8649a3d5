"""The grid and per-edge decoders' forward logit does not depend on the
order of the f32 sum behind a2, beyond f32 noise; their bf16 backward does.

The forward s = sum_n m2[n] * relu(a2[n] + b2[n]) * w3[n] rounds neither
a2 nor h2d, and relu is continuous, so two orders of a2's f32 sum move s
by at most what they move a2, times |w3| m2.  The bf16 backward rounds
h2d before dw3 sums it, and gates da2 on a2 > 0: there the same two
orders move dw3 by one bf16 step of h2d (at a midpoint), or db2 by
g * w3 (at the gate).  So the tensor-core forwards
(``grid_fwd_mma_kernel``, ``edge_fwd_mma_kernel`` in
dream_gnn_tpu_torch/kernels/csrc/) sum a2 in the mma's own order and need
no unit-order recompute (``seq_a2``), which the backwards do need
(tests/test_torch_port_grid_sum_order.py,
tests/test_torch_port_edge_sum_order.py).

Each a2 sum order is written out (unit order, reversed, and the mma's
shape: 16-unit k-steps, each summed and then added), so no BLAS enters the
a2 product.  The one-cell cases put a2 within one f32 ulp of a step; the
random case holds the difference to the standard bound on two orders of a
sum (``_fwd_bound``), and to a tenth of the tolerance.
"""

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.kernels import edge_decoder as ed
from dream_gnn_tpu_torch.kernels import grid_decoder as gd

H1, H2 = 128, 64
TOL = 1e-4           # the card tests' max|kernel - plain| / max|plain|
U = 2.0 ** -24       # f32 unit roundoff
_MATMUL = torch.matmul

ORDERS = {
    "forward": [list(range(H1))],
    "reversed": [list(range(H1 - 1, -1, -1))],
    "k-steps": [list(range(k, k + 16)) for k in range(0, H1, 16)],
}


def _ordered_matmul(blocks):
    """torch.matmul, but the a2 product ((..., rows, H1) @ (..., H1, H2))
    summed in f32 one unit at a time within each block of units, and the
    blocks' sums added in turn."""
    def mm(x, y):
        if x.shape[-1] != H1 or y.shape[-2:] != (H1, H2):
            return _MATMUL(x, y)
        acc = torch.zeros(*x.shape[:-1], H2)
        for block in blocks:
            part = torch.zeros(*x.shape[:-1], H2)
            for k in block:
                part = part + x[..., k:k + 1] * y[..., k:k + 1, :]
            acc = acc + part
        return acc

    return mm


def _one_cell(kind, w2, b2):
    """One cell (drug 0, disease 0), or one edge (0, 0), whose table rows
    give a1 = 1 in every unit; w3 = 1, g = 1."""
    args = [torch.ones(1, H1), torch.zeros(1, H1), torch.zeros(H1), w2, b2,
            torch.ones(H2)]
    seed = torch.zeros(1, dtype=torch.int32)
    if kind == "grid":
        return args + [seed], torch.ones(1, 1)
    return args + [torch.zeros(2, 1, dtype=torch.int32), seed], torch.ones(1)


def _midpoint_case(kind):
    """a2[0] = 1 + 2^-8 in unit order (the three 2^-25 terms round away one
    by one), a bf16 midpoint of h2d that rounds to even, 1; 1 + 2^-8 +
    2^-23 reversed, which rounds up to 1 + 2^-7.  The other columns sum 128
    terms of 2^-10 exactly."""
    w2 = torch.zeros(H1, H2)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    return _one_cell(kind, w2, torch.zeros(H2))


def _gate_case(kind):
    """a2[0] = 1 - 1 = 0 in unit order, the relu gate shut; 2^-23 reversed,
    the gate open."""
    w2 = torch.zeros(H1, H2)
    w2[:4, 0] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    b2 = torch.zeros(H2)
    b2[0] = -1.0
    return _one_cell(kind, w2, b2)


CASES = {"midpoint": _midpoint_case, "gate": _gate_case}


def _plain(kind):
    if kind == "grid":
        return gd.grid_decoder_plain, gd.grid_decoder_plain_bwd
    return ed.edge_decoder_plain, ed.edge_decoder_plain_bwd


def _run(monkeypatch, fn, order, *args):
    monkeypatch.setattr(torch, "matmul", _ordered_matmul(ORDERS[order]))
    out = fn(*args)
    monkeypatch.undo()
    return out


def _a2(kind, args, rate, train, dtype):
    """a2 of the plain version's forward (the current torch.matmul)."""
    if kind == "grid":
        return gd._plain_parts(*args[:5], args[6], rate, train, dtype)[3]
    return ed._plain_parts(*args[:5], *args[6:], rate, train, dtype)[5]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["grid", "edge"])
def test_fwd_logit_ignores_the_order_of_the_a2_sum(monkeypatch, kind, case,
                                                   dtype):
    """The two orders put a2[0] one f32 ulp apart, on either side of a step
    (the case bites); the logit moves by at most one f32 ulp of itself,
    2^-20 of a logit of about 8.9."""
    args, _ = CASES[case](kind)
    fwd, _ = _plain(kind)
    a2 = {o: _run(monkeypatch, _a2, o, kind, args, 0.0, True, dtype)
          for o in ("forward", "reversed")}
    s = {o: _run(monkeypatch, fwd, o, *args, 0.0, True, dtype)
         for o in ("forward", "reversed")}
    d_a2 = (a2["reversed"] - a2["forward"]).flatten()
    assert float(d_a2[0]) == 2.0 ** -23
    assert not bool(d_a2[1:].any())
    assert float((s["reversed"] - s["forward"]).abs().max()) <= 2.0 ** -20
    assert abs(float(s["forward"].flatten()[0])
               - (float(a2["forward"].flatten()[0]) * (case == "midpoint")
                  + 63 * 0.125)) <= 2.0 ** -20


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["grid", "edge"])
def test_bf16_bwd_sees_the_order_the_fwd_ignores(monkeypatch, kind, case):
    """The same two orders in the bf16 backward: at the midpoint dw3[0] =
    rnd(h2d[0]) moves by one bf16 step, 2^-7 against max |dw3| = 1 + 2^-7;
    at the gate db2[0] = da2[0] moves from 0 to g * w3[0] = 1.  Both are
    far beyond the tolerance that the forward stays inside."""
    args, g = CASES[case](kind)
    _, bwd = _plain(kind)
    grads = {o: _run(monkeypatch, bwd, o, *args, 0.0, True, torch.bfloat16, g)
             for o in ("forward", "reversed")}
    fwd_g, rev_g = grads["forward"], grads["reversed"]
    if case == "midpoint":
        assert float(fwd_g[5][0]) == 1.0
        assert float(rev_g[5][0]) == 1.0 + 2.0 ** -7
        moved = rev_g[5]
        base = fwd_g[5]
    else:
        assert float(fwd_g[4][0]) == 0.0 and float(rev_g[4][0]) == 1.0
        moved, base = rev_g[4], fwd_g[4]
    rel = float((moved - base).abs().max()) / float(moved.abs().max())
    assert rel > 10 * TOL


def _random_case(kind, nf, rate):
    """Random tables and weights at the smoke test's scales over a 7 x 9
    grid, or 50 edges over it, with dropout at ``rate``."""
    rng = np.random.default_rng(11)
    lead = () if nf is None else (nf,)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    args = [t(rng.normal(0, 0.5, (*lead, 7, H1))),
            t(rng.normal(0, 0.5, (*lead, 9, H1))),
            t(rng.uniform(-0.06, 0.06, (*lead, H1))),
            t(rng.uniform(-0.09, 0.09, (*lead, H1, H2))),
            t(rng.uniform(-0.09, 0.09, (*lead, H2))),
            t(rng.uniform(-0.12, 0.12, (*lead, H2)))]
    seed = torch.tensor(rng.integers(0, 2 ** 31 - 1, nf or 1),
                        dtype=torch.int32)
    if kind == "edge":
        edges = np.stack([rng.integers(0, 7, (*lead, 50)),
                          rng.integers(0, 9, (*lead, 50))], axis=-2)
        args.append(torch.tensor(edges, dtype=torch.int32))
    return args + [seed]


def _fwd_bound(kind, args, nf, rate, dtype):
    """The largest |s' - s| that two orders of a2's f32 sum (128 exact
    products) and of the logit's own sum (64 terms) can give, with the
    roundings of the b2 sum and of the products around them:

        sum_n |w3[n]| m2[n] * 2 * 129 u * (sum_k |rnd(h1d[k]) rnd(w2[k, n])|
                                           + |b2[n]|)
        + 2 * 66 u * sum_n |h2d[n] w3[n]|,      u = 2^-24."""
    seed = args[-1] if nf is None else args[-1][:, None]
    if kind == "grid":
        _, h1d, _, _, h2d, m2 = gd._plain_parts(*args[:5], seed, rate, True,
                                                dtype)
        h1d, h2d = gd._cells(h1d), gd._cells(h2d)
        m2 = None if m2 is None else gd._cells(m2)
    else:
        *_, h1d, _, _, h2d, m2 = ed._plain_parts(*args[:5], args[6], seed,
                                                 rate, True, dtype)
    w3 = args[5][..., None, :]
    terms = _MATMUL(gd.round_to(h1d, dtype).abs(),
                    gd.round_to(args[3], dtype).abs()) \
        + args[4][..., None, :].abs()
    m2 = torch.ones_like(terms) if m2 is None else m2
    bound = (w3.abs() * m2 * 2 * 129 * U * terms).sum(-1) \
        + 2 * 66 * U * (h2d * w3).abs().sum(-1)
    return bound.reshape(-1)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["grid", "edge"])
def test_fwd_logits_within_the_f32_bound_of_any_order(monkeypatch, kind,
                                                      dtype, nf, rate):
    """Every logit of a random case with a2 summed reversed or in k-steps
    lies within the stated bound of the unit-order one, and within 1e-5 of
    the largest logit (a tenth of the tolerance)."""
    args = _random_case(kind, nf, rate)
    if kind == "grid":
        fwd = gd.grid_decoder_plain if nf is None \
            else gd.grid_decoder_batched_plain
    else:
        fwd = ed.edge_decoder_plain if nf is None \
            else ed.edge_decoder_batched_plain
    s = {o: _run(monkeypatch, fwd, o, *args, rate, True, dtype).reshape(-1)
         for o in ORDERS}
    bound = _fwd_bound(kind, args, nf, rate, dtype)
    top = float(s["forward"].abs().max())
    for order in ("reversed", "k-steps"):
        diff = (s[order] - s["forward"]).abs()
        assert bool((diff <= bound).all())
        assert float(diff.max()) <= 0.1 * TOL * top
