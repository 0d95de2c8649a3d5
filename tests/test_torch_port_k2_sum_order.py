"""The bf16 K2 logit depends on the order of a2's f32 sum where h2d sits at
a bf16 midpoint, and nowhere else beyond f32 noise.

K2, the scale decoder's forward (pallas_scale_decoder._k2_kernel), rounds
h2d = relu(a2) * m2 before the logit's dot (``_mlp_fwd``,
pallas_scale_decoder.py:408-411), which the grid and per-edge forwards do
not (tests/test_torch_port_fwd_sum_order.py).  So two orders of a2's sum
that put a2 on either side of a bf16 midpoint of h2d move the bf16 logit by
one bf16 step of h2d times |w3|: far above f32 noise, and above the card
tests' tolerance.  At the relu gate a2 = 0, relu and rnd are continuous,
and the same two orders move the logit by f32 noise only; in fp32 nothing
rounds, and both cases move it by f32 noise only.  The tensor-core K2
(``scale_fwd_mma_kernel`` in dream_gnn_tpu_torch/kernels/csrc/
scale_decoder.cu) therefore sums again in unit order each a2 whose h2d
lies within the window of a midpoint (``near_h2d_mid``, mirrored by
``_window`` here), and no other.

Each a2 sum order is written out, so no BLAS enters the a2 product: unit
order, reversed, and the mma's shape (16-unit k-steps, each summed from 0
and then added).  The one-slot cases put a2 one f32 ulp either side of a
step.  The random case holds the k-step order to the unit order within the
f32 bound on two orders of a sum (``_bound``) at every slot whose h2d
values all lie outside the window.
"""

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.kernels import scale_decoder as sd

H1, H2 = 128, 64
TOL = 1e-4           # the card tests' max|kernel - plain| / max|plain|
U = 2.0 ** -24       # f32 unit roundoff
MID_ULPS = 64        # csrc/decoder_common.cuh
_MATMUL = torch.matmul

ORDERS = {
    "forward": [list(range(H1))],
    "reversed": [list(range(H1 - 1, -1, -1))],
    "k-steps": [list(range(k, k + 16)) for k in range(0, H1, 16)],
}


def _ordered_matmul(blocks):
    """torch.matmul, but the a2 product ((slots, H1) @ (H1, H2)) summed in
    f32 one unit at a time within each block of units, from 0, and the
    blocks' sums added in turn."""
    def mm(x, y):
        if x.shape[-1] != H1 or tuple(y.shape) != (H1, H2):
            return _MATMUL(x, y)
        acc = torch.zeros(x.shape[0], H2)
        for block in blocks:
            part = torch.zeros(x.shape[0], H2)
            for k in block:
                part = part + x[:, k:k + 1] * y[k:k + 1, :]
            acc = acc + part
        return acc

    return mm


def _k2(monkeypatch, order, args, rate, dtype):
    """K2's plain logits (training, no spill) with a2 summed in ``order``."""
    monkeypatch.setattr(torch, "matmul", _ordered_matmul(ORDERS[order]))
    out, _ = sd.scale_fwd_plain(*args, rate, True, dtype, False)
    monkeypatch.undo()
    return out


def _parts(monkeypatch, order, args, rate, dtype):
    """(h1d, a2, m2 or None) of K2's plain version, a2 summed in
    ``order``."""
    pd, pv, b1, w2, b2, _, drug, dis, eid, seed = args
    h1d = torch.relu(sd._rows_a1(pd, pv, b1, drug, dis, dtype))
    m2 = None
    if rate > 0.0:
        m1, m2 = sd.slot_dropout_masks(eid, seed, H1, H2, rate)
        h1d = h1d * m1
    monkeypatch.setattr(torch, "matmul", _ordered_matmul(ORDERS[order]))
    a2 = torch.matmul(sd.round_to(h1d, dtype), sd.round_to(w2, dtype)) + b2
    monkeypatch.undo()
    return h1d, a2, m2


def _one_slot(w2, b2):
    """K2's arguments for one candidate (0, 0) whose table rows give a1 =
    (1 + 0) + 0 = 1 in every unit; w3 = 1."""
    ids = torch.zeros(1, dtype=torch.int32)
    return (torch.ones(1, H1), torch.zeros(1, H1), torch.zeros(H1), w2, b2,
            torch.ones(H2), ids, ids, ids, torch.zeros(1, dtype=torch.int32))


def _midpoint_case():
    """a2[0] = 1 + 2^-8 in unit order (the three 2^-25 terms round away one
    by one), a bf16 midpoint of h2d that rounds to even, 1; 1 + 2^-8 +
    2^-23 reversed, which rounds up to 1 + 2^-7.  The other columns sum 128
    terms of 2^-10 exactly, to 0.125."""
    w2 = torch.zeros(H1, H2)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    return _one_slot(w2, torch.zeros(H2))


def _gate_case():
    """a2[0] = 1 - 1 = 0 in unit order, the relu gate shut; 2^-23 reversed,
    the gate open."""
    w2 = torch.zeros(H1, H2)
    w2[:4, 0] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    b2 = torch.zeros(H2)
    b2[0] = -1.0
    return _one_slot(w2, b2)


CASES = {"midpoint": _midpoint_case, "gate": _gate_case}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_k2_logit_at_a_step_of_a2(monkeypatch, case, dtype):
    """The two orders put a2[0] one f32 ulp apart, on either side of a step
    (the case bites).  In bf16 at the midpoint the logit moves by one bf16
    step of h2d times w3, 2^-7, against a logit of 8.875: far beyond the
    tolerance.  At the gate, and in fp32 in both cases, it moves by at most
    one f32 ulp of itself, 2^-20."""
    args = CASES[case]()
    a2 = {o: _parts(monkeypatch, o, args, 0.0, dtype)[1].flatten()
          for o in ("forward", "reversed")}
    d_a2 = a2["reversed"] - a2["forward"]
    assert float(d_a2[0]) == 2.0 ** -23
    assert not bool(d_a2[1:].any())
    s = {o: float(_k2(monkeypatch, o, args, 0.0, dtype)[0])
         for o in ("forward", "reversed")}
    first = float(sd.round_to(a2["forward"][:1], dtype)[0]) \
        if case == "midpoint" else 0.0
    assert abs(s["forward"] - (first + 63 * 0.125)) <= 2.0 ** -20
    if dtype == torch.bfloat16 and case == "midpoint":
        assert s["forward"] == 1.0 + 63 * 0.125
        assert s["reversed"] - s["forward"] == 2.0 ** -7
        assert (s["reversed"] - s["forward"]) / s["reversed"] > 5 * TOL
    else:
        assert abs(s["reversed"] - s["forward"]) <= 2.0 ** -20


def _random_case(rate):
    """3000 candidate slots over 40 x 50 random tables at the smoke test's
    scales, drug-sorted, with dropout at ``rate``."""
    rng = np.random.default_rng(12)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    drug = np.sort(rng.integers(0, 40, 3000))
    dis = rng.integers(0, 50, 3000)
    ids = [torch.tensor(x, dtype=torch.int32)
           for x in (drug, dis, rng.permutation(3000))]
    return (t(rng.normal(0, 0.5, (40, H1))), t(rng.normal(0, 0.5, (50, H1))),
            t(rng.uniform(-0.06, 0.06, H1)),
            t(rng.uniform(-0.09, 0.09, (H1, H2))),
            t(rng.uniform(-0.09, 0.09, H2)), t(rng.uniform(-0.12, 0.12, H2)),
            *ids, torch.tensor([918273], dtype=torch.int32))


def _window(h1d, a2, m2, w2, rate, dtype):
    """The values the kernel flags (``near_h2d_mid`` on its own a2): kept,
    a2 > 0, and h2d = a2 * mk within MID_ULPS f32 ulps of a bf16 midpoint
    or within band * mk of it, band = 2^-20 * sum(h1d) * max |rnd(w2)|."""
    mk = sd.keep_scale(rate) if rate > 0.0 else 1.0
    h = a2 * mk
    bits = h.view(torch.int32)
    mid = ((bits & -65536) | 0x8000).view(torch.float32)
    band = 2.0 ** -20 * h1d.sum(1, keepdim=True) \
        * float(sd.round_to(w2, dtype).abs().max())
    near = ((bits & 0xFFFF) - 0x8000).abs() <= MID_ULPS
    near = near | ((h - mid).abs() <= band * mk)
    kept = torch.ones_like(near) if m2 is None else m2 > 0
    return kept & (a2 > 0) & near


def _bound(h1d, a2, m2, args, dtype):
    """The largest |s' - s| that two orders of a2's f32 sum (128 exact
    products) can give a logit, with the roundings of the b2 sum and of the
    logit's own 64-term sum, where no rounding of h2d flips:

        sum_n |w3[n]| m2[n] * 2 * 129 u * (sum_k |rnd(h1d[k]) rnd(w2[k, n])|
                                           + |b2[n]|)
        + 2 * 66 u * sum_n |h2d[n] w3[n]|,      u = 2^-24."""
    w2, b2, w3 = args[3], args[4], sd.round_to(args[5], dtype)
    terms = _MATMUL(sd.round_to(h1d, dtype).abs(),
                    sd.round_to(w2, dtype).abs()) + b2.abs()
    m2 = torch.ones_like(terms) if m2 is None else m2
    h2d = torch.relu(a2) * m2
    return (w3.abs() * m2 * 2 * 129 * U * terms).sum(-1) \
        + 2 * 66 * U * (h2d * w3).abs().sum(-1)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_kstep_order_within_the_f32_bound_outside_the_window(
        monkeypatch, dtype, rate):
    """3000 random slots: with a2 summed in k-steps (the kernel's order) or
    reversed, every logit lies within the stated bound of the unit-order
    one, and within a tenth of the tolerance of the largest logit, except
    (bf16 only) at the slots where some h2d lies within the window, which
    the kernel sums again in unit order.  The window flags some values, and
    under 2% of them (the case bites, and the recompute stays rare)."""
    args = _random_case(rate)
    s = {o: _k2(monkeypatch, o, args, rate, dtype) for o in ORDERS}
    h1d, a2, m2 = _parts(monkeypatch, "k-steps", args, rate, dtype)
    window = _window(h1d, a2, m2, args[3], rate, dtype)
    assert 0 < int(window.sum()) < 0.02 * window.numel()
    flagged = window.any(1)
    outside = ~flagged if dtype == torch.bfloat16 else torch.ones_like(flagged)
    bound = _bound(h1d, a2, m2, args, dtype)
    top = float(s["forward"].abs().max())
    for order in ("reversed", "k-steps"):
        diff = (s[order] - s["forward"]).abs()[outside]
        assert bool((diff <= bound[outside]).all())
        assert float(diff.max()) <= 0.1 * TOL * top
