"""Card-only checks of the port: the CUDA decoder kernels (grid and per
edge, single-fold and fold-batched, forward and backward; in bf16 on the
tensor cores, in fp32 on the CUDA cores), the scale path's kernels (the
segmented sum behind spmm_slab and seq_scatter, the scale decoder's K2, B1
and mirror) and the scale benchmark's (the same segmented sum behind
spmm_gather and spmm_blocked) against their plain versions at ragged
shapes (for the segmented sum: every rounding, f32 and bf16 x, null src and
val, every width path of d, rows of 0 to 1,000 entries), their input
checks, and the entry points' use of them; and GCMC's bilinear decoder
(its forward, user pass and movie pass at a skewed size, bit-for-bit
repeats, autograd against the CPU's plain version), within 1e-5 of the
largest value (float32 sums in other orders).  Every test
carries the ``gpu`` marker and skips without a CUDA device.  The file
imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py

Tolerances (max|kernel - plain| / max|plain|): 1e-4 in fp32 and in bf16.
Both dtypes run the same arithmetic summed in another order; in bf16 mode
both round at the same points, and a product of bf16 values is exact in
f32.  A control checks that the bf16 tolerance fails a kernel that does
not round.
"""

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.kernels import edge_decoder as ed
from dream_gnn_tpu_torch.kernels import grid_decoder as gd

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _args(dev, nd, nv, seed=0):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return ([t(rng.normal(0, 0.5, (nd, 128))), t(rng.normal(0, 0.5, (nv, 128))),
             t(rng.uniform(-.1, .1, 128)), t(rng.uniform(-.1, .1, (128, 64))),
             t(rng.uniform(-.1, .1, 64)), t(rng.uniform(-.2, .2, 64)),
             torch.tensor([77], dtype=torch.int32, device=dev)],
            t(rng.normal(0, 1, (nd, nv))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1), (5, 33), (37, 23), (130, 300)])
def test_kernel_matches_plain(cuda, dtype, rate, shape):
    args, g = _args(cuda, *shape)
    out = gd.launch_fwd(*args, rate, True, dtype)
    ref = gd.grid_decoder_plain(*args, rate, True, dtype)
    grads = gd.launch_bwd(*args, rate, True, dtype, g)
    refs = gd.grid_decoder_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    for a, b in zip((out, *grads), (ref, *refs)):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bf16_tolerance_sees_missing_rounding(cuda, rate):
    """The fp32 kernel, which rounds nothing, fails the bf16 comparison in
    every output that the rounding moves: all but db2, which sums the
    unrounded da2."""
    args, g = _args(cuda, 130, 300)
    out = gd.launch_fwd(*args, rate, True, torch.float32)
    ref = gd.grid_decoder_plain(*args, rate, True, torch.bfloat16)
    dpd, dpv, db1, dw2, _, dw3 = gd.launch_bwd(*args, rate, True,
                                               torch.float32, g)
    rpd, rpv, rb1, rw2, _, rw3 = gd.grid_decoder_plain_bwd(
        *args, rate, True, torch.bfloat16, g)
    for a, b in zip((out, dpd, dpv, db1, dw2, dw3),
                    (ref, rpd, rpv, rb1, rw2, rw3)):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err > TOL[torch.bfloat16]


def test_kernel_is_deterministic(cuda):
    args, g = _args(cuda, 64, 96, seed=1)
    a = gd.launch_bwd(*args, 0.3, True, torch.bfloat16, g)
    b = gd.launch_bwd(*args, 0.3, True, torch.bfloat16, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_counts_launches_and_checks_inputs(cuda):
    args, g = _args(cuda, 8, 8)
    before = dict(gd.LAUNCHES)
    gd.fused_grid_decoder(*args, 0.0, False, torch.bfloat16)
    assert gd.LAUNCHES["fwd"] == before["fwd"] + 1
    bad = list(args)
    bad[0] = torch.zeros(8, 64, device=cuda)
    with pytest.raises(ValueError, match="proj_drug"):
        gd.launch_fwd(*bad, 0.0, False, torch.bfloat16)


def test_trainer_step_launches_kernels(cuda, tmp_path):
    from dream_gnn_tpu_torch.train.cli import main

    for k in gd.LAUNCHES:
        gd.LAUNCHES[k] = 0
    main(["--data_name", "Gdataset", "--seeds", "1", "--folds", "0",
          "--train_max_iter", "3", "--train_valid_interval", "2",
          "--layers", "2", "--gcn_agg_units", "96", "--gcn_out_units", "32",
          "--nhid1", "64", "--nhid2", "32", "--save_dir", str(tmp_path)])
    assert gd.LAUNCHES == {"fwd": 2 + 2, "bwd": 2, "fwd_b": 0, "bwd_b": 0}


def _args_b(dev, nf, nd, nv, seed=0):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return ([t(rng.normal(0, 0.5, (nf, nd, 128))),
             t(rng.normal(0, 0.5, (nf, nv, 128))),
             t(rng.uniform(-.1, .1, (nf, 128))),
             t(rng.uniform(-.1, .1, (nf, 128, 64))),
             t(rng.uniform(-.1, .1, (nf, 64))), t(rng.uniform(-.2, .2, (nf, 64))),
             torch.tensor(rng.integers(0, 2 ** 31 - 1, nf), dtype=torch.int32,
                          device=dev)],
            t(rng.normal(0, 1, (nf, nd, nv))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 33), (3, 37, 23),
                                   (10, 130, 300)])
def test_batched_kernel_matches_plain(cuda, dtype, rate, shape):
    args, g = _args_b(cuda, *shape)
    out = gd.launch_fwd_batched(*args, rate, True, dtype)
    ref = gd.grid_decoder_batched_plain(*args, rate, True, dtype)
    grads = gd.launch_bwd_batched(*args, rate, True, dtype, g)
    refs = gd.grid_decoder_batched_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    for a, b in zip((out, *grads), (ref, *refs)):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= TOL[dtype]


def test_batched_kernel_is_deterministic(cuda):
    args, g = _args_b(cuda, 3, 64, 96, seed=1)
    a = gd.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, g)
    b = gd.launch_bwd_batched(*args, 0.3, True, torch.bfloat16, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_fold_equals_single_fold_kernel(cuda, dtype):
    """Fold f of one batched forward launch is the single-fold kernel
    called with seed[f], bit for bit."""
    args, _ = _args_b(cuda, 3, 37, 45, seed=2)
    out = gd.launch_fwd_batched(*args, 0.3, True, dtype)
    for f in range(3):
        one = gd.launch_fwd(*[a[f].contiguous() for a in args[:6]],
                            args[6][f:f + 1].contiguous(), 0.3, True, dtype)
        assert torch.equal(out[f], one)


def test_batched_wrapper_checks_inputs(cuda):
    args, _ = _args_b(cuda, 3, 8, 8)
    bad = list(args)
    bad[6] = args[6][:2].contiguous()
    with pytest.raises(ValueError, match="seed"):
        gd.launch_fwd_batched(*bad, 0.0, False, torch.bfloat16)
    bad = list(args)
    bad[2] = args[2][0].contiguous()
    with pytest.raises(ValueError, match="b1"):
        gd.launch_fwd_batched(*bad, 0.0, False, torch.bfloat16)


# ---------------------------------------------------------------------------
# The grid kernels' row and column bases (the mesh wrappers' blocks).

def _digest(x: torch.Tensor) -> str:
    import hashlib

    raw = x.detach().contiguous().cpu().view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def grid_digests(module, dev) -> dict:
    """Digests of the four grid kernels' outputs (the fp32 and bf16
    forwards and backwards, one fold and a stack of 3) at fixed inputs with
    dropout 0.3, through the launch calls without bases, which every
    checkout's ``kernels/grid_decoder.py`` has; ``module`` is that file's
    module.  A backward's digest is over its six outputs in order."""
    out = {}
    for nf in (None, 3):
        if nf is None:
            args, g = _args(dev, 37, 45, seed=5)
            fwd, bwd = module.launch_fwd, module.launch_bwd
        else:
            args, g = _args_b(dev, nf, 37, 45, seed=5)
            fwd, bwd = module.launch_fwd_batched, module.launch_bwd_batched
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{'one' if nf is None else 'stack'} {str(dtype)[6:]}"
            out[f"{tag} fwd"] = _digest(fwd(*args, 0.3, True, dtype))
            out[f"{tag} bwd"] = _digest(torch.cat([
                x.reshape(-1) for x in bwd(*args, 0.3, True, dtype, g)]))
    return out


# ``grid_digests`` of the kernels before they took row and column bases,
# printed on an NVIDIA H100 80GB HBM3 (700.00 W) by the parent checkout.
GRID_DIGESTS = {
    "one float32 fwd": "a41357ea2fee8dc6",
    "one float32 bwd": "ae0b79663418430e",
    "one bfloat16 fwd": "4c2085d4c09fc915",
    "one bfloat16 bwd": "e064e0cae2fa2c74",
    "stack float32 fwd": "8a18f08b4ed80492",
    "stack float32 bwd": "8ca8255c238a26a0",
    "stack bfloat16 fwd": "c64633a29c6a363d",
    "stack bfloat16 bwd": "e420cf4f4a547ea6"}


def test_grid_kernels_with_bases_of_zero_keep_their_bits(cuda):
    """Bases of 0 (the default) give, bit for bit, the outputs the kernels
    gave before they took bases."""
    assert GRID_DIGESTS and grid_digests(gd, cuda) == GRID_DIGESTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("bases", [(4, 0), (0, 33), (1000, 77)])
def test_grid_kernels_with_bases_match_plain(cuda, dtype, nf, bases):
    """Each of the four grid kernels with nonzero bases against its plain
    version with the same bases, dropout 0.3."""
    args, g = _args(cuda, 37, 45) if nf is None else _args_b(cuda, nf, 37, 45)
    fwd, bwd, pfwd, pbwd = (
        (gd.launch_fwd, gd.launch_bwd, gd.grid_decoder_plain,
         gd.grid_decoder_plain_bwd) if nf is None else
        (gd.launch_fwd_batched, gd.launch_bwd_batched,
         gd.grid_decoder_batched_plain, gd.grid_decoder_batched_plain_bwd))
    out = fwd(*args, 0.3, True, dtype, *bases)
    grads = bwd(*args, 0.3, True, dtype, g, *bases)
    ref = pfwd(*args, 0.3, True, dtype, *bases)
    refs = pbwd(*args, 0.3, True, dtype, g, *bases)
    torch.cuda.synchronize()
    for a, b in zip((out, *grads), (ref, *refs)):
        assert a.shape == b.shape and _rel(a, b) <= TOL[dtype]
    assert not torch.equal(out, fwd(*args, 0.3, True, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_fwd_on_a_block_is_the_block_of_the_whole(cuda, dtype):
    """A forward launch on a block of the grid, with the block's bases, is
    that block of one launch on the whole grid, bit for bit (a cell's
    logit depends on its own inputs and its global row and column)."""
    args, _ = _args_b(cuda, 3, 37, 45, seed=3)
    whole = gd.launch_fwd_batched(*args, 0.3, True, dtype)
    for r0, r1, c0, c1 in ((0, 37, 23, 45), (5, 30, 0, 17), (36, 37, 44, 45)):
        blk = gd.launch_fwd_batched(args[0][:, r0:r1].contiguous(),
                                    args[1][:, c0:c1].contiguous(),
                                    *args[2:], 0.3, True, dtype, r0, c0)
        assert torch.equal(blk, whole[:, r0:r1, c0:c1])


@pytest.mark.parametrize("flag", ["--fold_parallel", "--seed_parallel"])
def test_stacked_trainer_launches_batched_kernels(cuda, tmp_path, flag):
    """Two folds of two seeds through the CLI: one batched forward and one
    batched backward launch per stacked step, plus two batched forward
    launches per eval interval; no single-fold launch."""
    from dream_gnn_tpu_torch.train.cli import main

    for k in gd.LAUNCHES:
        gd.LAUNCHES[k] = 0
    main(["--data_name", "Gdataset", "--seeds", "1", "2", "--folds", "0", "1",
          "--train_max_iter", "3", "--train_valid_interval", "2",
          "--layers", "2", "--gcn_agg_units", "96", "--gcn_out_units", "32",
          "--nhid1", "64", "--nhid2", "32", "--save_dir", str(tmp_path), flag])
    runs = 2 if flag == "--fold_parallel" else 1
    assert gd.LAUNCHES == {"fwd": 0, "bwd": 0, "fwd_b": runs * (2 + 2),
                           "bwd_b": runs * 2}
    assert (tmp_path / "seed_2" / "test_metric2.csv").exists()


def _bwd(args, rate, dtype, g, nf):
    """Kernel and plain backward: single-fold for ``nf`` None, else batched."""
    if nf is None:
        return (gd.launch_bwd(*args, rate, True, dtype, g),
                gd.grid_decoder_plain_bwd(*args, rate, True, dtype, g))
    return (gd.launch_bwd_batched(*args, rate, True, dtype, g),
            gd.grid_decoder_batched_plain_bwd(*args, rate, True, dtype, g))


def _grid_case(dev, nf, nd, nv, seed=0):
    return _args(dev, nd, nv, seed) if nf is None \
        else _args_b(dev, nf, nd, nv, seed)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("nv", [1, 7, 33, 313])
@pytest.mark.parametrize("nd", [1, 15, 17, 37, 593])
def test_grid_bf16_bwd_matches_plain_across_tiles(cuda, nd, nv, nf, rate):
    """The tensor-core backward (bf16) at shapes that straddle its 4 x 32
    tiles and its 16-cell mma rows, for one fold (F = 1) and F = 3."""
    args, g = _grid_case(cuda, nf, nd, nv, seed=nd + nv)
    grads, refs = _bwd(args, rate, torch.bfloat16, g, nf)
    torch.cuda.synchronize()
    for a, b in zip(grads, refs):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_grid_bwd_gates_at_zero_and_subnormal(cuda, dtype, rate):
    """Units where a1 is exactly 0 (gate shut) or a subnormal positive
    (gate open, though rnd(h1d) may round to 0), and columns where a2 is
    exactly 0 (gate shut): the kernel gates on a1 > 0 and a2 > 0 as the
    plain version does."""
    nd, nv = 37, 45
    args, g = _args(cuda, nd, nv, seed=5)
    pd, pv, b1, w2, b2 = (x.clone() for x in args[:5])
    s1, s2 = slice(0, 16), slice(0, 4)
    pattern = torch.tensor([0.0, 1e-45, 1e-39, 3e-38, -0.3, 0.4],
                           device=cuda)
    pd[:, s1] = pattern[torch.arange(nd, device=cuda) % 6][:, None]
    pv[:, s1] = 0.0
    b1[s1] = 0.0
    w2[:, s2] = 0.0
    b2[s2] = 0.0
    args = [pd, pv, b1, w2, b2, *args[5:]]
    grads = gd.launch_bwd(*args, rate, True, dtype, g)
    refs = gd.grid_decoder_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    # The case bites: the rows of subnormal a1 carry dPd in those units,
    # those of a1 = 0 none, and a2 = 0 leaves db2 exactly 0 there.
    dpd = refs[0][:, s1]
    sub = torch.arange(nd, device=cuda) % 6
    assert float(dpd[(sub == 1) | (sub == 2)].abs().max()) \
        > 0.05 * float(refs[0].abs().max())
    assert not bool(dpd[sub == 0].any())
    assert not bool(refs[4][s2].any()) and not bool(grads[4][s2].any())
    for a, b in zip(grads, refs):
        assert _rel(a, b) <= TOL[dtype]


def test_grid_bf16_bwd_sums_a2_in_unit_order_at_a_midpoint(cuda):
    """One cell whose a2[0] is a bf16 midpoint of h2d when summed in unit
    order and one f32 ulp above it when summed in reverse
    (tests/test_torch_port_grid_sum_order.py): the kernel takes the unit
    order, so dw3[0] = rnd(1 + 2^-8) = 1."""
    w2 = torch.zeros(128, 64, device=cuda)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25], device=cuda)
    w2[:, 1:] = 2.0 ** -10
    args = [torch.ones(1, 128, device=cuda), torch.zeros(1, 128, device=cuda),
            torch.zeros(128, device=cuda), w2, torch.zeros(64, device=cuda),
            torch.ones(64, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda)]
    dw3 = gd.launch_bwd(*args, 0.0, True, torch.bfloat16,
                        torch.ones(1, 1, device=cuda))[5]
    assert float(dw3[0]) == 1.0
    assert bool((dw3[1:] == 0.125).all())


@pytest.mark.parametrize("nf", [None, 3])
def test_grid_bf16_bwd_repeats_bit_for_bit(cuda, nf):
    """Two launches of the tensor-core backward give the same bits, at
    Gdataset width, for one fold and for F = 3."""
    args, g = _grid_case(cuda, nf, 593, 313, seed=3)
    launch = gd.launch_bwd if nf is None else gd.launch_bwd_batched
    a = launch(*args, 0.3, True, torch.bfloat16, g)
    b = launch(*args, 0.3, True, torch.bfloat16, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _edge_args(dev, nf, nd, nv, ne, seed=0):
    """Edge kernel inputs for nf folds (nf None: no fold axis): tables,
    weights, edges (random pairs, repeats allowed), seeds, and g."""
    rng = np.random.default_rng(seed)
    lead = () if nf is None else (nf,)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    edges = np.stack([rng.integers(0, nd, (*lead, ne)),
                      rng.integers(0, nv, (*lead, ne))], axis=-2)
    seeds = [77] if nf is None else rng.integers(0, 2 ** 31 - 1, nf)
    return ([t(rng.normal(0, 0.5, (*lead, nd, 128))),
             t(rng.normal(0, 0.5, (*lead, nv, 128))),
             t(rng.uniform(-.1, .1, (*lead, 128))),
             t(rng.uniform(-.1, .1, (*lead, 128, 64))),
             t(rng.uniform(-.1, .1, (*lead, 64))),
             t(rng.uniform(-.2, .2, (*lead, 64))),
             torch.tensor(edges, dtype=torch.int32, device=dev),
             torch.tensor(seeds, dtype=torch.int32, device=dev)],
            t(rng.normal(0, 1, (*lead, ne))))


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1, 1), (130, 1, 1023), (1, 130, 1025),
                                   (37, 23, 300), (130, 130, 4000)])
def test_edge_kernel_matches_plain(cuda, dtype, rate, shape):
    """Ragged edge counts (1, 1023, 1025) and node counts (1, 130): logits
    and the six gradients against edge_decoder_plain(_bwd)."""
    args, g = _edge_args(cuda, None, *shape)
    out = ed.launch_fwd(*args, rate, True, dtype)
    ref = ed.edge_decoder_plain(*args, rate, True, dtype)
    grads = ed.launch_bwd(*args, rate, True, dtype, g)
    refs = ed.edge_decoder_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    for a, b in zip((out, *grads), (ref, *refs)):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 130, 1, 1025),
                                   (3, 37, 23, 300), (10, 130, 130, 1023)])
def test_batched_edge_kernel_matches_plain(cuda, dtype, rate, shape):
    args, g = _edge_args(cuda, *shape)
    out = ed.launch_fwd_batched(*args, rate, True, dtype)
    ref = ed.edge_decoder_batched_plain(*args, rate, True, dtype)
    grads = ed.launch_bwd_batched(*args, rate, True, dtype, g)
    refs = ed.edge_decoder_batched_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    for a, b in zip((out, *grads), (ref, *refs)):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_edge_bf16_tolerance_sees_missing_rounding(cuda, rate):
    """The fp32 edge kernel against the bf16 plain version fails the bf16
    tolerance in every output that the rounding moves (all but db2)."""
    args, g = _edge_args(cuda, None, 130, 130, 4000)
    out = ed.launch_fwd(*args, rate, True, torch.float32)
    ref = ed.edge_decoder_plain(*args, rate, True, torch.bfloat16)
    dpd, dpv, db1, dw2, _, dw3 = ed.launch_bwd(*args, rate, True,
                                               torch.float32, g)
    rpd, rpv, rb1, rw2, _, rw3 = ed.edge_decoder_plain_bwd(
        *args, rate, True, torch.bfloat16, g)
    for a, b in zip((out, dpd, dpv, db1, dw2, dw3),
                    (ref, rpd, rpv, rb1, rw2, rw3)):
        assert _rel(a, b) > TOL[torch.bfloat16]


@pytest.mark.parametrize("batched", [False, True])
def test_edge_kernel_is_deterministic(cuda, batched):
    """Two backward launches give the same bits: no float atomics."""
    args, g = _edge_args(cuda, 3 if batched else None, 64, 96, 5000, seed=1)
    launch = ed.launch_bwd_batched if batched else ed.launch_bwd
    a = launch(*args, 0.3, True, torch.bfloat16, g)
    b = launch(*args, 0.3, True, torch.bfloat16, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_edge_fold_equals_single_fold_kernel(cuda, dtype):
    """Fold f of one batched forward launch is the single-fold kernel called
    with seed[f], bit for bit; the backward within the tolerance (its split
    into blocks, and so the order of its partial sums, depends on F)."""
    args, g = _edge_args(cuda, 3, 37, 45, 20000, seed=2)
    out = ed.launch_fwd_batched(*args, 0.3, True, dtype)
    grads = ed.launch_bwd_batched(*args, 0.3, True, dtype, g)
    for f in range(3):
        one = [a[f].contiguous() for a in args[:7]] \
            + [args[7][f:f + 1].contiguous()]
        assert torch.equal(out[f], ed.launch_fwd(*one, 0.3, True, dtype))
        for a, b in zip(grads, ed.launch_bwd(*one, 0.3, True, dtype,
                                             g[f].contiguous())):
            assert _rel(a[f], b) <= TOL[dtype]


def test_edge_kernel_equals_grid_kernel_cells(cuda):
    """In fp32 with dropout on, the edge kernel's logit of edge (i, j) is
    the grid kernel's cell [i, j]: the same masks, the same arithmetic."""
    args, _ = _edge_args(cuda, None, 130, 77, 3000, seed=3)
    edges = args[6]
    out = ed.launch_fwd(*args, 0.3, True, torch.float32)
    grid = gd.launch_fwd(*args[:6], args[7], 0.3, True, torch.float32)
    cells = grid[edges[0].long(), edges[1].long()]
    assert _rel(out, cells) <= 1e-4


def test_edge_wrapper_counts_launches_and_checks_inputs(cuda):
    args, g = _edge_args(cuda, None, 8, 8, 50)
    b3 = torch.zeros(1, device=cuda)
    before = dict(ed.LAUNCHES)
    ed.fused_decoder(*args[:6], b3, *args[6:], 0.0, False, torch.bfloat16)
    assert ed.LAUNCHES["fwd"] == before["fwd"] + 1
    bad = list(args)
    bad[6] = args[6].long()
    with pytest.raises(ValueError, match="edges"):
        ed.launch_fwd(*bad, 0.0, False, torch.bfloat16)
    # An ordering over another disease count (two column blocks, not one),
    # or of a shorter list.
    order = ed.edge_order(args[6][0], args[6][1], 8, 40)
    with pytest.raises(ValueError, match="order.split_edge"):
        ed.launch_bwd(*args, 0.0, False, torch.bfloat16, g, order)
    order = ed.edge_order(args[6][0, :40], args[6][1, :40], 8, 8)
    with pytest.raises(ValueError, match="order.perm"):
        ed.launch_bwd(*args, 0.0, False, torch.bfloat16, g, order)


def _decoder_launches():
    return {"grid": dict(gd.LAUNCHES), "edge": dict(ed.LAUNCHES)}


def _zero_launches():
    for counts in (gd.LAUNCHES, ed.LAUNCHES):
        for k in counts:
            counts[k] = 0


ZERO = {"fwd": 0, "bwd": 0, "fwd_b": 0, "bwd_b": 0}


@pytest.mark.parametrize("flags,edge", [
    ([], {"fwd": 2 + 2, "bwd": 2, "fwd_b": 0, "bwd_b": 0}),
    (["--fold_parallel", "--folds", "1"],
     {"fwd": 0, "bwd": 0, "fwd_b": 2 + 2, "bwd_b": 2}),
    (["--decoder_backend", "xla"], ZERO)])
def test_edges_trainer_launches_edge_kernels(cuda, tmp_path, flags, edge):
    """An edges-mode CLI run launches the edge kernels (one forward and one
    backward per step, two forwards per eval interval) and no grid kernel;
    with the plain backend no decoder kernel at all."""
    from dream_gnn_tpu_torch.train.cli import main

    _zero_launches()
    main(["--data_name", "Gdataset", "--decode_mode", "edges", "--seeds", "1",
          "--folds", "0", "--train_max_iter", "3", "--train_valid_interval",
          "2", "--layers", "2", "--gcn_agg_units", "96", "--gcn_out_units",
          "32", "--nhid1", "64", "--nhid2", "32", "--save_dir", str(tmp_path),
          *flags])
    assert _decoder_launches() == {"grid": ZERO, "edge": edge}


_MATMUL = torch.matmul


def _unit_order_matmul(x, y):
    """torch.matmul, but a product of depth 64 or 128 (the decoder's a2 =
    rnd(h1d) @ rnd(w2) and dh1 = rnd(da2) @ rnd(w2)^T) summed one unit at a
    time in unit order, in f32: a product of two bf16 values is exact in
    f32, so each step is the fused multiply-add of a sequential sum."""
    k = x.shape[-1]
    if k not in (64, 128) or y.shape[-2] != k:
        return _MATMUL(x, y)
    acc = torch.zeros(*x.shape[:-1], y.shape[-1], device=x.device)
    for u in range(k):
        acc = acc + x[..., u:u + 1] * y[..., u:u + 1, :]
    return acc


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("nv", [1, 313])
@pytest.mark.parametrize("nd", [1, 37, 593])
@pytest.mark.parametrize("ne", [1, 15, 16, 17, 127, 128, 129, 1023, 4097])
def test_edge_bf16_bwd_matches_plain_across_tiles(cuda, monkeypatch, ne, nd,
                                                  nv, nf, rate):
    """The tensor-core edge backward (bf16) at edge counts that straddle
    its 16-edge mma rows and 128-edge tiles, for one fold (F = 1) and
    F = 3: all six gradients finite and within the tolerance of the plain
    version with its a2 and dh1 products summed in unit order.

    The kernel sums those in unit order wherever the order can move a bf16
    rounding (tests/test_torch_port_edge_sum_order.py).  cuBLAS picks its
    order by shape, and at 128 and 129 edges over the 593 x 313 tables it
    is not unit order: there the plain version's own dw3, or its dPd and
    dPv, differ from its unit-order result by 1.2e-4 and 9e-5 of their
    largest value (H100), while the kernel matches the unit-order result
    bit for bit in those gradients."""
    args, g = _edge_args(cuda, nf, nd, nv, ne, seed=ne + nd + nv)
    launch, plain = (ed.launch_bwd, ed.edge_decoder_plain_bwd) if nf is None \
        else (ed.launch_bwd_batched, ed.edge_decoder_batched_plain_bwd)
    grads = launch(*args, rate, True, torch.bfloat16, g)
    monkeypatch.setattr(torch, "matmul", _unit_order_matmul)
    refs = plain(*args, rate, True, torch.bfloat16, g)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for a, b in zip(grads, refs):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= TOL[torch.bfloat16]


def test_edge_bf16_bwd_sums_a2_in_unit_order_at_a_midpoint(cuda):
    """One edge whose a2[0] is a bf16 midpoint of h2d when summed in unit
    order and one f32 ulp above it when summed in reverse
    (tests/test_torch_port_edge_sum_order.py): the kernel takes the unit
    order, so dw3[0] = rnd(1 + 2^-8) = 1."""
    w2 = torch.zeros(128, 64, device=cuda)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25], device=cuda)
    w2[:, 1:] = 2.0 ** -10
    args = [torch.ones(1, 128, device=cuda), torch.zeros(1, 128, device=cuda),
            torch.zeros(128, device=cuda), w2, torch.zeros(64, device=cuda),
            torch.ones(64, device=cuda),
            torch.zeros(2, 1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda)]
    dw3 = ed.launch_bwd(*args, 0.0, True, torch.bfloat16,
                        torch.ones(1, device=cuda))[5]
    assert float(dw3[0]) == 1.0
    assert bool((dw3[1:] == 0.125).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_edge_bwd_gates_at_zero_and_subnormal(cuda, dtype, rate):
    """Units where a1 is exactly 0 (gate shut) or a subnormal positive
    (gate open, though rnd(h1d) may round to 0), and columns where a2 is
    exactly 0 (gate shut): the kernel gates on a1 > 0 and a2 > 0 as the
    plain version does.  In bf16 the tables round first, so 1e-45 becomes
    0 there and 1e-39 stays a subnormal."""
    nd, nv = 37, 45
    args, g = _edge_args(cuda, None, nd, nv, 3000, seed=5)
    pd, pv, b1, w2, b2 = (x.clone() for x in args[:5])
    s1, s2 = slice(0, 16), slice(0, 4)
    pattern = torch.tensor([0.0, 1e-45, 1e-39, 3e-38, -0.3, 0.4],
                           device=cuda)
    sub = torch.arange(nd, device=cuda) % 6
    pd[:, s1] = pattern[sub][:, None]
    pv[:, s1] = 0.0
    b1[s1] = 0.0
    w2[:, s2] = 0.0
    b2[s2] = 0.0
    args = [pd, pv, b1, w2, b2, *args[5:]]
    grads = ed.launch_bwd(*args, rate, True, dtype, g)
    refs = ed.edge_decoder_plain_bwd(*args, rate, True, dtype, g)
    torch.cuda.synchronize()
    # The case bites: the drugs of subnormal a1 carry dPd in those units,
    # those of a1 = 0 none, and a2 = 0 leaves db2 exactly 0 there.
    dpd = refs[0][:, s1]
    assert float(dpd[(sub == 1) | (sub == 2)].abs().max()) \
        > 0.05 * float(refs[0].abs().max())
    assert not bool(dpd[sub == 0].any())
    assert not bool(refs[4][s2].any()) and not bool(grads[4][s2].any())
    for a, b in zip(grads, refs):
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("nf", [None, 3])
def test_edge_bf16_bwd_repeats_bit_for_bit(cuda, nf):
    """Two launches of the tensor-core edge backward give the same bits,
    over Gdataset-sized tables, for one fold and for F = 3."""
    args, g = _edge_args(cuda, nf, 593, 313, 20000, seed=3)
    launch = ed.launch_bwd if nf is None else ed.launch_bwd_batched
    a = launch(*args, 0.3, True, torch.bfloat16, g)
    b = launch(*args, 0.3, True, torch.bfloat16, g)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _unique_edges(args, g, case, seed):
    """``args`` and ``g`` over unique random pairs of their tables: as the
    loader lists a fold's candidates ("padded": all but the last 100 edges
    real, then (0, 0) padding with g = 0), or "sparse": the first column
    block empty and a third of the drugs absent from each other one."""
    nd, nv = args[0].shape[-2], args[1].shape[-2]
    edges, g = args[6].clone(), g.clone()
    ne = edges.shape[-1]
    n_real = ne - 100 if case == "padded" else ne
    rng = np.random.default_rng(seed)
    for e, gf in zip(edges.view(-1, 2, ne), g.view(-1, ne)):
        cells = rng.permutation(nd * nv)
        if case == "sparse":
            d, j = cells // nv, cells % nv
            cells = cells[(j >= 32) & ((d + j // 32) % 3 > 0)]
        cells = torch.tensor(cells[:n_real], device=edges.device)
        e.zero_()
        e[0, :n_real], e[1, :n_real] = cells // nv, cells % nv
        gf[n_real:] = 0.0
    return args[:6] + [edges, args[7]], g


@pytest.mark.parametrize("case", ["repeats", "padded", "sparse"])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_bwd_sums_nodes_over_the_ordering(cuda, monkeypatch, dtype, nf,
                                               case):
    """The backward's node sums over the edges' ordering by column block
    and drug, at Gdataset-sized tables (313 diseases, 10 column blocks,
    the last of 25) with 20,000 edges: for one fold each column block's 13
    parts go to 13 blocks, at F = 3 too.  Random pairs with repeats;
    unique pairs padded with (0, 0) at g = 0 as the loader pads a fold; or
    unique pairs leaving the first column block empty and a third of the
    drugs without edges in each other one (zero dPd partial rows).
    All six gradients are held to the plain version with its depth-64/128
    products in unit order, within the tolerance: dPd and dPv sum the same
    rnd(da1) rows as its list-order scatter_add_, in another f32 order (by
    drug within a column block, then over the column blocks; by column
    within a tile, then over the tiles and blocks).  Two launches give the
    same bits, and so does the ordering built in the launch."""
    args, g = _edge_args(cuda, nf, 593, 313, 20_000, seed=9)
    if case != "repeats":
        args, g = _unique_edges(args, g, case, seed=9)
    edges = args[6]
    order = ed.edge_order(edges[..., 0, :], edges[..., 1, :], 593, 313)
    n_part = order.split_edge.shape[-1] - 1
    assert n_part == 13 and ed.bwd_split(nf or 1, 313, n_part) == 13
    launch, plain = (ed.launch_bwd, ed.edge_decoder_plain_bwd) if nf is None \
        else (ed.launch_bwd_batched, ed.edge_decoder_batched_plain_bwd)
    grads = launch(*args, 0.3, True, dtype, g, order)
    again = launch(*args, 0.3, True, dtype, g)
    monkeypatch.setattr(torch, "matmul", _unit_order_matmul)
    refs = plain(*args, 0.3, True, dtype, g)
    monkeypatch.undo()
    torch.cuda.synchronize()
    for a, b, c in zip(grads, again, refs):
        assert a.shape == c.shape
        assert torch.equal(a, b)
        assert _rel(a, c) <= TOL[dtype]


@pytest.mark.parametrize("nf", [None, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_bwd_allocates_no_per_edge_buffer(cuda, dtype, nf):
    """A backward launch over 50,000 edges a fold, ordering given, adds
    less to the peak allocation than an (F, E, 128) f32 buffer would take:
    its partials and outputs are per node and per block."""
    args, g = _edge_args(cuda, nf, 593, 313, 50_000, seed=4)
    edges = args[6]
    order = ed.edge_order(edges[..., 0, :], edges[..., 1, :], 593, 313)
    launch = ed.launch_bwd if nf is None else ed.launch_bwd_batched
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = launch(*args, 0.3, True, dtype, g, order)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    assert added < (nf or 1) * 50_000 * 128 * 4


@pytest.mark.parametrize("dtype,warps", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
def test_edge_bwd_occupancy_is_the_launch_block(cuda, dtype, warps):
    """bwd_occupancy counts the blocks of the launch's own size (4 warps in
    fp32, 8 on the tensor cores) that fit an SM, and at least one does."""
    blocks, resident = ed.bwd_occupancy(dtype)
    assert blocks >= 1
    assert resident == blocks * warps


# ---------------------------------------------------------------------------
# The bf16 forwards on the tensor cores: grid_fwd_mma_kernel and
# edge_fwd_mma_kernel.

def _fwd(kind, args, rate, train, nf):
    """Kernel and plain forward of ``kind`` ("grid" or "edge"), bf16:
    single-fold for ``nf`` None, else batched."""
    mod = gd if kind == "grid" else ed
    if nf is None:
        launch, plain = mod.launch_fwd, (gd.grid_decoder_plain if kind == "grid"
                                         else ed.edge_decoder_plain)
    else:
        launch, plain = mod.launch_fwd_batched, (
            gd.grid_decoder_batched_plain if kind == "grid"
            else ed.edge_decoder_batched_plain)
    return (launch(*args, rate, train, torch.bfloat16),
            plain(*args, rate, train, torch.bfloat16))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("nv", [1, 7, 33, 313])
@pytest.mark.parametrize("nd", [1, 17, 37, 593])
def test_grid_bf16_fwd_matches_plain_across_tiles(cuda, nd, nv, nf, rate,
                                                  train):
    """The tensor-core grid forward at shapes that straddle its 4 x 32 tiles
    and its 16-cell mma rows (nd, nv not multiples of 4 or 32), for one
    fold and F = 3, in training and in eval."""
    args, _ = _grid_case(cuda, nf, nd, nv, seed=nd + nv)
    out, ref = _fwd("grid", args, rate, train, nf)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nf", [None, 3])
@pytest.mark.parametrize("nodes", [(37, 45), (593, 313)])
@pytest.mark.parametrize("ne", [1, 15, 16, 17, 127, 128, 129, 1023, 4097])
def test_edge_bf16_fwd_matches_plain_across_tiles(cuda, ne, nodes, nf, rate,
                                                  train):
    """The tensor-core edge forward at edge counts that straddle its 16-edge
    mma rows and 128-edge tiles (ne not a multiple of 128), on random pairs
    in no order and with repeats, for one fold and F = 3."""
    args, _ = _edge_args(cuda, nf, *nodes, ne, seed=ne + sum(nodes))
    args[6][..., -1] = args[6][..., 0]          # a repeated pair
    if ne >= 15:
        assert not bool((args[6][..., 0, :].diff(dim=-1) >= 0).all())
    out, ref = _fwd("edge", args, rate, train, nf)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= TOL[torch.bfloat16]


def _gate_and_midpoint_case(dev, kind, nd, nv):
    """Every cell (or edge) with h1d = 1 in all units and a2 = 1 + 2^-8 in
    column 0, a bf16 midpoint of h2d up to the last bit of its f32 sum, and
    a2 = 0 in column 1, the relu gate, up to the same (w2[:4, 1] = (1,
    2^-25, 2^-25, 2^-25), b2[1] = -1); the other columns are 0.125."""
    w2 = torch.zeros(128, 64, device=dev)
    w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25], device=dev)
    w2[:4, 1] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25],
                             device=dev)
    w2[:, 2:] = 2.0 ** -10
    b2 = torch.zeros(64, device=dev)
    b2[1] = -1.0
    args = [torch.ones(nd, 128, device=dev), torch.zeros(nv, 128, device=dev),
            torch.zeros(128, device=dev), w2, b2, torch.ones(64, device=dev)]
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    if kind == "grid":
        return args + [seed]
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, nd, 300), rng.integers(0, nv, 300)])
    return args + [torch.tensor(edges, dtype=torch.int32, device=dev), seed]


@pytest.mark.parametrize("kind", ["grid", "edge"])
def test_bf16_fwd_at_the_gate_and_a_midpoint(cuda, kind):
    """a2 at the relu gate and at a bf16 midpoint of h2d: the forward does
    not round h2d, so the kernel's own sum order moves the logit by f32
    noise only (tests/test_torch_port_fwd_sum_order.py), and every cell,
    whatever its place in the tile, gives the same bits."""
    args = _gate_and_midpoint_case(cuda, kind, 37, 45)
    out, ref = _fwd(kind, args, 0.0, False, None)
    torch.cuda.synchronize()
    expect = 1.0 + 2.0 ** -8 + 62 * 0.125
    assert abs(float(ref.flatten()[0]) - expect) <= 2.0 ** -20
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert bool((out == out.flatten()[0]).all())


@pytest.mark.parametrize("kind", ["grid", "edge"])
@pytest.mark.parametrize("nf", [None, 3])
def test_bf16_fwd_repeats_bit_for_bit(cuda, kind, nf):
    """Two launches of a tensor-core forward give the same bits, over
    Gdataset-sized tables, for one fold and for F = 3."""
    if kind == "grid":
        args, _ = _grid_case(cuda, nf, 593, 313, seed=3)
    else:
        args, _ = _edge_args(cuda, nf, 593, 313, 20000, seed=3)
    a, _ = _fwd(kind, args, 0.3, True, nf)
    b, _ = _fwd(kind, args, 0.3, True, nf)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["grid", "edge"])
@pytest.mark.parametrize("dtype,warps", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
def test_fwd_occupancy_is_the_launch_block(cuda, kind, dtype, warps):
    """fwd_occupancy counts the blocks of the launch's own size (4 warps in
    fp32, 8 on the tensor cores) that fit an SM; the bf16 forward's split
    assumes two (FWD_RESIDENT in csrc/decoder_common.cuh)."""
    blocks, resident = (gd if kind == "grid" else ed).fwd_occupancy(dtype)
    assert blocks >= (2 if dtype == torch.bfloat16 else 1)
    assert resident == blocks * warps


# ---------------------------------------------------------------------------
# The scale path's kernels: the segmented sum behind spmm_slab and
# seq_scatter (csrc/spmm.cu), and the scale decoder's K2, B1 and mirror
# (csrc/scale_decoder.cu).

def _csr_case(dev, n_src, n_dst, nnz, d, seed=0):
    """A random relation with repeated, zero-weight and empty-row edges:
    its layout pair on each of ``dev`` and the CPU, and x on ``dev``."""
    from dream_gnn_tpu_torch.graph.slabbed import slabbed_pair_from_arrays

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, nnz)
    dst = rng.integers(0, max(n_dst // 2, 1), nnz)     # rows past n_dst/2 empty
    val = (rng.random(nnz) + 0.5).astype(np.float32)
    val[rng.random(nnz) < 0.1] = 0.0
    pairs = [slabbed_pair_from_arrays(src, dst, val, n_src, n_dst, device=d_)
             for d_ in (dev, "cpu")]
    x = torch.tensor(rng.normal(size=(n_src, d)).astype(np.float32),
                     device=dev)
    return pairs, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, 16), (300, 250, 3000, 16),
                                   (300, 250, 3000, 128), (70, 900, 5000, 3),
                                   (2000, 1500, 40000, 128),
                                   *[(300, 250, 3000, d)
                                     for d in (1, 4, 12, 127, 130, 384)]])
def test_spmm_kernel_matches_plain(cuda, dtype, shape):
    """Forward and transposed layouts; d = 1, 3, 4, 12, 127 and 130 (one
    value per lane), 16 (four lane groups a warp), 128 (two) and 384 (one
    group, two column passes), against segment_sum_plain on the same
    tensors; twice the same bits."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    (pair, _), x = _csr_case(cuda, *shape)
    rounded = dtype == torch.bfloat16
    for g in (pair.fwd, pair.bwd):
        xr = torch.randn(g.n_src, x.shape[1], device=cuda).to(dtype)
        out = sp.launch_segment_sum(g.row_ptr, g.src, g.val, xr, rounded,
                                    pieces=g.pieces)
        ref = sp.segment_sum_plain(g.row_ptr, g.src, g.val, xr, rounded)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (g.n_dst, x.shape[1])
        assert _rel(out, ref) <= TOL[dtype]
        assert torch.equal(out, sp.launch_segment_sum(
            g.row_ptr, g.src, g.val, xr, rounded, pieces=g.pieces))


def test_spmm_slab_autograd_matches_cpu(cuda):
    """spmm_slab on the card (kernel, forward and backward) against the
    same call on the CPU (plain version)."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    pairs, x = _csr_case(cuda, 300, 250, 3000, 128, seed=4)
    before = dict(sp.LAUNCHES)
    res = []
    for p, xx in zip(pairs, (x, x.cpu())):
        xx = xx.clone().requires_grad_(True)
        out = sp.spmm_slab(p, xx)
        (out * out).sum().backward()
        res.append((out.detach().cpu(), xx.grad.cpu()))
    assert sp.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    for a, b in zip(*res):
        assert _rel(a, b) <= 1e-4


# The segment sum's roundings as launch_segment_sum's (rounded, round_x,
# round_val): MODE_F32, MODE_RX, MODE_MSG and MODE_RX_RV of csrc/spmm.cu.
MODES = {"f32": (False, True, False), "rx": (True, True, False),
         "msg": (True, False, False), "rx_rv": (True, True, True)}
# Rows of 0, 1, 31, 33 and 1,000 entries among others: one lane group
# short of and one entry past a warp's batch of indices, and many batches.
ROW_LENGTHS = [0, 1, 31, 33, 1000, 0, 2, 17, 64, 3]


def _launch(ptr, src, val, x, *mode):
    """launch_segment_sum with the pieces of ptr's rows, which its narrow
    path (d % 8 != 0) reads and its wide path ignores."""
    from dream_gnn_tpu_torch.graph.csr import segment_pieces
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    return sp.launch_segment_sum(ptr, src, val, x, *mode,
                                 pieces=segment_pieces(ptr))


def _segment_case(dev, d, n_src=700, seed=0):
    """(ptr, src, val, x) of ROW_LENGTHS' rows over random sources, with
    zero weights; x has a row per entry too, for a null src."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(ROW_LENGTHS)
    nnz = int(counts.sum())
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32, device=dev)
    src = torch.tensor(rng.integers(0, n_src, nnz), dtype=torch.int32,
                       device=dev)
    val = (rng.random(nnz) + 0.5).astype(np.float32)
    val[rng.random(nnz) < 0.1] = 0.0
    x = rng.normal(size=(max(n_src, nnz), d)).astype(np.float32)
    return ptr, src, torch.tensor(val, device=dev), torch.tensor(x, device=dev)


@pytest.mark.parametrize("with_val", [True, False])
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d", [1, 4, 12, 127, 128, 130, 384])
def test_segment_sum_kernel_matches_plain(cuda, d, mode, x_dtype, gather,
                                          with_val):
    """Every rounding, f32 and bf16 x, a null src (the scatter) and a null
    val (weight 1), at d taking each width path: the kernel against
    segment_sum_plain, empty rows exactly 0, twice the same bits."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    ptr, src, val, x = _segment_case(cuda, d)
    args = (ptr, src if gather else None, val if with_val else None,
            x.to(x_dtype), *MODES[mode])
    out = _launch(*args)
    ref = sp.segment_sum_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (len(ROW_LENGTHS), d)
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    assert not out[torch.tensor(ROW_LENGTHS, device=cuda) == 0].any()
    assert torch.equal(out, _launch(*args))


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("d", [4, 128])
def test_segment_sum_kernel_empty_matrix(cuda, d, gather):
    """No entries (every row empty) gives zeros; no rows an empty output."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    x = torch.randn(6, d, device=cuda).bfloat16()
    src = torch.zeros(0, dtype=torch.int32, device=cuda) if gather else None
    val = torch.zeros(0, device=cuda)
    for n_rows in (5, 0):
        ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=cuda)
        out = _launch(ptr, src, val, x, True)
        torch.cuda.synchronize()
        assert out.shape == (n_rows, d) and not out.any()


@pytest.mark.parametrize("d", [12, 16, 64, 128, 384, 50, 75])
def test_segment_sum_split_ignores_gather_and_x_dtype(cuda, d):
    """A row is split and summed alike whatever reads x: an identity src
    gives the bits of a null src, and an f32 x of bf16 values the bits of
    the bf16 x, in every rounding (so the grouped scatter equals
    seq_scatter)."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    ptr, _, val, x = _segment_case(cuda, d)
    nnz = sum(ROW_LENGTHS)
    ident = torch.arange(nnz, dtype=torch.int32, device=cuda)
    xb = x[:nnz].bfloat16()
    for mode in MODES.values():
        a = _launch(ptr, ident, val, xb, *mode)
        b = _launch(ptr, None, val, xb, *mode)
        c = _launch(ptr, None, val, xb.float(), *mode)
        assert torch.equal(a, b) and torch.equal(b, c), mode


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128, 50, 75])
def test_segment_sum_split_ignores_x_address(cuda, d, x_dtype):
    """An x that starts one element past a 16-byte boundary gives the bits
    of the same values in fresh storage, in every rounding (at d = 50 the
    narrow path then reads one value a lane where it read two)."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    ptr, src, val, x = _segment_case(cuda, d)
    x = x.to(x_dtype)
    buf = torch.empty(x.numel() + 1, dtype=x_dtype, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for mode in MODES.values():
        assert torch.equal(_launch(ptr, src, val, shifted, *mode),
                           _launch(ptr, src, val, x, *mode)), mode


# The narrow path (d % 8 != 0) sums pieces of at most PIECE entries of a
# row: rows at, under and over a piece, and the long rows of a skewed
# layout (GCMC's movies); "short" has no row over a piece.
SKEWED_ROWS = {"skewed": [0, 1, 127, 128, 129, 1000, 5000, 20_000,
                          *[(7 * i) % 90 for i in range(300)]],
               "short": [0, 1, 127, 128, 0, *[(7 * i) % 90 for i in range(300)]]}


def _skewed_case(dev, d, rows="skewed", n_src=3000, seed=0, pow2=False):
    """(ptr, src, val, x) over SKEWED_ROWS[rows]; with ``pow2`` the weights
    are powers of two (or 0), so that every message is exact in f32."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(SKEWED_ROWS[rows])
    nnz = int(counts.sum())
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                       dtype=torch.int32, device=dev)
    src = torch.tensor(rng.integers(0, n_src, nnz), dtype=torch.int32,
                       device=dev)
    val = (2.0 ** rng.integers(-2, 3, nnz) if pow2
           else rng.random(nnz) + 0.5).astype(np.float32)
    val[rng.random(nnz) < 0.1] = 0.0
    x = rng.normal(size=(max(n_src, nnz), d)).astype(np.float32)
    return ptr, src, torch.tensor(val, device=dev), torch.tensor(x, device=dev)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 50, 75])
def test_narrow_segment_sum_matches_plain(cuda, d, x_dtype, mode):
    """Skewed rows of up to 20,000 entries, every rounding, f32 and bf16
    x: the kernel against segment_sum_plain, empty rows exactly 0, twice
    the same bits; NARROW counts each launch with its split rows and
    their pieces."""
    from dream_gnn_tpu_torch.graph.csr import segment_pieces
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    ptr, src, val, x = _skewed_case(cuda, d)
    pc = segment_pieces(ptr)
    args = (ptr, src, val, x.to(x_dtype), *MODES[mode])
    before = dict(sp.NARROW)
    out = sp.launch_segment_sum(*args, pieces=pc)
    ref = sp.segment_sum_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (len(SKEWED_ROWS["skewed"]), d)
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    lens = torch.tensor(SKEWED_ROWS["skewed"], device=cuda)
    assert not out[lens == 0].any()
    assert torch.equal(out, sp.launch_segment_sum(*args, pieces=pc))
    assert pc.n_split == int((lens > 128).sum()) == 4
    assert sp.NARROW == {"launches": before["launches"] + 2,
                         "split_launches": before["split_launches"] + 2,
                         "split_rows": before["split_rows"] + 2 * 4,
                         "split_pieces": before["split_pieces"] + 2 * (
                             2 + 8 + 40 + 157)}


@pytest.mark.parametrize("rows", list(SKEWED_ROWS))
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 50])
def test_narrow_segment_sum_is_the_piece_order_sum(cuda, d, x_dtype, gather,
                                                   rows):
    """With exact messages (weights of powers of two) the kernel gives the
    bits of the emulated piece order in every rounding: each piece in list
    order, then each split row's partial rows in piece order.  On "short"
    rows that is the in-order f32 sum of each row, the bits of the
    one-warp-a-row kernel the pieces replaced."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp
    from _segment_pieces import messages, piece_order_sum, run_sums

    ptr, src, val, x = _skewed_case(cuda, d, rows, pow2=True)
    x = x.to(x_dtype)
    src = src if gather else None
    for mode in MODES.values():
        out = _launch(ptr, src, val, x, *mode)
        assert torch.equal(out, piece_order_sum(ptr, src, val, x, *mode)), mode
        if rows == "short":
            p = ptr.long()
            assert torch.equal(out, run_sums(p[:-1], p[1:] - p[:-1],
                                             messages(src, val, x, *mode)))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,groups", [(16, 4), (64, 4), (128, 2), (384, 1)])
def test_wide_segment_sum_keeps_its_order(cuda, d, groups, x_dtype):
    """The wide path (d % 8 == 0) is untouched by the pieces: with exact
    messages it gives the bits of its own emulated order in every
    rounding, G lane groups each adding every G-th entry of a row, their
    sums added pairwise."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp
    from _segment_pieces import wide_order_sum

    ptr, src, val, x = _segment_case(cuda, d)
    val = torch.where(val != 0, 2.0 ** torch.round(val * 4 - 4), val)
    x = x.to(x_dtype)
    before = dict(sp.NARROW)
    for mode in MODES.values():
        out = sp.launch_segment_sum(ptr, src, val, x, *mode)
        assert torch.equal(out, wide_order_sum(ptr, src, val, x, *mode,
                                               groups=groups)), mode
    assert sp.NARROW == before


def test_spmm_slab_narrow_reads_the_layouts_pieces(cuda):
    """spmm_slab at GCMC's width, float32, forward and backward: the kernel
    reads the pieces built with each layout, and matches the same call on
    the CPU; a narrow launch without pieces is refused."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    pairs, _ = _csr_case(cuda, 300, 250, 30_000, 50, seed=6)
    assert pairs[0].fwd.pieces.n_split > 0
    x = torch.randn(300, 50, device=cuda)
    res = []
    for p, xx in zip(pairs, (x, x.cpu())):
        xx = xx.clone().requires_grad_(True)
        before = dict(sp.NARROW)
        out = sp.spmm_slab(p, xx, torch.float32)
        (out * out).sum().backward()
        res.append((out.detach().cpu(), xx.grad.cpu()))
        assert sp.NARROW["launches"] == before["launches"] + 2 * xx.is_cuda
    for a, b in zip(*res):
        assert _rel(a, b) <= 1e-4
    g = pairs[0].fwd
    with pytest.raises(ValueError, match="pieces"):
        sp.launch_segment_sum(g.row_ptr, g.src, g.val, x, False)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seq_scatter_kernel_matches_plain(cuda, x_dtype, dtype):
    """Padding slots, empty nodes, random weights: the kernel against the
    plain version on the same tensors, and twice the same bits."""
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq
    from dream_gnn_tpu_torch.kernels.grid_decoder import round_to

    rng = np.random.default_rng(5)
    n_slots, n_dst = 5000, 3000
    live = rng.random(n_slots) > 0.2
    node = np.zeros(n_slots, np.int64)
    node[live] = np.sort(rng.integers(0, n_dst, live.sum()))
    g = sq.build_seq_scatter(node, live, rng.random(n_slots) + 0.5, n_dst,
                             device=cuda)
    x = torch.randn(n_slots, 128, device=cuda).to(x_dtype)
    before = sq.LAUNCHES["seq_scatter"]
    out = sq.seq_scatter(g, x, dtype)
    assert sq.LAUNCHES["seq_scatter"] == before + 1
    ref = sq.segment_sum_plain(g.offsets, None, round_to(g.val, dtype), x,
                               dtype == torch.bfloat16)
    assert _rel(out, ref) <= TOL[dtype]
    assert torch.equal(out, sq.seq_scatter(g, x, dtype))


def _scale_args(dev, nd, nv, ne, seed=0):
    """Scale decoder inputs: tables, weights, seed, a layout over random
    candidates, and a forward-slot cotangent."""
    from dream_gnn_tpu_torch.kernels.scale_decoder import \
        build_scale_decoder_layout

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    layout = build_scale_decoder_layout(rng.integers(0, nd, ne),
                                        rng.integers(0, nv, ne), nd, nv,
                                        device=dev)
    return ([t(rng.normal(0, 0.5, (nd, 128))), t(rng.normal(0, 0.5, (nv, 128))),
             t(rng.uniform(-.1, .1, 128)), t(rng.uniform(-.1, .1, (128, 64))),
             t(rng.uniform(-.1, .1, 64)), t(rng.uniform(-.2, .2, 64)),
             torch.tensor([918273], dtype=torch.int32, device=dev)],
            layout, t(rng.normal(0, 1, ne)))


def _scale_run(sd, args, layout, g, rate, dtype, kernel):
    """K2 (logits, a1), B1 (da1, dW2, db2, dw3, db1) and the mirror's da1,
    by the kernels or by the plain versions."""
    pd, pv, b1, w2, b2, w3, seed = args
    fwd = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
    mir = (layout.drug_of_mslot, layout.dis_of_mslot, layout.mirror_eid)
    g_m = g[layout.gout_perm.long()]
    common = (w2, b2, w3, seed, rate, True, dtype)
    if kernel:
        out, a1 = sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, rate, True,
                               dtype, True)
        b1_out = sd.launch_b1(a1, pd, pv, layout, g, b1, *common)
        da1_m = sd.launch_mirror(pd, pv, layout, g_m, b1, *common)
    else:
        out, a1 = sd.scale_fwd_plain(pd, pv, b1, w2, b2, w3, *fwd, seed, rate,
                                     True, dtype, True)
        b1_out = sd.scale_bwd_plain(a1, pd, pv, *fwd, g, b1, *common, True)
        da1_m = sd.scale_bwd_plain(None, pd, pv, *mir, g_m, b1, *common,
                                   False)
    return (out, a1, *b1_out, da1_m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("shape", [(1, 1, 1), (130, 1, 1023), (1, 130, 1025),
                                   (300, 250, 4000)])
def test_scale_decoder_kernels_match_plain(cuda, dtype, rate, shape):
    """K2's logits and a1, B1's da1 and four weight gradients, the mirror's
    da1, against the plain versions; ragged slot counts and one-node
    tables."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, g = _scale_args(cuda, *shape)
    got = _scale_run(sd, args, layout, g, rate, dtype, True)
    want = _scale_run(sd, args, layout, g, rate, dtype, False)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a.float(), b.float()) <= TOL[dtype]


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_scale_bf16_tolerance_sees_missing_rounding(cuda, rate):
    """The fp32 scale kernels against the bf16 plain versions fail the bf16
    tolerance in the logits and in da1 of B1 and of the mirror."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, g = _scale_args(cuda, 300, 250, 4000)
    got = _scale_run(sd, args, layout, g, rate, torch.float32, True)
    want = _scale_run(sd, args, layout, g, rate, torch.bfloat16, False)
    for i in (0, 2, 7):
        assert _rel(got[i].float(), want[i].float()) > TOL[torch.bfloat16]


def test_scale_kernels_are_deterministic(cuda):
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, g = _scale_args(cuda, 300, 250, 20000, seed=1)
    a = _scale_run(sd, args, layout, g, 0.3, torch.bfloat16, True)
    b = _scale_run(sd, args, layout, g, 0.3, torch.bfloat16, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _k2(sd, args, layout, rate, train, kernel):
    """K2 in bf16 over the layout's forward slots, by the kernel or by the
    plain version with its a2 product in unit order: (logits, a1 spill);
    training spills a1 and draws dropout at ``rate``, an eval neither."""
    pd, pv, b1, w2, b2, w3, seed = args
    fwd = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
    call = (pd, pv, b1, w2, b2, w3, *fwd, seed, rate, train, torch.bfloat16,
            train)
    if kernel:
        return sd.launch_k2(*call)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch, "matmul", _unit_order_matmul)
    try:
        return sd.scale_fwd_plain(*call)
    finally:
        mp.undo()


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("nv", [1, 313])
@pytest.mark.parametrize("nd", [1, 37, 593])
@pytest.mark.parametrize("ne", [1, 15, 16, 17, 127, 128, 129, 1023,
                                128 * 59 + 5, 128 * 300 + 5])
def test_scale_bf16_fwd_matches_plain_across_tiles(cuda, ne, nd, nv, rate,
                                                   train):
    """The tensor-core K2 (bf16) at slot counts that straddle its 16-slot
    mma rows and 128-slot tiles, up to more tiles than the grid has blocks,
    in training (dropout at ``rate``, a1 spilled) and in eval (neither):
    the logits finite and within the tolerance of the plain version with
    its a2 product in unit order, the order the kernel takes where h2d sits
    near a bf16 midpoint (tests/test_torch_port_k2_sum_order.py); the spill
    equal to the plain version's stored a1, bit for bit, as B1 reads it."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, _ = _scale_args(cuda, nd, nv, ne, seed=ne + nd + nv)
    out, a1 = _k2(sd, args, layout, rate, train, True)
    ref, a1_ref = _k2(sd, args, layout, rate, train, False)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (ne,)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, ref) <= TOL[torch.bfloat16]
    if train:
        assert a1.dtype == torch.bfloat16 and torch.equal(a1, a1_ref)
    else:
        assert a1 is None and a1_ref is None


@pytest.mark.parametrize("case", ["midpoint", "gate"])
def test_scale_bf16_fwd_sums_a2_in_unit_order_at_a_midpoint(cuda, case):
    """One slot whose a2[0] is the bf16 midpoint 1 + 2^-8 of h2d when
    summed in unit order and lies above it when summed in reverse, or 0 in
    unit order and 2^-23 reversed, the relu gate
    (tests/test_torch_port_k2_sum_order.py).  At the midpoint the kernel
    takes the unit order, so rnd(h2d[0]) = 1 and the logit is the
    unit-order plain logit 1 + 63 * 0.125, bit for bit; at the gate the
    logit moves by f32 noise only, and is 63 * 0.125 within 2^-20."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    w2 = torch.zeros(128, 64)
    b2 = torch.zeros(64)
    if case == "midpoint":
        w2[:5, 0] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                                  2.0 ** -25])
    else:
        w2[:4, 0] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25])
        b2[0] = -1.0
    w2[:, 1:] = 2.0 ** -10
    args, layout, _ = _one_slot(cuda, w2, b2)
    out, _ = _k2(sd, args, layout, 0.0, True, True)
    ref, _ = _k2(sd, args, layout, 0.0, True, False)
    if case == "midpoint":
        assert float(ref[0]) == 1.0 + 63 * 0.125
        assert torch.equal(out, ref)
    else:
        assert abs(float(out[0]) - 63 * 0.125) <= 2.0 ** -20


def test_scale_bf16_fwd_repeats_bit_for_bit(cuda):
    """Two launches of the tensor-core K2 give the same logits and spill,
    over more tiles than the grid has blocks."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, _ = _scale_args(cuda, 593, 313, 128 * 300 + 5, seed=3)
    a = _k2(sd, args, layout, 0.3, True, True)
    b = _k2(sd, args, layout, 0.3, True, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("ne", [1, 17, 129, 128 * 300 + 5])
def test_scale_bf16_fwd_writes_nothing_past_ne(cuda, ne, train):
    """The C entry point of K2 with output buffers longer than ne, filled
    with a sentinel: the slots of the last tile past ne write neither a
    logit nor an a1 row, and the first ne are the wrapper's."""
    from dream_gnn_tpu_torch.kernels import grid_decoder as gd
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, _ = _scale_args(cuda, 37, 45, ne, seed=ne)
    pd, pv, b1, w2, b2, w3, seed = args
    fwd = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
    pad = ne + 128 + 5
    out = torch.full((pad,), 7.0, device=cuda)
    a1 = torch.full((pad, 128), 7.0, dtype=torch.bfloat16, device=cuda) \
        if train else None
    err = sd._load().scale_decoder_fwd(
        *[x.data_ptr() for x in (pd, pv, *fwd, b1, w2, b2, w3, seed, out)],
        sd._ptr(a1), pd.shape[0], pv.shape[0], ne,
        *gd.drop_args(0.3, train), 1, gd.stream_ptr(cuda))
    assert err == 0
    want, a1_want = sd.launch_k2(pd, pv, b1, w2, b2, w3, *fwd, seed, 0.3,
                                 train, torch.bfloat16, train)
    torch.cuda.synchronize()
    assert torch.equal(out[:ne], want)
    assert bool((out[ne:] == 7.0).all())
    if train:
        assert torch.equal(a1[:ne], a1_want)
        assert bool((a1[ne:] == 7.0).all())


@pytest.mark.parametrize("dtype,warps", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
def test_scale_fwd_occupancy_is_the_launch_block(cuda, dtype, warps):
    """fwd_occupancy counts the K2 blocks of the launch's own size (4 warps
    in fp32, 8 on the tensor cores) that fit an SM: at least one, and on
    the tensor cores the two that FWD_RESIDENT (csrc/decoder_common.cuh)
    promises its launch bounds."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    blocks, resident = sd.fwd_occupancy(dtype)
    assert blocks >= (2 if dtype == torch.bfloat16 else 1)
    assert resident == blocks * warps


def _scale_bwd(sd, args, layout, g, rate, dtype, mirror, kernel):
    """B1 (da1, dW2, db2, dw3, db1) from K2's spill of a1, or the mirror's
    (da1,), by the kernel or by the plain version."""
    pd, pv, b1, w2, b2, w3, seed = args
    common = (w2, b2, w3, seed, rate, True, dtype)
    if mirror:
        if kernel:
            return (sd.launch_mirror(pd, pv, layout, g, b1, *common),)
        return (sd.scale_bwd_plain(None, pd, pv, layout.drug_of_mslot,
                                   layout.dis_of_mslot, layout.mirror_eid, g,
                                   b1, *common, False),)
    _, a1 = sd.launch_k2(pd, pv, b1, w2, b2, w3, layout.drug_of_slot,
                         layout.dis_of_slot, layout.fwd_eid, seed, rate, True,
                         dtype, True)
    if kernel:
        return sd.launch_b1(a1, pd, pv, layout, g, b1, *common)
    return sd.scale_bwd_plain(a1, pd, pv, layout.drug_of_slot,
                              layout.dis_of_slot, layout.fwd_eid, g, b1,
                              *common, True)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("nv", [1, 313])
@pytest.mark.parametrize("nd", [1, 37, 593])
@pytest.mark.parametrize("ne", [1, 15, 16, 17, 127, 128, 129, 1023,
                                128 * 59 + 5, 128 * 300 + 5])
def test_scale_bf16_bwd_matches_plain_across_tiles(cuda, monkeypatch, ne, nd,
                                                   nv, mirror, rate):
    """The tensor-core scale backward (bf16), B1 and the mirror, at slot
    counts that straddle its 16-slot mma rows and 128-slot tiles, up to
    more tiles than the grid has blocks: every output finite and within the
    tolerance of the plain version with its products summed in unit order,
    the order the kernel takes where the order can move a rounding or a
    gate (tests/test_torch_port_scale_sum_order.py)."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, g = _scale_args(cuda, nd, nv, ne, seed=ne + nd + nv)
    if mirror:
        g = g[layout.gout_perm.long()]
    got = _scale_bwd(sd, args, layout, g, rate, torch.bfloat16, mirror, True)
    monkeypatch.setattr(torch, "matmul", _unit_order_matmul)
    want = _scale_bwd(sd, args, layout, g, rate, torch.bfloat16, mirror,
                      False)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert len(got) == len(want) == (1 if mirror else 5)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(torch.isfinite(a.float()).all())
        assert _rel(a.float(), b.float()) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_scale_bwd_gates_at_zero_and_subnormal(cuda, monkeypatch, dtype,
                                               rate):
    """Units where a1 is exactly 0 (gate shut) or a subnormal positive
    (gate open, though rnd(h1d) may round to 0), and columns where a2 is
    exactly 0 (gate shut): B1 and the mirror gate on a1 > 0 and a2 > 0 as
    the plain version does.  In bf16 the tables round first, so 1e-45
    becomes 0 there and 1e-39 stays a subnormal."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    nd, nv = 37, 45
    args, layout, g = _scale_args(cuda, nd, nv, 3000, seed=5)
    pd, pv, b1, w2, b2 = (x.clone() for x in args[:5])
    s1, s2 = slice(0, 16), slice(0, 4)
    pattern = torch.tensor([0.0, 1e-45, 1e-39, 3e-38, -0.3, 0.4],
                           device=cuda)
    sub = torch.arange(nd, device=cuda) % 6
    pd[:, s1] = pattern[sub][:, None]
    pv[:, s1] = 0.0
    b1[s1] = 0.0
    w2[:, s2] = 0.0
    b2[s2] = 0.0
    args = [pd, pv, b1, w2, b2, *args[5:]]
    got = _scale_run(sd, args, layout, g, rate, dtype, True)
    monkeypatch.setattr(torch, "matmul", _unit_order_matmul)
    want = _scale_run(sd, args, layout, g, rate, dtype, False)
    monkeypatch.undo()
    torch.cuda.synchronize()
    # The case bites: the slots of subnormal a1 carry da1 in those units,
    # those of a1 = 0 none, and a2 = 0 leaves db2 exactly 0 there.
    for da1, drug in ((want[2], layout.drug_of_slot),
                      (want[7], layout.drug_of_mslot)):
        s = sub[drug.long()]
        part = da1.float()[:, s1]
        assert float(part[(s == 1) | (s == 2)].abs().max()) \
            > 0.05 * float(da1.float().abs().max())
        assert not bool(part[s == 0].any())
    assert not bool(want[4][s2].any()) and not bool(got[4][s2].any())
    for a, b in zip(got, want):
        assert _rel(a.float(), b.float()) <= TOL[dtype]


def _one_slot(dev, w2, b2):
    """One candidate (0, 0) with a1 = 1 in every unit (the tables round to
    themselves), g = 1 and w3 = 1, and the given w2 and b2: the tables,
    weights and seed, its layout and its cotangent."""
    from dream_gnn_tpu_torch.kernels.scale_decoder import \
        build_scale_decoder_layout

    layout = build_scale_decoder_layout([0], [0], 1, 1, device=dev)
    args = [torch.ones(1, 128, device=dev), torch.zeros(1, 128, device=dev),
            torch.zeros(128, device=dev), w2.to(dev), b2.to(dev),
            torch.ones(64, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev)]
    return args, layout, torch.ones(1, device=dev)


@pytest.mark.parametrize("mirror", [False, True])
def test_scale_bf16_bwd_sums_da1_in_unit_order_at_a_midpoint(cuda, mirror):
    """One slot whose dh1[0] is the bf16 midpoint 1 + 2^-8 when summed in
    unit order and lies above it when summed in reverse
    (tests/test_torch_port_scale_sum_order.py): the kernel takes the unit
    order, so the stored da1[0] = rnd(1 + 2^-8) = 1, and B1's db1 sums the
    unrounded 1 + 2^-8."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    w2 = torch.zeros(128, 64)
    w2[0, :5] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -25, 2.0 ** -25,
                              2.0 ** -25])
    args, layout, g = _one_slot(cuda, w2, torch.ones(64))
    out = _scale_bwd(sd, args, layout, g, 0.0, torch.bfloat16, mirror, True)
    da1 = out[0].float()
    assert float(da1[0, 0]) == 1.0
    assert not bool(da1[0, 1:].any())
    if not mirror:
        assert float(out[4][0]) == 1.0 + 2.0 ** -8


@pytest.mark.parametrize("mirror", [False, True])
def test_scale_bf16_bwd_sums_a2_in_unit_order_at_the_gate(cuda, mirror):
    """One slot whose a2[0] is 0 when summed in unit order and 2^-23 when
    summed in reverse (tests/test_torch_port_scale_sum_order.py): the
    kernel takes the unit order, so the gate of column 0 is shut, db2[0] =
    0, and da1 sums only the 63 open columns, 63 * 2^-10 in every unit."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    w2 = torch.zeros(128, 64)
    w2[:4, 0] = torch.tensor([1.0, 2.0 ** -25, 2.0 ** -25, 2.0 ** -25])
    w2[:, 1:] = 2.0 ** -10
    b2 = torch.zeros(64)
    b2[0] = -1.0
    args, layout, g = _one_slot(cuda, w2, b2)
    out = _scale_bwd(sd, args, layout, g, 0.0, torch.bfloat16, mirror, True)
    assert bool((out[0].float() == 63 * 2.0 ** -10).all())
    if not mirror:
        assert float(out[2][0]) == 0.0
        assert bool((out[2][1:] == 1.0).all())


@pytest.mark.parametrize("mirror", [False, True])
def test_scale_bf16_bwd_repeats_bit_for_bit(cuda, mirror):
    """Two launches of the tensor-core B1 or mirror give the same bits, over
    more tiles than the grid has blocks."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    args, layout, g = _scale_args(cuda, 593, 313, 128 * 300 + 5, seed=3)
    a = _scale_bwd(sd, args, layout, g, 0.3, torch.bfloat16, mirror, True)
    b = _scale_bwd(sd, args, layout, g, 0.3, torch.bfloat16, mirror, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,warps", [(torch.float32, 4),
                                         (torch.bfloat16, 8)])
@pytest.mark.parametrize("mirror", [False, True])
def test_scale_bwd_occupancy_is_the_launch_block(cuda, dtype, warps, mirror):
    """bwd_occupancy counts the blocks of the launch's own size (4 warps in
    fp32, 8 on the tensor cores) that fit an SM, B1 or the mirror, and at
    least one does."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd

    blocks, resident = sd.bwd_occupancy(dtype, mirror)
    assert blocks >= 1
    assert resident == blocks * warps


def test_scale_decoder_autograd_matches_cpu(cuda):
    """scale_decoder on the card (K2, B1, mirror, two seq_scatter launches)
    against the same call on the CPU: logits and the seven gradients."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq

    args, layout, g = _scale_args(cuda, 300, 250, 4000, seed=2)
    _, layout_cpu, _ = _scale_args("cpu", 300, 250, 4000, seed=2)
    b3 = torch.tensor([0.1], device=cuda)
    before = (dict(sd.LAUNCHES), sq.LAUNCHES["seq_scatter"])
    res = []
    for dev, lay in ((cuda, layout), ("cpu", layout_cpu)):
        leaves = [x.to(dev).clone().requires_grad_(True)
                  for x in (*args[:6], b3)]
        out = sd.scale_decoder(*leaves, lay, args[6].to(dev), 0.3, True,
                               torch.bfloat16)
        (out * g.to(dev)).sum().backward()
        res.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    assert sd.LAUNCHES == {k: v + 1 for k, v in before[0].items()}
    assert sq.LAUNCHES["seq_scatter"] == before[1] + 2
    for a, b in zip(*res):
        assert _rel(a, b) <= 1e-4


def test_scale_wrappers_check_inputs(cuda):
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    args, layout, g = _scale_args(cuda, 8, 8, 50)
    pd, pv, b1, w2, b2, w3, seed = args
    with pytest.raises(ValueError, match="drug"):
        sd.launch_k2(pd, pv, b1, w2, b2, w3, layout.drug_of_slot.long(),
                     layout.dis_of_slot, layout.fwd_eid, seed, 0.0, False,
                     torch.bfloat16, False)
    with pytest.raises(ValueError, match="a1"):
        sd.launch_b1(torch.zeros(50, 128, device=cuda), pd, pv, layout, g, b1,
                     w2, b2, w3, seed, 0.0, True, torch.bfloat16)
    (pair, _), x = _csr_case(cuda, 10, 10, 30, 16)
    with pytest.raises(ValueError, match="ptr"):
        sp.launch_segment_sum(pair.fwd.row_ptr.long(), pair.fwd.src,
                              pair.fwd.val, x, True)


def test_scale_trainer_launches_scale_kernels(cuda, tmp_path):
    """A tiny run of the scale trainer on the card: per step 12 SpMM
    forwards and 12 backwards (3 layers x 2 ratings x 2 directions), one
    K2, B1 and mirror, two seq_scatter; K2 and the SpMM forwards also once
    per evaluated candidate list."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import seq_scatter as sq
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp
    from dream_gnn_tpu_torch.train import scale

    for counts in (sd.LAUNCHES, sq.LAUNCHES, sp.LAUNCHES):
        for k in counts:
            counts[k] = 0
    rc = scale.main(["--n_nodes", "400", "--n_enc", "6000", "--n_cand", "900",
                     "--iters", "5", "--valid_interval", "2", "--save_dir",
                     str(tmp_path)])
    assert rc in (0, 1)
    steps, evals = 4, 2 * 2
    assert sd.LAUNCHES == {"k2": steps + evals, "b1": steps, "mirror": steps}
    assert sq.LAUNCHES == {"seq_scatter": 2 * steps}
    assert sp.LAUNCHES == {"fwd": 12 * (steps + evals), "bwd": 12 * steps}


# The scale benchmark's SpMMs: the grouped (spmm_gather) and the blocked
# (spmm_blocked) layouts over the same segmented-sum kernel, each in its
# own rounding.

def _sparse_case(dev, n_src, n_dst, nnz, d, build, seed=0):
    """A random relation (repeats, zero weights, rows past n_dst/2 empty)
    as ``build``'s layout pair on ``dev`` and on the CPU, and x on the
    CPU."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, nnz)
    dst = rng.integers(0, max(n_dst // 2, 1), nnz)
    val = (rng.random(nnz) + 0.5).astype(np.float32)
    val[rng.random(nnz) < 0.1] = 0.0
    pairs = [build(src, dst, val, n_src, n_dst, device=d_)
             for d_ in (dev, "cpu")]
    return pairs, torch.tensor(rng.normal(size=(n_src, d)).astype(np.float32))


SPARSE_SHAPES = [(1, 1, 1, 16), (300, 250, 3000, 128), (70, 900, 5000, 33),
                 (2000, 1500, 40000, 128),
                 *[(300, 250, 3000, d) for d in (1, 4, 12, 127, 130, 384)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPARSE_SHAPES)
@pytest.mark.parametrize("kind", ["gather", "blocked"])
def test_sparse_spmm_kernels_match_plain(cuda, kind, shape, dtype):
    """spmm_gather_raw / spmm_blocked_raw on the card against the same call
    on the CPU (plain version), forward and transposed layouts; twice the
    same bits; one counted launch per call."""
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg

    mod, build = ((sg, grouped_pair_from_arrays) if kind == "gather"
                  else (sb, blocked_pair_from_arrays))
    raw = sg.spmm_gather_raw if kind == "gather" else sb.spmm_blocked_raw
    (pair, pair_cpu), _ = _sparse_case(cuda, *shape, build)
    for g, g_cpu in ((pair.fwd, pair_cpu.fwd), (pair.bwd, pair_cpu.bwd)):
        x = torch.randn(g.n_src, shape[3])
        before = mod.LAUNCHES["raw"]
        out = raw(g, x.to(cuda), dtype)
        assert mod.LAUNCHES["raw"] == before + 1
        assert out.shape == (g.n_dst, shape[3]) and out.dtype == torch.float32
        assert _rel(out.cpu(), raw(g_cpu, x, dtype)) <= TOL[dtype]
        assert torch.equal(out, raw(g, x.to(cuda), dtype))


@pytest.mark.parametrize("kind", ["gather", "blocked"])
def test_sparse_spmm_autograd_matches_cpu(cuda, kind):
    """spmm_gather / spmm_blocked with a PRF-masked pair on the card
    (kernel, forward and backward) against the same call on the CPU."""
    from dream_gnn_tpu_torch.augment.masks import prf_mask_pair
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg

    mod, fn, build = ((sg, sg.spmm_gather, grouped_pair_from_arrays)
                      if kind == "gather" else
                      (sb, sb.spmm_blocked, blocked_pair_from_arrays))
    pairs, x = _sparse_case(cuda, 300, 250, 3000, 128, build, seed=4)
    before = dict(mod.LAUNCHES)
    res = []
    for p, dev in zip(pairs, (cuda, "cpu")):
        xx = x.to(dev).requires_grad_(True)
        out = fn(prf_mask_pair(p, 4242, 0.3), xx)
        (out * out).sum().backward()
        res.append((out.detach().cpu(), xx.grad.cpu()))
    assert mod.LAUNCHES == dict(before, fwd=before["fwd"] + 1,
                                bwd=before["bwd"] + 1)
    for a, b in zip(*res):
        assert _rel(a, b) <= 1e-4


def test_blocked_bf16_rounds_val_on_the_card(cuda):
    """With U[0.5, 1.5) weights the blocked kernel's bf16 messages
    rnd(rnd(val) * rnd(x)) meet the tolerance against its plain version and
    miss it against the grouped rounding rnd(rnd(x) * val)."""
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels.spmm_slab import segment_sum_plain

    (pair, _), x = _sparse_case(cuda, 2000, 1500, 40000, 128,
                                blocked_pair_from_arrays)
    g, x = pair.fwd, x.to(cuda)
    out = sb.spmm_blocked_raw(g, x)
    b9 = segment_sum_plain(g.row_ptr, g.src, g.val, x, True, round_val=True)
    b8 = segment_sum_plain(g.row_ptr, g.src, g.val, x, True)
    assert _rel(out, b9) <= TOL[torch.bfloat16] < _rel(out, b8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_decoder_grouped_scatter_equals_sequential(cuda, dtype):
    """A layout built with ``build_seq=False`` scatters the table gradients
    with spmm_gather (two launches per backward) and gives the same bits
    as the sequential scatter."""
    from dream_gnn_tpu_torch.kernels import scale_decoder as sd
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg

    args, layout, g = _scale_args(cuda, 300, 250, 4000)
    src = layout.drug_of_slot[layout.inv_slot.long()]
    dst = layout.dis_of_slot[layout.inv_slot.long()]
    res = []
    for build_seq in (True, False):
        lay = sd.build_scale_decoder_layout(src, dst, 300, 250,
                                            build_seq=build_seq, device=cuda)
        leaves = [a.clone().requires_grad_(True) for a in args[:6]]
        before = sg.LAUNCHES["raw"]
        out = sd.scale_decoder(*leaves, torch.zeros(1, device=cuda), lay,
                               args[6], 0.3, True, dtype)
        (out * g).sum().backward()
        assert sg.LAUNCHES["raw"] == before + (0 if build_seq else 2)
        res.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_bench_scale_launch_counts(cuda, monkeypatch):
    """bench_scale on the card at --tiny: the grouped layout launches 12
    spmm_gather forwards and 12 backwards per step (3 layers x 2 ratings
    x 2 directions), the COO layout no kernel."""
    from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
    from dream_gnn_tpu_torch.kernels import spmm_gather as sg
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp
    from dream_gnn_tpu_torch.scripts import bench_scale

    monkeypatch.setattr(bench_scale, "STEPS", 2)
    monkeypatch.setattr(bench_scale, "REPEATS", 1)
    steps = 4
    for flags, fwd in ((["--grouped"], 12 * steps), ([], 0)):
        for counts in (sg.LAUNCHES, sb.LAUNCHES, sp.LAUNCHES):
            for k in counts:
                counts[k] = 0
        res = bench_scale.main(["--tiny", *flags])
        assert np.isfinite(res["loss"]) and res["peak_memory_bytes"] > 0
        assert sg.LAUNCHES == {"fwd": fwd, "bwd": fwd, "raw": 0}
        assert not any(sb.LAUNCHES.values()) and not any(sp.LAUNCHES.values())


# ---------------------------------------------------------------------------
# Checkpoint and resume, and the novel-prediction forward, on the card.

def _tiny_card_state(dev, stacked: bool, seed: int):
    """A small Gdataset-like dataset on the card and a train state of its
    fold 0 (or a stack of folds 0 and 1) with the bf16 grid kernels."""
    from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                                   init_state_stacked,
                                                   make_one_step_stacked)
    from dream_gnn_tpu_torch.train.step import init_state, make_one_step

    ds = DreamDataset(synthetic_raw_data(n_drug=70, n_dis=50, n_pos=200,
                                         seed=2), device=dev)
    cfg = TrainConfig(model=ModelConfig(
        layers=2, gcn_agg_units=96, gcn_out_units=32, nhid1=64, nhid2=32,
        decode_mode="grid", decoder_backend="pallas",
        compute_dtype="bfloat16"))
    mcfg = derive_model_cfg(cfg, ds)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if stacked:
        state = init_state_stacked(init_params_stacked(mcfg, [seed], [0, 1],
                                                       dev), gen, cfg)
        st = stack_folds(ds, [0, 1])
        step = make_one_step_stacked(mcfg, cfg)
        args = (st.inputs, st.labels, st.edge_weight)
    else:
        state = init_state(init_params(gen, mcfg), gen, cfg)
        inputs, _, labels, _ = fold_inputs(ds, 0)
        step = make_one_step(mcfg, cfg)
        args = (inputs, labels, ds.fold(0).train_w)
    return ds, mcfg, state, lambda: step(state, *args)


def test_cuda_generator_state_round_trips_a_checkpoint(cuda, tmp_path):
    """The card's generator state is saved as ``get_state()`` bytes and
    restored into a generator on the card: the next draws are the same."""
    from dream_gnn_tpu_torch.train.checkpoint import (load_train_state,
                                                      save_train_state)
    from dream_gnn_tpu_torch.train.optim import PlateauScheduler

    _, _, a, step = _tiny_card_state(cuda, False, 1)
    _, _, b, _ = _tiny_card_state(cuda, False, 2)
    step()
    path = str(tmp_path / "ckpt.npz")
    best = [dict(aupr=0.1, auroc=0.5, iter=1, train_aupr=0.1,
                 train_auroc=0.5)]
    save_train_state(path, a, 1, [PlateauScheduler(0.002)], best)
    load_train_state(path, b, [PlateauScheduler(0.002)])
    assert b.generator.device == cuda
    assert torch.equal(torch.rand(1000, generator=a.generator, device=cuda),
                       torch.rand(1000, generator=b.generator, device=cuda))


@pytest.mark.parametrize("stacked", [False, True])
def test_save_load_resume_equals_uninterrupted_steps(cuda, tmp_path,
                                                     stacked):
    """N steps, a save, a load into a fresh state and M more steps give the
    params of N + M uninterrupted steps, bit for bit: the hand kernels'
    bits do not depend on the launch."""
    from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
    from dream_gnn_tpu_torch.train.checkpoint import (load_train_state,
                                                      save_train_state)
    from dream_gnn_tpu_torch.train.optim import PlateauScheduler

    n_items = 2 if stacked else 1
    best = [dict(aupr=0.0, auroc=0.0, iter=0, train_aupr=0.0,
                 train_auroc=0.0)] * n_items
    scheds = [PlateauScheduler(0.002) for _ in range(n_items)]
    _, _, full, full_step = _tiny_card_state(cuda, stacked, 3)
    for _ in range(5):
        full_step()
    _, _, cut, cut_step = _tiny_card_state(cuda, stacked, 3)
    for _ in range(3):
        cut_step()
    path = str(tmp_path / "ckpt.npz")
    save_train_state(path, cut, 3, scheds, best)
    _, _, resumed, resumed_step = _tiny_card_state(cuda, stacked, 4)
    load_train_state(path, resumed, scheds)
    for _ in range(2):
        resumed_step()
    torch.cuda.synchronize()
    for a, b in zip(param_leaves(full.params), param_leaves(resumed.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_novel_forward_on_the_card_equals_plain(cuda, mode):
    """The novel-prediction forward on the card (one decoder kernel launch
    over every zero cell) against the plain versions on the CPU:
    max|card - cpu| / max|cpu| <= 1e-2, as the eval forward is held."""
    import dataclasses

    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.eval.novel import novel_scores
    from dream_gnn_tpu_torch.model.dream_gnn import map_params

    ds, mcfg, state, _ = _tiny_card_state(cuda, False, 5)
    mcfg = dataclasses.replace(mcfg, decode_mode=mode)
    params = map_params(lambda t: t.detach().cpu(), state.params)
    _zero_launches()
    zr, zc, card = novel_scores(params, mcfg, ds, 0)
    kind = "grid" if mode == "grid" else "edge"
    assert _decoder_launches()[kind]["fwd"] == 1
    assert len(zr) == 70 * 50 - int(ds.raw.association.sum())
    cpu_ds = DreamDataset(ds.raw, device="cpu")
    zr2, zc2, cpu = novel_scores(params, mcfg, cpu_ds, 0)
    assert np.array_equal(zr, zr2) and np.array_equal(zc, zc2)
    assert np.abs(card - cpu).max() <= 1e-2 * np.abs(cpu).max()


# ---------------------------------------------------------------------------
# The six augment methods of the training step on the card.

SIX = ("edge_dropout", "add_random_edges", "graph_noise", "feature_noise",
       "feature_masking", "mix_up")


def _six_method_case(dev, mode: str, stacked: bool):
    """A small dataset on the card, the six methods at a 0.5 add rate, the
    bf16 decoder kernels of ``mode``; fold 0, or a stack of folds 0-2.
    Returns (cfg, model cfg, inputs, labels, weights, params)."""
    from dream_gnn_tpu_torch.config import (AugmentConfig, ModelConfig,
                                            TrainConfig)
    from dream_gnn_tpu_torch.data.loader import DreamDataset
    from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
    from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
    from dream_gnn_tpu_torch.train.stacked import init_params_stacked

    ds = DreamDataset(synthetic_raw_data(n_drug=70, n_dis=50, n_pos=200,
                                         seed=2), device=dev)
    cfg = TrainConfig(
        augment=AugmentConfig(methods=SIX, add_edge_rate=0.5),
        model=ModelConfig(layers=2, gcn_agg_units=96, gcn_out_units=32,
                          nhid1=64, nhid2=32, decode_mode=mode,
                          decoder_backend="pallas", compute_dtype="bfloat16"))
    mcfg = derive_model_cfg(cfg, ds)
    if stacked:
        st = stack_folds(ds, [0, 1, 2])
        return (cfg, mcfg, st.inputs, st.labels, st.edge_weight,
                init_params_stacked(mcfg, [0], [0, 1, 2], dev))
    inputs, _, labels, _ = fold_inputs(ds, 0)
    return (cfg, mcfg, inputs, labels, ds.fold(0).train_w,
            init_params(torch.Generator(device=dev).manual_seed(0), mcfg))


def _reference_matmul(x, y):
    """``_unit_order_matmul`` for the decoders' depth-64 and -128 products;
    every other product (dW2 and dw3, sums over all cells or edges) summed
    in float64 and rounded to f32 once."""
    k = x.shape[-1]
    if k in (64, 128) and y.dim() >= 2 and y.shape[-2] == k:
        return _unit_order_matmul(x, y)
    return _MATMUL(x.double(), y.double()).float()


def _plain_launches(mod):
    """Each launch function of a decoder kernel module and its plain
    version, which takes the launch's arguments (but the edge backward's
    CSR, which only the kernel uses)."""
    if mod is gd:
        return {"launch_fwd": gd.grid_decoder_plain,
                "launch_bwd": gd.grid_decoder_plain_bwd,
                "launch_fwd_batched": gd.grid_decoder_batched_plain,
                "launch_bwd_batched": gd.grid_decoder_batched_plain_bwd}
    return {"launch_fwd": ed.edge_decoder_plain,
            "launch_bwd": lambda *a: ed.edge_decoder_plain_bwd(*a[:-1]),
            "launch_fwd_batched": ed.edge_decoder_batched_plain,
            "launch_bwd_batched":
                lambda *a: ed.edge_decoder_batched_plain_bwd(*a[:-1])}


@pytest.mark.parametrize("mode,stacked", [("grid", False), ("edges", True),
                                          ("grid", True), ("edges", False)])
def test_six_method_step_kernels_match_plain(cuda, monkeypatch, mode,
                                             stacked):
    """One training step with the six methods and injected draws, through
    the decoder kernels and through their plain versions (each launch
    replaced by its plain version), from one generator state.  Within the
    bf16 tolerance: each kernel launch of the step against its plain
    version on the launch's own inputs (``_reference_matmul``), and the
    step's logits and loss.  Every gradient is finite; only the kernel pass
    launches.  (The gradients are not held to the tolerance: the plain
    pass sums dW2 and dw3 over all cells or edges in f32 in cuBLAS's
    order, which at F = 10 on the full grid is 1.2e-4 of the largest value
    off a float64 sum, PERF.md.)"""
    from dream_gnn_tpu_torch.augment.masks import apply_augment, draw_augment
    from dream_gnn_tpu_torch.model.dream_gnn import (forward, forward_stacked,
                                                     map_params, param_leaves)
    from dream_gnn_tpu_torch.train.losses import total_loss
    from dream_gnn_tpu_torch.train.step import decoder_targets

    cfg, mcfg, inputs, labels, weight, params0 = _six_method_case(
        cuda, mode, stacked)
    draws = draw_augment(torch.Generator(device=cuda).manual_seed(1), inputs,
                         cfg.augment)
    mod = gd if mode == "grid" else ed
    kinds = ("fwd_b", "bwd_b") if stacked else ("fwd", "bwd")

    def run():
        params = map_params(lambda t: t.detach().clone().requires_grad_(True),
                            params0)
        gen = torch.Generator(device=cuda).manual_seed(2)
        aug, masks = apply_augment(inputs, draws, cfg.augment)
        pred, *routes = (forward_stacked if stacked else forward)(
            params, aug, mcfg, train=True, generator=gen, edge_masks=masks)
        pred, lab, w = decoder_targets(pred, aug, mcfg, labels, weight)
        loss, _ = total_loss(pred, lab, *routes, beta=cfg.beta,
                             smoothing=cfg.label_smoothing, weight=w)
        loss.sum().backward()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(p.grad).all())
                   for p in param_leaves(params))
        return pred.detach(), loss.detach()

    calls = []
    with monkeypatch.context() as m:
        for name, plain in _plain_launches(mod).items():
            def record(*args, _launch=getattr(mod, name), _plain=plain):
                out = _launch(*args)
                calls.append((_plain, args, out))
                return out
            m.setattr(mod, name, record)
        _zero_launches()
        kernel = run()
    assert all(mod.LAUNCHES[k] == 1 for k in kinds), mod.LAUNCHES
    assert len(calls) == 2
    for plain, args, out in calls:
        with monkeypatch.context() as m:
            m.setattr(torch, "matmul", _reference_matmul)
            ref = plain(*args)
        if isinstance(out, torch.Tensor):
            out, ref = (out,), (ref,)
        for a, b in zip(out, ref):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel(a.detach(), b.detach()) <= TOL[torch.bfloat16]
    for name, plain in _plain_launches(mod).items():
        monkeypatch.setattr(mod, name, plain)
    _zero_launches()
    ref = run()
    assert _decoder_launches() == {"grid": ZERO, "edge": ZERO}
    for a, b in zip(kernel, ref):
        assert a.shape == b.shape and _rel(a, b) <= TOL[torch.bfloat16]


def test_cuda_generator_augment_draws(cuda):
    """The six methods' draws from a CUDA generator on a 3-fold stack:
    on the card; the add count per rating, direction and fold within 5
    sigma of the fold's own rate; graph noise on nonzero entries only; the
    feature keep rate 1 - 0.1 unscaled; mix-up's permutations and
    coefficients, one pair per fold and field."""
    from dream_gnn_tpu_torch.augment.masks import apply_augment, draw_augment

    cfg, _, inputs, *_ = _six_method_case(cuda, "grid", True)
    aug = cfg.augment
    draws = draw_augment(torch.Generator(device=cuda).manual_seed(3), inputs,
                         aug)
    by = {(m, f): d for m, f, d in draws}
    enc = inputs.enc_graph
    cells = enc.n_drug * enc.n_dis
    add = by["add_random_edges", "edge_masks"]
    assert add["fwd_add"].device == cuda
    for r, a in enumerate((enc.a0(), enc.a1)):
        for f, e in enumerate(a.sum((-2, -1)).tolist()):
            p = min(aug.add_edge_rate * e / cells, 1.0)
            for k in ("fwd_add", "rev_add"):
                count = float(add[k][f, r].sum())
                assert abs(count - cells * p) \
                    <= 5 * np.sqrt(cells * p * (1 - p)), (r, f, k)
    noised, _ = apply_augment(inputs, [d for d in draws
                                       if d[0] == "graph_noise"], aug)
    for field in ("drug_graph", "dis_graph", "drug_feature_graph",
                  "dis_feature_graph"):
        a, b = getattr(inputs, field).a, getattr(noised, field).a
        assert bool((b[a == 0] == 0).all()) and bool((b >= 0).all())
        assert not torch.equal(a[a != 0], b[a != 0])
    for field in ("drug_feat", "dis_feat"):
        x, u = getattr(inputs, field), by["feature_masking", field]
        kept = u > aug.feature_mask_rate
        for f in range(3):
            n = kept[f].numel()
            assert abs(float(kept[f].sum()) - 0.9 * n) \
                <= 5 * np.sqrt(0.09 * n)
        masked, _ = apply_augment(inputs, [("feature_masking", field, u)],
                                  aug)
        y = getattr(masked, field)
        assert torch.equal(y[kept], x[kept]) and bool((y[~kept] == 0).all())
        perm, lam = by["mix_up", field]
        n = x.shape[-2]
        assert torch.equal(perm.sort(-1).values,
                           torch.arange(n, device=cuda).expand(3, n))
        assert lam.shape == (3,) and bool(((lam >= 0) & (lam <= 1)).all())


# ---------------------------------------------------------------------------
# The sharded scale path's collectives and kernels on the card.

def _card_ranks(tmp_path, n_ranks, backend, cases):
    import _torch_port_sharded_worker as worker

    from dream_gnn_tpu_torch.nn.decoder import decoder_init
    from dream_gnn_tpu_torch.sharding.multihost import spawn

    dec = decoder_init(torch.Generator().manual_seed(0),
                       in_units=worker.DECODER["d"])
    torch.save({"decoder": {k: v.numpy() for k, v in dec.items()}},
               tmp_path / "inputs.pt")
    spawn(worker.run, n_ranks, backend, (str(tmp_path), cases),
          workdir=str(tmp_path))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(n_ranks)]


@pytest.mark.parametrize("backend,n_ranks", [("nccl", 1), ("gloo", 2)])
def test_collectives_on_the_card(cuda, tmp_path, backend, n_ranks):
    """Every collective of sharding/collectives.py on CUDA tensors, forward
    and backward: NCCL at world size 1, and 2 gloo ranks sharing cuda:0
    (the ring's point-to-point ops staged through the host); results stay
    on the card."""
    for res in _card_ranks(tmp_path, n_ranks, backend, ["collectives"]):
        assert res["coll/on_device"]
        for k, v in res.items():
            if k != "coll/on_device":
                assert v == 0.0, k


def test_sharded_step_on_the_card_matches_one_rank(cuda, tmp_path):
    """Over 2 gloo ranks on cuda:0: one sharded-grouped SpMM (the grouped
    SpMM kernel on each rank's block; the forward bit for bit the
    unsharded kernel's) and one sharded scale decoder step with dropout
    (K2, B1, the mirror and the grouped SpMM's two scatters on each rank's
    chunk) against rank 0 alone; every rank the same bits."""
    res = _card_ranks(tmp_path, 2, "gloo", ["spmm_grouped", "decoder_grads"])
    r0 = res[0]
    for k, v in res[1].items():
        np.testing.assert_array_equal(v, r0[k], err_msg=k)
    np.testing.assert_array_equal(r0["spmm_grouped/S/out"],
                                  r0["spmm_grouped/unsharded/out"])
    for k in [k for k in r0 if "/S/" in k]:
        a, b = r0[k], r0[k.replace("/S/", "/1/")]
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert err <= 1e-4, k


# ---------------------------------------------------------------------------
# GCMC's bilinear decoder (kernels/bilinear_decoder.py).

def _bilinear_case(dev, n_users, n_movies, n_edges, r, b, d, seed=0,
                   heavy=10_000):
    """Ratings with one movie of ``heavy`` ratings and one level of under 1%
    of them, a unit-scale table pair, the basis, and the softmax
    cross-entropy's cotangent of random levels."""
    from dream_gnn_tpu_torch.kernels.bilinear_decoder import \
        build_bilinear_layout

    rng = np.random.default_rng(seed)
    heavy = min(heavy, n_users)
    users = np.concatenate([rng.permutation(n_users)[:heavy],
                            rng.integers(0, n_users, n_edges)])
    movies = np.concatenate([np.zeros(heavy, np.int64),
                             rng.integers(1, n_movies, n_edges)])
    key = np.unique(users * n_movies + movies)
    users, movies = key // n_movies, key % n_movies
    p = np.full(r, 1.0)
    p[0] = 0.005 * r
    levels = rng.choice(r, users.shape[0], p=p / p.sum())
    layout = build_bilinear_layout(users, movies, n_users, n_movies,
                                   device=dev)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    u = t(rng.normal(0, 1, (n_users, d)))
    v = t(rng.normal(0, 1, (n_movies, d)))
    pb = t(rng.normal(0, d ** -0.5, (b, d, d)))
    a = t(rng.normal(0, 1, (r, b)))
    lab = layout.slot_labels(torch.tensor(levels, device=dev))
    return layout, u, v, pb, a, lab


def _rel(x, y):
    return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)


@pytest.mark.parametrize("r,b,d", [(10, 4, 75), (10, 4, 128), (10, 4, 20)])
def test_bilinear_kernels_match_plain(cuda, r, b, d):
    """Forward and both backward passes at a skewed size (a movie of 10k
    ratings, a level of under 1%): within 1e-5 of the largest value, the
    f32 sums run in other orders."""
    from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd

    layout, u, v, pb, a, lab = _bilinear_case(cuda, 3000, 700, 60_000, r, b,
                                              d)
    assert int((layout.dst == 0).sum()) >= 3000
    up = (u @ bd.basis_cat(pb)).reshape(-1, b, d)
    out = bd.launch_fwd(up, v, a, layout)
    ref = bd.bilinear_fwd_plain(up, v, a, layout)
    assert out.shape == (r, layout.n_edges)
    assert _rel(out, ref) <= 1e-5
    logits = ref.clone().requires_grad_(True)
    torch.nn.functional.cross_entropy(logits.T, lab).backward()
    g = logits.grad
    got = bd.launch_bwd(g, up, u, v, a, layout)
    want = bd.bilinear_bwd_plain(g, up, u, v, a, layout)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert _rel(x, y) <= 1e-5


def test_bilinear_kernels_repeat_bit_for_bit(cuda):
    """Two launches of the forward and of the backward give the same
    bits: every sum runs in a fixed order."""
    from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd

    layout, u, v, pb, a, _ = _bilinear_case(cuda, 2000, 500, 40_000, 10, 4,
                                            75, seed=3)
    up = (u @ bd.basis_cat(pb)).reshape(-1, 4, 75)
    g = torch.randn(10, layout.n_edges, device=cuda)
    f1, f2 = (bd.launch_fwd(up, v, a, layout) for _ in range(2))
    b1, b2 = (bd.launch_bwd(g, up, u, v, a, layout) for _ in range(2))
    assert torch.equal(f1, f2)
    for x, y in zip(b1, b2):
        assert torch.equal(x, y)


def test_bilinear_decoder_autograd_matches_cpu(cuda):
    """The differentiable decoder on the card (the kernels) against the same
    call on the CPU (the plain version): logits and every input's
    gradient."""
    from dream_gnn_tpu_torch.kernels.bilinear_decoder import (
        bilinear_decoder, build_bilinear_layout)

    layout, u, v, pb, a, lab = _bilinear_case(cuda, 500, 300, 20_000, 10, 4,
                                              75, seed=5, heavy=500)
    cpu = build_bilinear_layout(layout.src.cpu(), layout.dst.cpu(), 500, 300,
                                device="cpu")
    outs = []
    for dev, lay in ((cuda, layout), (torch.device("cpu"), cpu)):
        xs = [x.detach().to(dev).requires_grad_(True) for x in (u, v, pb, a)]
        logits = bilinear_decoder(*xs, lay)
        torch.nn.functional.cross_entropy(logits.T, lab.to(dev)).backward()
        outs.append([logits.detach().cpu()] + [x.grad.cpu() for x in xs])
    for x, y in zip(*outs):
        assert _rel(x, y) <= 1e-5


def test_bilinear_kernel_refuses_other_shapes(cuda):
    from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd

    layout, u, v, pb, a, _ = _bilinear_case(cuda, 50, 40, 300, 10, 4, 16,
                                            heavy=20)
    up = (u @ bd.basis_cat(pb)).reshape(-1, 4, 16)
    with pytest.raises(ValueError):
        bd.launch_fwd(up, v, a[:3], layout)
    with pytest.raises(ValueError):
        bd.launch_fwd(up.double(), v, a, layout)
