"""Card-only checks of the port: the CUDA decoder kernels (grid and per
edge, single-fold and fold-batched) against their plain versions at ragged
shapes, their input checks, and the trainers' use of them.  Every test
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
    csr = ed.edge_csr(args[6][0], args[6][1], 8, 9)
    with pytest.raises(ValueError, match="dst_off"):
        ed.launch_bwd(*args, 0.0, False, torch.bfloat16, g, csr)


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
