"""Card-only checks of the port: the CUDA decoder kernels (grid and per
edge, single-fold and fold-batched) and the scale path's kernels (the
segmented sum behind spmm_slab and seq_scatter, the scale decoder's K2, B1
and mirror) against their plain versions at ragged shapes, their input
checks, and the trainers' use of them.  Every test
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
                                   (2000, 1500, 40000, 128)])
def test_spmm_kernel_matches_plain(cuda, dtype, shape):
    """Forward and transposed layouts, d = 3 (the one-column path), 16 and
    128, against segment_sum_plain on the same tensors; twice the same
    bits."""
    from dream_gnn_tpu_torch.kernels import spmm_slab as sp

    (pair, _), x = _csr_case(cuda, *shape)
    rounded = dtype == torch.bfloat16
    for g in (pair.fwd, pair.bwd):
        xr = torch.randn(g.n_src, x.shape[1], device=cuda).to(dtype)
        out = sp.launch_segment_sum(g.row_ptr, g.src, g.val, xr, rounded)
        ref = sp.segment_sum_plain(g.row_ptr, g.src, g.val, xr, rounded)
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (g.n_dst, x.shape[1])
        assert _rel(out, ref) <= TOL[dtype]
        assert torch.equal(out, sp.launch_segment_sum(g.row_ptr, g.src,
                                                      g.val, xr, rounded))


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
