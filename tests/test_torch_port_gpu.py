"""Card-only checks of the port: the CUDA grid decoder kernel against its
plain version at ragged shapes, its input checks, and the trainer's use
of it.  Every test carries the ``gpu`` marker and skips without a CUDA
device.  The file imports no JAX, so that it runs where the card is:

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
    assert gd.LAUNCHES == {"fwd": 2 + 2, "bwd": 2}
