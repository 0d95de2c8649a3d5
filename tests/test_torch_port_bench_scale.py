"""The port's two benchmark entry points on the CPU at their smallest sizes:
``dream_gnn_tpu_torch.scripts.bench_scale --tiny --device -1`` in both
encoder layouts (padded COO and grouped) and in its multi-device modes over
gloo ranks (``--sharded``, ``--sharded-grouped``, ``--ring``,
``--cpu-mesh``), and ``dream_gnn_tpu_torch.scripts.bench_spmm --small
--device -1``.  The steps and repetitions are cut to keep the run short
(module constants, patched, or ``--steps``/``--repeats``).

bench_scale's two layouts run the same problem and the same weights and
differ only in the encoder's messages (f32 in the COO layout, bf16 in the
grouped SpMM), so their losses after two steps agree within 1e-2.
bench_spmm's fp32 SpMMs sum the same f32 products as the segment sum in
another order: relative error below 1e-5.
"""

import numpy as np
import pytest

from dream_gnn_tpu_torch.scripts import bench_scale, bench_spmm


@pytest.fixture
def short(monkeypatch):
    monkeypatch.setattr(bench_scale, "STEPS", 2)
    monkeypatch.setattr(bench_scale, "REPEATS", 1)
    monkeypatch.setattr(bench_spmm, "REPS", 1)


def test_bench_scale_runs_in_both_layouts(short, capsys):
    losses = []
    for flags in ([], ["--grouped"]):
        res = bench_scale.main(["--tiny", "--device", "-1", *flags])
        out = capsys.readouterr().out
        assert f"grouped={bool(flags)}" in out
        assert "ms/step" in out and "edges/s" in out
        assert res["ms_per_step"] > 0 and res["peak_memory_bytes"] is None
        # 3 layers x 2 directions x 8,000 edges and 10,000 candidates,
        # forward and backward.
        assert res["edges_per_s"] == pytest.approx(
            2 * (3 * 2 * 8000 + 10_000) / res["ms_per_step"] * 1e3)
        losses.append(res["loss"])
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) < 1e-2


@pytest.mark.parametrize("flags", [["--sharded", "--nproc", "2"],
                                   ["--sharded-grouped", "--nproc", "2"],
                                   ["--ring", "--nproc", "2"],
                                   ["--cpu-mesh"]])
def test_bench_scale_multi_device_modes_run(flags, capfd):
    """The multi-device modes over gloo ranks on the CPU: 2 spawned ranks
    for the three layouts (two steps, one repeat), the JAX script's 8-rank
    check for ``--cpu-mesh``.  The loss after the same steps is the one
    device's within 1e-2 (the grouped layouts' bf16 messages; the sharded
    COO layout sums the same f32 messages as the one-device COO layout)."""
    short = ["--steps", "2", "--repeats", "1"]
    res = bench_scale.main(["--tiny", "--device", "-1", *flags, *short])
    out = capfd.readouterr().out
    assert np.isfinite(res["loss"])
    assert "backend gloo" in out
    if flags == ["--cpu-mesh"]:
        assert "cpu-mesh check OK" in out and "world size 8" in out
        return
    assert "world size 2" in out and "ms/step" in out
    assert res["world_size"] == 2 and res["ms_per_step"] > 0
    assert res["edges_per_s"] == pytest.approx(
        2 * (3 * 2 * 8000 + 10_000) / res["ms_per_step"] * 1e3)
    one = bench_scale.main(["--tiny", "--device", "-1", *short]
                           + (["--grouped"] if flags[0] != "--sharded"
                              else []))
    assert abs(res["loss"] - one["loss"]) < 1e-2


def test_bench_spmm_runs(short, capsys):
    res = bench_spmm.main(["--small", "--device", "-1"])
    out = capsys.readouterr().out
    assert res["rel err blocked"] < 1e-5 and res["rel err gather"] < 1e-5
    for name in ("segment_sum fwd", "segment_sum fwd+bwd",
                 "blocked cuda fwd (bf16)", "blocked cuda fwd (fp32)",
                 "blocked cuda fwd+bwd", "gather cuda fwd (bf16)",
                 "gather cuda fwd (fp32)", "gather cuda fwd+bwd"):
        assert res[name] > 0 and name in out
