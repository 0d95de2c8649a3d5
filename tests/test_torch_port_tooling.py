"""The port's tooling against the JAX package's: the AUPR gate and its
script, the embedding pipeline's numeric core, ``chained_ms`` and its
floor guard, the H100 bounds, and ``--profile_dir``.

- ``eval/aupr_gate.py`` is a numpy copy: its summaries, band files and gate
  reports equal the JAX module's on the same arrays, exactly.
- ``combine_embeddings`` (an exact SVD with sklearn's sign rule) equals the
  JAX one (sklearn's PCA) within 1e-4 of each output's magnitude where
  sklearn's "auto" solver is exact ("full" or "covariance_eigh"; its
  "randomized" choice draws with no fixed state, so nothing reproduces it);
  ``fuzzy_name_map`` is difflib's, equal.
- ``chained_ms`` and its guard behave as in tests/test_timing.py, on the CPU
  (host clock); the decoder bound is the count of PERF.md's table.
- ``trace`` writes a Chrome trace; the CLI's ``--profile_dir`` traces its
  first fold.
"""

import json
import os

import numpy as np
import pytest
import torch

from dream_gnn_tpu.data.embedding import combine_embeddings as j_combine
from dream_gnn_tpu.data.embedding import fuzzy_name_map as j_fuzzy
from dream_gnn_tpu.eval import aupr_gate as jg
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.data.embedding import (combine_embeddings,
                                                fuzzy_name_map)
from dream_gnn_tpu_torch.eval import aupr_gate as tg
from dream_gnn_tpu_torch.scripts import aupr_gate_check
from dream_gnn_tpu_torch.train.cli import main
from dream_gnn_tpu_torch.utils.profiling import trace, trace_path
from dream_gnn_tpu_torch.utils.timing import (ImplausibleTiming, OPS_K2,
                                              bound_ms, chained_ms,
                                              decoder_bound_ms, decoder_flops)

SMALL = ["--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
         "--nhid1", "32", "--nhid2", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    where more threads each only wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixture(rng, n, lo_w, lo_c=0.18, hi_c=0.43, sd=0.02):
    basins = rng.random(n) < lo_w
    return np.where(basins, rng.normal(lo_c, sd, n), rng.normal(hi_c, sd, n))


def test_gate_constants_match_jax():
    assert (tg.CENTER_TOL, tg.RANGE_TOL) == (jg.CENTER_TOL, jg.RANGE_TOL)


@pytest.mark.parametrize("case", ["same", "hop", "one_basin", "shift",
                                  "collapse", "constant"])
def test_gate_matches_jax(case):
    rng = np.random.default_rng(11)
    ref_sample = _mixture(rng, 200, lo_w=0.7)
    obs = {"same": _mixture(rng, 100, 0.7),
           "hop": _mixture(rng, 100, 0.2),
           "one_basin": rng.normal(0.43, 0.02, 100),
           "shift": _mixture(rng, 100, 0.7, lo_c=0.10, hi_c=0.35),
           "collapse": np.abs(rng.normal(0.02, 0.01, 100)),
           "constant": np.full(10, 0.2)}[case]
    ref_t, ref_j = tg.distribution_summary(ref_sample), \
        jg.distribution_summary(ref_sample)
    assert ref_t == ref_j
    assert tg.distribution_summary(obs) == jg.distribution_summary(obs)
    assert tg.gate(obs, ref_t) == jg.gate(obs, ref_j)


def test_band_file_matches_jax(tmp_path):
    """``collect_fold_auprs`` and ``write_distribution`` over a protocol
    run's artifacts give the JAX module's arrays and band file."""
    rng = np.random.default_rng(3)
    for seed in (1, 2, 3):
        d = tmp_path / "run" / f"seed_{seed}"
        d.mkdir(parents=True)
        vals = rng.uniform(0.1, 0.5, 10)
        rows = "".join(f"{i + 1},0.7000,{v:.4f}\n" for i, v in enumerate(vals))
        (d / "experiment_results.csv").write_text(
            "fold,auroc,aupr\n" + rows + f"average,0.7,{vals.mean():.4f}\n")
    run = str(tmp_path / "run")
    np.testing.assert_array_equal(tg.collect_fold_auprs(run),
                                  jg.collect_fold_auprs(run))
    ours = tg.write_distribution(run)
    ours_file = (tmp_path / "run" / "aupr_distribution.json").read_text()
    assert ours == jg.write_distribution(run)
    assert ours_file == (tmp_path / "run" /
                         "aupr_distribution.json").read_text()


def test_gate_against_the_stored_band_matches_jax():
    with open(aupr_gate_check.BAND_PATH) as f:
        ref = json.load(f)
    obs = np.random.default_rng(0).normal(0.18, 0.015, 10)
    assert tg.gate(obs, ref) == jg.gate(obs, ref)


def test_gate_script_needs_a_card_or_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert aupr_gate_check.main([]) == 2
    assert aupr_gate_check.main(["--make-band"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--make-band needs --out" in err


def test_gate_script_runs_the_protocol_on_the_cpu(monkeypatch, tmp_path,
                                                   capsys):
    """The script's modes at a tiny size on the CPU: --make-band writes a
    band to --out, and the gate runs seed 42 against a band and reports."""
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    monkeypatch.setattr(aupr_gate_check, "DATA_NAME", "tiny")
    monkeypatch.setattr(aupr_gate_check, "SHORT_ITERS", 3)
    monkeypatch.setattr(aupr_gate_check, "BAND_SEEDS", [1])
    monkeypatch.setattr(aupr_gate_check, "MODEL", dict(
        aupr_gate_check.MODEL, layers=1, gcn_agg_units=16, gcn_out_units=8,
        nhid1=8, nhid2=8))
    monkeypatch.setattr(aupr_gate_check, "short_cfg",
                        _every_step(aupr_gate_check.short_cfg))
    band = tmp_path / "band.json"
    assert aupr_gate_check.main(["--device", "-1", "--make-band", "--out",
                                 str(band)]) == 0
    summary = json.loads(band.read_text())
    assert summary["n"] == 10 and summary["protocol"]["seeds"] == [1]
    monkeypatch.setattr(aupr_gate_check, "BAND_PATH", str(band))
    rc = aupr_gate_check.main(["--device", "-1"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert ("AUPR_GATE_OK n=10" in out) == (rc == 0)
    assert "per-fold AUPR: " in out and '"checks"' in out


def _every_step(short_cfg):
    import dataclasses

    def cfg(save_dir, iters):
        return dataclasses.replace(short_cfg(save_dir, iters),
                                   train_valid_interval=2)
    return cfg


@pytest.mark.parametrize("shapes,target", [
    ([(40, 48), (40, 64)], 16),          # "full": max(shape) <= 500
    ([(700, 40)], 16),                   # "covariance_eigh": tall, skinny
    ([(300, 20), (300, 30)], 8),         # "covariance_eigh"
    ([(20, 900)], 768),                  # fewer samples than components
    ([(30, 50)], 768),                   # one narrow space: zero-padded
])
def test_combine_embeddings_matches_jax(shapes, target):
    rng = np.random.default_rng(len(shapes) * 100 + target)
    parts = [rng.normal(size=s) for s in shapes]
    ours, ref = combine_embeddings(parts, target), j_combine(parts, target)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_fuzzy_name_map_matches_jax():
    candidates = {"Aspirin": "DB00945", "Ibuprofen": "DB01050",
                  "Acetaminophen": "DB00316", "Metformin": "DB00331"}
    names = ["aspirin", "Ibuprofin", "acetaminophen ", "metforman", "zzz"]
    assert fuzzy_name_map(names, candidates) == j_fuzzy(names, candidates)
    assert fuzzy_name_map(names, candidates, cutoff=0.95) == \
        j_fuzzy(names, candidates, cutoff=0.95)


def test_chained_ms_measures_something_positive():
    x = torch.ones(256, 256)
    ms = chained_ms(lambda x: x @ x, x, n=4, reps=2)
    assert np.isfinite(ms) and ms < 10_000.0


def test_chained_ms_args_are_threaded():
    seen = []

    def fn(x, w):
        seen.append(w)
        return x @ w
    w = torch.full((64, 64), 2.0)
    ms = chained_ms(fn, torch.ones(64, 64), args=(w,), n=3, reps=2)
    assert np.isfinite(ms) and all(s is w for s in seen)
    # Warm-up (1 + 3) and reps x (1 + 3) calls.
    assert len(seen) == 4 + 2 * 4


def test_floor_guard_rejects_impossible_readings():
    x = torch.ones(8, 8)
    with pytest.raises(ImplausibleTiming, match="below the floor"):
        chained_ms(lambda x: x + 1.0, x, n=4, reps=2, floor_ms=6e5,
                   name="guard-test")
    with pytest.raises(ValueError):
        chained_ms(lambda x: x, x, n=1)


def test_bounds_are_the_kernel_tables():
    """Row 1 of PERF.md's table: the grid forward at 593 x 313 in bf16 is
    bound by its operations, 0.00315 ms; the same count in fp32 at 67
    TFLOP/s; a bytes-bound call is bound by its bytes."""
    ms, by = decoder_bound_ms(True, torch.bfloat16, 593, 313)
    assert by == "operations" and round(ms, 5) == 0.00315
    assert decoder_flops(True, 593 * 313) == 593 * 313 * 16768
    assert decoder_flops(False, 10, nf=2) == 2 * 10 * 50176
    ms32, _ = decoder_bound_ms(True, torch.float32, 593, 313)
    assert ms32 == pytest.approx(ms * 989 / 67)
    assert OPS_K2 == 16768
    assert bound_ms(3.35e9, 1.0, torch.bfloat16) == (1.0, "bytes")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(trace_path(str(tmp_path / "tr"))).read())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


@pytest.mark.parametrize("flags", [[], ["--fold_parallel"]])
def test_cli_profile_dir_traces_the_first_fold(monkeypatch, tmp_path, flags):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    prof = tmp_path / "prof"
    main(["--data_name", "tiny", "--device", "-1", "--seeds", "1", "2",
          "--folds", "0", "1", "--train_max_iter", "3",
          "--train_valid_interval", "2", "--profile_dir", str(prof),
          "--save_dir", str(tmp_path / "out"), *SMALL, *flags])
    assert os.listdir(prof) == [os.path.basename(trace_path(str(prof)))]
    events = json.loads(open(trace_path(str(prof))).read())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
