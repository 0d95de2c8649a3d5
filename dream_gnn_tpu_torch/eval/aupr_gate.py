"""Per-fold AUPR distribution artifact and regression gate.

A copy of ``dream_gnn_tpu/eval/aupr_gate.py`` (numpy only; the port imports
nothing of the JAX package), with the same tolerances.

The synthetic protocol's per-fold test AUPR is bimodal: some CV folds
place most of a latent cluster's positives in the test split, so the
structure recoverable for that fold differs, not the model.  A seed-level
mean therefore moves when folds merely hop basins, and a real regression
(both basin centers shifting down) looks like such a hop.  So:

- ``collect_fold_auprs`` parses the per-fold ``experiment_results.csv``
  artifacts of a protocol run;
- ``distribution_summary`` fits the two basins (1-D 2-means) and records
  center, spread and weight per basin; ``write_distribution`` writes it
  to ``aupr_distribution.json`` next to the run;
- ``gate`` compares a new run's per-fold AUPRs against a stored summary,
  holding basin centers to a band while leaving mixture weights free:
  basin-hopping passes, a center shift fails.

The reference has no regression gating of any kind (its results are
eyeballed CSVs, train.py:522-556).
"""

from __future__ import annotations

import csv
import glob
import json
import os

import numpy as np

# A basin center moving by more than this is a regression; the Gdataset
# basins of the JAX package's runs sit ~0.25 apart, so 0.06 separates
# "center moved" from basin-assignment jitter with wide margin on both sides.
CENTER_TOL = 0.06
# New samples may not exceed the reference extremes by more than this.
RANGE_TOL = 0.08


def collect_fold_auprs(results_dir: str) -> np.ndarray:
    """All per-fold best test AUPRs under ``{results_dir}/seed_*/``."""
    vals = []
    for path in sorted(glob.glob(
            os.path.join(results_dir, "seed_*", "experiment_results.csv"))):
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                if row["fold"] != "average":
                    vals.append(float(row["aupr"]))
    return np.asarray(vals, np.float64)


def _two_means(x: np.ndarray, iters: int = 50):
    """1-D 2-means: returns (threshold, lo_center, hi_center)."""
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-9:
        return hi, lo, hi
    c0, c1 = lo, hi
    for _ in range(iters):
        t = (c0 + c1) / 2.0
        lo_set, hi_set = x[x <= t], x[x > t]
        if not len(lo_set) or not len(hi_set):
            break
        n0, n1 = lo_set.mean(), hi_set.mean()
        if n0 == c0 and n1 == c1:
            break
        c0, c1 = float(n0), float(n1)
    return (c0 + c1) / 2.0, c0, c1


def distribution_summary(auprs: np.ndarray) -> dict:
    t, c_lo, c_hi = _two_means(auprs)
    lo, hi = auprs[auprs <= t], auprs[auprs > t]
    q = np.quantile(auprs, [0.05, 0.25, 0.5, 0.75, 0.95])
    return {
        "n": int(auprs.size),
        "mean": float(auprs.mean()),
        "std": float(auprs.std()),
        "min": float(auprs.min()),
        "max": float(auprs.max()),
        "quantiles": {"p05": q[0], "p25": q[1], "p50": q[2],
                      "p75": q[3], "p95": q[4]},
        "basin_threshold": float(t),
        "lo_center": float(lo.mean()) if len(lo) else None,
        "lo_std": float(lo.std()) if len(lo) else None,
        "lo_weight": float(len(lo) / auprs.size),
        "hi_center": float(hi.mean()) if len(hi) else None,
        "hi_std": float(hi.std()) if len(hi) else None,
        "hi_weight": float(len(hi) / auprs.size),
    }


def write_distribution(results_dir: str) -> dict:
    auprs = collect_fold_auprs(results_dir)
    if not auprs.size:
        raise ValueError(f"no per-fold artifacts under {results_dir}")
    summary = distribution_summary(auprs)
    out = os.path.join(results_dir, "aupr_distribution.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def gate(observed: np.ndarray, ref: dict, *,
         center_tol: float = CENTER_TOL,
         range_tol: float = RANGE_TOL) -> tuple[bool, dict]:
    """(ok, report).  Passes under basin-hopping (mixture weights may
    differ arbitrarily), fails when a basin center drops by more than
    ``center_tol`` or samples fall below the reference support."""
    observed = np.asarray(observed, np.float64)
    report: dict = {"n": int(observed.size), "checks": {}}
    ok = True

    lo_floor = ref["min"] - range_tol
    hi_ceil = ref["max"] + range_tol
    in_range = bool(observed.min() >= lo_floor
                    and observed.max() <= hi_ceil)
    report["checks"]["support"] = {
        "ok": in_range, "observed_min": float(observed.min()),
        "observed_max": float(observed.max()),
        "allowed": [lo_floor, hi_ceil]}
    ok &= in_range

    # Assign each observed fold to the nearer reference basin center;
    # compare per-basin observed centers (weights unconstrained).
    t = ref["basin_threshold"]
    for name, center in (("lo", ref["lo_center"]),
                         ("hi", ref["hi_center"])):
        if center is None:
            continue
        members = observed[observed <= t] if name == "lo" \
            else observed[observed > t]
        if not len(members):
            # Whole-run basin hop: legal, nothing to compare.
            report["checks"][f"{name}_center"] = {"ok": True, "n": 0}
            continue
        obs_c = float(members.mean())
        # Regression = center moved DOWN; upward moves are improvements.
        c_ok = bool(obs_c >= center - center_tol)
        report["checks"][f"{name}_center"] = {
            "ok": c_ok, "n": int(len(members)), "observed": obs_c,
            "reference": center, "floor": center - center_tol}
        ok &= c_ok

    report["ok"] = bool(ok)
    return bool(ok), report
