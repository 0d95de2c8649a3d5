"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, from the same inputs, weights and
draws.

Readings of either side (each model of a stack is judged on its own):
- ``loss``: (steps, n) the loss of each of the first steps;
- ``grad``: (L, n) the norm of each leaf of the first gradient as Adam
  takes it (after the clip and the decay term); the program's is worked out
  from its optimizer's first moment after one step;
- ``change``: (L, n) the norm of each leaf's change over the steps;
- ``eval``: (n, 2, 2) AUROC and AUPR on the train side and the test side
  after the steps;
- ``draws``: the state of the generator of the step's draws after the
  steps;
- ``grad_raw`` (the reference only): (L, n) the raw first gradient's
  norms, which pick the leaves that the change leaves out: those under a
  thousandth of the median leaf's, whose Adam steps are round-off alone.

The numbers, each held to the limit of its own that the cell's limits
file gives:
- ``loss_gap``: the largest |loss_p - loss_r| / |loss_r|;
- ``loss1_gap``: the same over the first step alone, which both sides take
  from the same weights (``calibrate.py`` reads it; no cell holds it);
- ``grad_gap`` and ``change_gap``: by the worst leaf, the gap between the
  two sides' norms, over the reference's norm of that leaf or of the
  model's median leaf, whichever is larger;
- ``eval_gap``: the largest absolute gap of an AUROC or AUPR.

Besides, ``draws_apart`` is 1 where the two generators' states differ after
the steps, else 0, and has the limit 0: the reference then no longer draws
what the program draws (the program changed the order or the shapes of its
draws), and the run cannot be judged.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "eval_gap")
EXACT = {"draws_apart": 0.0}
QUIET_LEAF = 1e-3


def _worst_leaf(p, r, keep=None) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    den = np.maximum(r, np.median(r, axis=0, keepdims=True))
    gap = np.abs(p - r) / np.where(den > 0, den, 1.0)
    if keep is not None:
        gap = np.where(keep, gap, 0.0)
    return float(gap.max())


def _quiet(ref: dict) -> np.ndarray:
    """(L, n) True for the leaves left out of the change."""
    raw = np.asarray(ref["grad_raw"], np.float64)
    return raw < QUIET_LEAF * np.median(raw, axis=0, keepdims=True)


def compare(prog: dict, ref: dict) -> dict:
    lp = np.asarray(prog["loss"], np.float64)
    lr = np.asarray(ref["loss"], np.float64)
    keep = ~_quiet(ref)
    gap = np.abs(lp - lr) / np.abs(lr)
    out = {
        "draws_apart": float(not np.array_equal(prog["draws"],
                                                ref["draws"])),
        "loss_gap": float(np.max(gap)),
        "loss1_gap": float(np.max(gap[0])),
        "grad_gap": _worst_leaf(prog["grad"], ref["grad"]),
        "change_gap": _worst_leaf(prog["change"], ref["change"], keep),
        "eval_gap": float(np.max(np.abs(np.asarray(prog["eval"])
                                        - np.asarray(ref["eval"])))),
    }
    # A number that is not finite fails.
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in
            out.items()}


def judged(limits: dict) -> dict:
    """The limit of each number that a run is judged by, in order: the
    exact ones, then those of the cell's limits file."""
    return {**EXACT, **{k: limits[k] for k in NUMBERS if k in limits}}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= v for k, v in judged(limits).items())


def draws_message(numbers: dict) -> str | None:
    """Why the run cannot be judged, where the draws are out of step."""
    if not numbers["draws_apart"]:
        return None
    return ("the reference's random draws are out of step with the "
            "program's (the generators' states differ after the compared "
            "steps): the program changed the order or the shapes of its "
            "draws, and gnnbench/reference's draw_order has to follow it; "
            "this run is not judged correct")


def quiet_leaves(ref: dict) -> int:
    return int(_quiet(ref).sum())
