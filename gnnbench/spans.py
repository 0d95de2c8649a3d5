"""The program's spans in a traced run: the table of
``dream_gnn_tpu_torch.utils.profiling.span_totals`` (name -> count and
device-stream seconds, timed by CUDA events on the card) and what the
readers of the span metrics share.

The spans are recorded only while a profiler runs, so in a run the table
holds the traced sub-window's.  The first reader of a run takes the table
once and clears it, so that a later traced run in the same process reads
only its own spans.  Everything here gives None where there is nothing to
read: no trace, a program without spans, no span of the name, or no
device time (the CPU).
"""

from __future__ import annotations

from typing import Optional

_taken = (None, None)       # (the Trace the table was taken for, the table)


def table(ctx) -> Optional[dict]:
    """name -> (count, device seconds or None) of the spans of ``ctx``'s
    traced sub-window; None where there are none, or where their ``step``
    count is not the traced steps' (spans of another run)."""
    global _taken
    if ctx.trace is None:
        return None
    if _taken[0] is not ctx.trace:
        try:
            from dream_gnn_tpu_torch.utils.profiling import (clear_spans,
                                                             span_totals)
        except ImportError:
            return None
        _taken = (ctx.trace, span_totals())
        clear_spans()
    got = _taken[1]
    if not got or got.get("step", (0, None))[0] != ctx.trace.steps:
        return None
    return got


def device_s(ctx, *names) -> Optional[float]:
    """Summed device seconds of the spans ``names``, or None unless each
    has some."""
    got = table(ctx)
    if got is None or any(got.get(n, (0, None))[1] is None for n in names):
        return None
    return sum(got[n][1] for n in names)


def ms_per_step(ctx, name: str) -> Optional[float]:
    """Device-stream milliseconds a step of the span ``name``."""
    seconds = device_s(ctx, name)
    return None if seconds is None else 1e3 * seconds / ctx.trace.steps
