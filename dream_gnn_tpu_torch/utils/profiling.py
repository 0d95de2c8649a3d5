"""Profiling and step timing.

Port of ``dream_gnn_tpu/utils/profiling.py``.  The reference's only
instrumentation is one wall-clock print (train.py:248,354-355).  Here:

- ``trace(dir)``: a context manager that runs ``torch.profiler`` (host
  and, where a card is present, CUDA activity) over everything inside and
  writes a Chrome trace (``trace_<pid>.json``, readable by
  chrome://tracing or Perfetto) into ``dir``; no TensorBoard package is
  needed.  The JAX ``trace`` writes a ``jax.profiler`` xplane trace.
- ``StepTimer``: the time of runs of steps, with CUDA events on the card
  and the host clock on the CPU; ``ms_per_step`` is the mean over every
  timed step (the JAX ``StepTimer`` keeps an EMA of host-clock readings).
- ``span(name)``: a named range of the training step (``dream/<name>``
  in the trace), with its device-stream seconds; see ``span``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def trace_path(log_dir: str) -> str:
    """The Chrome trace file that ``trace(log_dir)`` writes."""
    return os.path.join(log_dir, f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the enclosed block into ``log_dir`` (nothing if None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(trace_path(log_dir))


class StepTimer:
    """Time of runs of steps: CUDA events on the card, else the host
    clock.  ``ms_per_step`` is the mean over every timed step."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.total_ms = 0.0
        self.total_steps = 0

    def start(self):
        if self.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        else:
            self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float:
        """Ends the run of ``n_steps`` steps; returns its ms per step."""
        if self.cuda:
            self._ev[1].record()
            self._ev[1].synchronize()
            ms = self._ev[0].elapsed_time(self._ev[1])
        else:
            ms = (time.perf_counter() - self._t0) * 1e3
        self.total_ms += ms
        self.total_steps += n_steps
        return ms / max(n_steps, 1)

    @property
    def ms_per_step(self) -> Optional[float]:
        return self.total_ms / self.total_steps if self.total_steps else None


# ---------------------------------------------------------------------------
# Spans.

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: dict = {}                   # name -> [count, device seconds | None]
_pending: collections.deque = collections.deque()   # (name, start, end)
_free: list = []    # resolved timing events, reused: no span makes new ones


def span(name: str):
    """A context manager over one named part of the training step.

    Off, when no ``torch.profiler`` is recording, it is a shared null
    context: one module-attribute check.  On (the CLI's ``--profile_dir``,
    a profiler of the caller's), it enters
    ``torch.profiler.record_function("dream/" + name)``, whose range lands
    in the Chrome trace on the kernels' clock, and, once CUDA is in use, it
    records a pair of timing events on the current stream around the
    range: the span's device-stream seconds, which hold its kernels and any
    wait of the stream for the host between them.  ``span_totals`` sums
    them per name.  Events are resolved with ``Event.query`` as later
    spans close, never by waiting inside a step; the host runs only a
    launch queue's depth ahead of the device, which bounds the events in
    flight.  Spans may close on the autograd engine's thread; parents are
    not tracked."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _event() -> torch.cuda.Event:
    return _free.pop() if _free else torch.cuda.Event(enable_timing=True)


def _resolve(wait: bool):
    """Adds the device seconds of the finished spans, oldest first, to the
    totals; with ``wait``, of every span recorded.  Holds ``_lock``."""
    while _pending:
        name, start, end = _pending[0]
        if wait:
            end.synchronize()
        elif not end.query():
            return
        _pending.popleft()
        entry = _totals[name]
        entry[1] = (entry[1] or 0.0) + start.elapsed_time(end) * 1e-3
        _free.extend((start, end))


class _Span:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function("dream/" + name)
        self.start = None

    def __enter__(self):
        self.range.__enter__()
        if torch.cuda.is_initialized():
            with _lock:
                self.start = _event()
            self.start.record()
        return self

    def __exit__(self, *exc):
        end = None
        if self.start is not None:
            with _lock:
                end = _event()
            end.record()
        self.range.__exit__(*exc)
        with _lock:
            _totals.setdefault(self.name, [0, None])[0] += 1
            if end is not None:
                _pending.append((self.name, self.start, end))
                _resolve(wait=False)
        return False


def span_totals() -> dict:
    """name -> (count, device seconds) of every span closed since the last
    ``clear_spans``; the seconds are None where no CUDA event timed the
    span (on the CPU).  Waits for the device to reach the spans' ends, so
    call it outside the step."""
    with _lock:
        _resolve(wait=True)
        return {k: (c, s) for k, (c, s) in _totals.items()}


def clear_spans():
    """Forgets every span recorded so far."""
    with _lock:
        _totals.clear()
        _pending.clear()
