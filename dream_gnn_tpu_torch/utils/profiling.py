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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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
