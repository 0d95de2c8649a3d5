"""A device trace of a few steps and what the per-layer metrics read from
it: the device's busy time, kernel launches, the time of kernels by name,
and the idle gaps with what the host was doing in each.

The trace is ``torch.profiler``'s (CUPTI on the card), exported as a Chrome
trace into a temporary file that is read and removed.  Times are seconds.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "python_function")


class Trace:
    def __init__(self, events: list, steps: int):
        self.steps = steps
        self.device = sorted(
            (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"],
             e["cat"]) for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X")
        self.host = sorted(
            (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"])
            for e in events if e.get("cat") in HOST_CATS
            and e.get("ph") == "X")
        starts = [e[0] for e in self.host] + [e[0] for e in self.device]
        ends = [e[1] for e in self.host] + [e[1] for e in self.device]
        self.t0 = min(starts) if starts else 0.0
        self.t1 = max(ends) if ends else 0.0

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        merged = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    @property
    def launches(self) -> int:
        return sum(1 for *_, cat in self.device if cat == "kernel")

    def kernel_seconds(self, pattern: str) -> float:
        """Device time of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, name, cat in self.device
                   if cat == "kernel" and rx.search(name))

    def device_ops(self, n: int = 10):
        by_name = {}
        for s, e, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10):
        """The longest gaps between device work, each named by the
        innermost host event running at its middle."""
        busy = self.busy_intervals()
        edges = [(self.t0, busy[0][0])] if busy else []
        edges += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        if busy:
            edges.append((busy[-1][1], self.t1))
        gaps = sorted(((e - s, s, e) for s, e in edges if e > s),
                      reverse=True)[:n]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            inside = [h for h in self.host if h[0] <= mid <= h[1]]
            name = min(inside, key=lambda h: h[1] - h[0])[2] if inside \
                else "host (no traced op)"
            out.append([name[:160], length])
        return out


def record(step, n_steps: int, device) -> Trace:
    """Profiles ``step(n_steps)``, the device synchronised on both
    sides."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        step(n_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Trace(events, n_steps)
