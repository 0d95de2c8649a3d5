"""The readers of the program's spans on a hand-made trace and table: the
host syncs counted inside the ``dream/step`` ranges only, nothing read
where there is nothing to read, the arithmetic of the span metrics, and
each traced run reading its own spans."""

from __future__ import annotations

import os
import sys

import pytest
import torch

from gnnbench import harness, spans
from gnnbench.trace import Trace
from gnnbench.tests import tinyroot

NEW = ("forward_ms", "backward_ms", "optimizer_ms", "host_syncs_per_step",
       "decoder_span_roofline", "spmm_span_roofline")


def reader(name):
    return harness.load_module(
        harness.reader_path(os.path.join(tinyroot.BENCH, "metrics"), name),
        f"test_spans_{name}")


def host(name, start, end):
    """A host event of a Chrome trace, in seconds."""
    cat = "user_annotation" if name.startswith("dream/") else "cuda_runtime"
    return dict(ph="X", cat=cat, name=name, ts=start * 1e6,
                dur=(end - start) * 1e6)


class Ctx:
    def __init__(self, trace, counts=None):
        self.trace, self.counts = trace, counts or {}


@pytest.fixture
def table(monkeypatch):
    """Hands the readers ``table[0]`` as the program's span totals, and
    counts the clears."""
    from dream_gnn_tpu_torch.utils import profiling

    got = [{}, 0]

    def clear():
        got[1] += 1

    monkeypatch.setattr(spans, "_taken", (None, None))
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(got[0]))
    monkeypatch.setattr(profiling, "clear_spans", clear)
    return got


def two_steps():
    return Trace([
        host("dream/step", 0.0, 1.0), host("dream/forward", 0.1, 0.5),
        host("cudaStreamSynchronize", 0.2, 0.3),        # in step 1
        host("cudaMemcpyAsync", 0.6, 0.7),              # not a sync
        host("cudaStreamSynchronize", 1.5, 1.6),        # between the steps
        host("dream/step", 2.0, 3.0),
        host("cudaEventSynchronize", 2.1, 2.2),         # in step 2
        host("cudaMemcpy", 2.9, 3.2),                   # starts in step 2
        host("cudaDeviceSynchronize", 3.5, 3.6),        # after the steps
    ], steps=2)


def test_syncs_outside_the_steps_are_not_counted(table):
    table[0] = {"step": (2, 0.004)}
    assert reader("host_syncs_per_step").read(Ctx(two_steps())) == 1.5


def test_the_span_arithmetic(table):
    table[0] = {"step": (2, 0.09), "forward": (2, 0.05),
                "backward": (2, 0.03), "optimizer": (2, 0.008),
                "decoder": (2, 0.004), "decoder_bwd": (2, 0.016),
                "segment_sum": (48, 0.02)}
    ctx = Ctx(two_steps(), dict(decoder_least_s=0.0005,
                                segment_sum_bytes=3.35e9))
    assert reader("forward_ms").read(ctx) == pytest.approx(25.0)
    assert reader("backward_ms.scale").read(ctx) == pytest.approx(15.0)
    assert reader("optimizer_ms").read(ctx) == pytest.approx(4.0)
    # 0.5 ms of least time a step, 2 steps, over 20 ms of decoder spans.
    assert reader("decoder_span_roofline").read(ctx) == pytest.approx(5.0)
    # 1 ms a step at 3.35 TB/s, 2 steps, over 20 ms of segment sums.
    assert reader("spmm_span_roofline").read(ctx) == pytest.approx(10.0)
    assert table[1] == 1          # one snapshot for every reader of a run


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(table, name, monkeypatch):
    counts = dict(decoder_least_s=1e-3, segment_sum_bytes=1e9)
    read = reader(name).read
    # No trace.
    assert read(Ctx(None, counts)) is None
    # No span recorded.
    assert read(Ctx(two_steps(), counts)) is None
    # The CPU: spans counted, no device time.
    table[0] = {n: (2, None) for n in ("step", "forward", "backward",
                                       "optimizer", "decoder",
                                       "decoder_bwd", "segment_sum")}
    assert read(Ctx(two_steps(), counts)) is None
    # Spans of another run: a step count that is not the traced steps'.
    table[0] = {n: (3, 0.01) for n in table[0]}
    assert read(Ctx(two_steps(), counts)) is None
    # A program without spans.
    monkeypatch.setitem(sys.modules, "dream_gnn_tpu_torch.utils.profiling",
                        None)
    assert read(Ctx(Trace([], steps=2), counts)) is None


def test_each_traced_run_reads_its_own_spans(monkeypatch):
    """Through the program's own table: the spans of one traced run, then
    of another, in one process."""
    from torch.autograd import profiler as autograd_profiler

    from dream_gnn_tpu_torch.utils.profiling import clear_spans, span

    monkeypatch.setattr(spans, "_taken", (None, None))
    clear_spans()
    try:
        monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
        for _ in range(2):
            with span("step"):
                pass
        first = Ctx(Trace([], steps=2))
        assert spans.table(first) == {"step": (2, None)}
        for _ in range(3):
            with span("step"):
                with span("forward"):
                    pass
        second = Ctx(Trace([], steps=3))
        assert spans.table(second) == {"step": (3, None),
                                       "forward": (3, None)}
        assert spans.table(second) == {"step": (3, None),
                                       "forward": (3, None)}
    finally:
        clear_spans()


def test_a_profiled_step_of_the_program_holds_the_ranges(tiny_root,
                                                         monkeypatch):
    """The program's ranges reach the harness's trace, and the readers find
    no device time on the CPU."""
    from gnnbench import trace as tracing

    cell = harness.find_cell("t-tiny-scale", tiny_root, trace=True)
    run = cell.driver.build(cell.config, cell.traffic, 2 ** 31 + 3,
                            torch.device("cpu"))
    t = tracing.record(run.step, 2, torch.device("cpu"))
    names = [name for _, _, name in t.host if name.startswith("dream/")]
    assert names.count("dream/step") == 2
    assert {"dream/forward", "dream/backward", "dream/optimizer",
            "dream/segment_sum", "dream/decoder_bwd"} <= set(names)
    ctx = Ctx(t, run.counts())
    monkeypatch.setattr(spans, "_taken", (None, None))
    assert spans.table(ctx)["step"] == (2, None)
    assert all(reader(n).read(ctx) is None for n in NEW)
