"""The training step's spans (``utils/profiling.py:span``): off without a
profiler, nested ``dream/*`` ranges in the Chrome trace under one, counts
and device seconds in ``span_totals``, and the same bits either way.

Three steps: a stacked grid step and a stacked edges step of three folds
of the small preset, and a sequential step of the scale path's model over
a slabbed encoder graph (where the segment sums run), each with the
default augmentation and dropout on.  No JAX.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.config import ModelConfig, TrainConfig
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.model.dream_gnn import init_params
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
from dream_gnn_tpu_torch.train import scale
from dream_gnn_tpu_torch.train.loop import derive_model_cfg
from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                               init_state_stacked,
                                               make_one_step_stacked)
from dream_gnn_tpu_torch.train.step import (init_state, make_one_step,
                                            run_steps)
from dream_gnn_tpu_torch.utils import profiling
from dream_gnn_tpu_torch.utils.profiling import (clear_spans, span,
                                                 span_totals)

SMALL_DATA = dict(n_drug=40, n_dis=30, n_pos=60, seed=3)
SMALL_MODEL = dict(layers=2, gcn_agg_units=48, gcn_out_units=16, nhid1=32,
                   nhid2=16, decoder_backend="pallas")
N, N_ENC, N_CAND, D = 300, 3000, 400, 16
SCALE_MODEL = dict(layers=1, gcn_agg_units=48, gcn_out_units=16,
                   src_in_units=D, dst_in_units=D, fdim_drug=D,
                   fdim_disease=D, nhid1=24, nhid2=16,
                   decoder_backend="pallas")
STEPS = 3
KINDS = ["stacked-grid", "stacked-edges", "sequential-slabbed"]
# Each is nested in the one before it, or in the span named beside it.
INSIDE = {"forward": "step", "augment": "forward", "gcmc": "forward",
          "fgcn": "forward", "attention": "forward", "decoder": "forward",
          "loss": "forward", "backward": "step", "decoder_bwd": "backward",
          "optimizer": "step", "adam": "optimizer"}


@pytest.fixture(autouse=True)
def _no_spans_left():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture(scope="module")
def dataset():
    return DreamDataset(synthetic_raw_data(**SMALL_DATA), k=4, device="cpu")


@pytest.fixture(scope="module")
def problem():
    return scale.build_problem(np.random.default_rng(5), n_drug=N, n_dis=N,
                               d=D, n_enc=N_ENC, n_cand=N_CAND)


def _build(kind, dataset, problem):
    """(one_step, state, args) of a fresh run of ``kind``."""
    if kind == "sequential-slabbed":
        inputs, _, labels, _, weight, _, _ = scale.build_inputs(
            problem, N, N, "cpu")
        model = ModelConfig(**SCALE_MODEL)
        train = TrainConfig(model=model)
        state = init_state(init_params(torch.Generator().manual_seed(7),
                                       model),
                           torch.Generator().manual_seed(11), train)
        return make_one_step(model, train), state, (inputs, labels, weight)
    mode = kind.split("-")[1]
    train = TrainConfig(model=ModelConfig(**SMALL_MODEL, decode_mode=mode))
    model = derive_model_cfg(train, dataset)
    train = dataclasses.replace(train, model=model)
    folds = stack_folds(dataset, [0, 1, 2], side="train")
    state = init_state_stacked(
        init_params_stacked(model, [7], [0, 1, 2], "cpu"),
        torch.Generator().manual_seed(11), train)
    return (make_one_step_stacked(model, train), state,
            (folds.inputs, folds.labels, folds.edge_weight))


def _steps(kind, dataset, problem):
    one_step, state, args = _build(kind, dataset, problem)
    losses = run_steps(one_step, state, STEPS, *args)
    return losses, state.generator.get_state()


def _profiled(kind, dataset, problem, tmp_path):
    """The steps under ``torch.profiler``, and the ``dream/*`` ranges of
    its Chrome trace as (name, start, end, thread), by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _steps(kind, dataset, problem)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("dream/"):],
                     e["tid"]) for e in events
                    if e.get("ph") == "X" and e["name"].startswith("dream/"))
    return out, [(n, s, e, t) for s, e, n, t in ranges]


def test_off_without_a_profiler(dataset, problem, monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    _steps("stacked-grid", dataset, problem)
    assert entered == [] and span_totals() == {}
    assert span("step") is span("forward")       # the shared null context


@pytest.mark.parametrize("kind", KINDS)
def test_the_trace_nests_the_step(kind, dataset, problem, tmp_path):
    _, ranges = _profiled(kind, dataset, problem, tmp_path)
    names = {n for n, *_ in ranges}
    assert set(INSIDE) | {"step"} <= names
    assert ("segment_sum" in names) == (kind == "sequential-slabbed")
    steps = [r for r in ranges if r[0] == "step"]
    assert len(steps) == STEPS
    for name, s, e, tid in ranges:
        if name == "step":
            continue
        # Every range lies inside a step, and in its parent's range.
        parent = INSIDE.get(name)
        if name == "segment_sum":
            parent = "gcmc" if any(p == "gcmc" and ps <= s and e <= pe
                                   for p, ps, pe, _ in ranges) \
                else "backward"
        assert any(p == parent and ps <= s and e <= pe
                   for p, ps, pe, _ in ranges), (name, parent)
    for _, s, e, _ in steps:
        inside = [n for n, rs, re, _ in ranges if s <= rs and re <= e
                  and n in ("forward", "backward", "optimizer")]
        assert inside == ["forward", "backward", "optimizer"]


@pytest.mark.parametrize("kind", KINDS)
def test_totals_count_the_steps_without_device_time(kind, dataset, problem,
                                                    tmp_path):
    _profiled(kind, dataset, problem, tmp_path)
    totals = span_totals()
    assert totals["step"] == (STEPS, None)
    for name in ("forward", "backward", "optimizer", "adam", "loss"):
        assert totals[name] == (STEPS, None)
    assert all(s is None for _, s in totals.values())
    clear_spans()
    assert span_totals() == {}


@pytest.mark.parametrize("kind", KINDS)
def test_spans_change_no_bits(kind, dataset, problem, tmp_path):
    losses, gen = _steps(kind, dataset, problem)
    (traced, traced_gen), _ = _profiled(kind, dataset, problem, tmp_path)
    assert torch.equal(losses, traced)
    assert torch.equal(gen, traced_gen)


class _Event:
    """A stand-in for ``torch.cuda.Event``: the device reaches an event
    when the test says so."""

    clock = 0.0
    made = 0

    def __init__(self, enable_timing):
        assert enable_timing
        _Event.made += 1
        self.at, self.done = None, False

    def record(self):
        _Event.clock += 1.0
        self.at, self.done = _Event.clock, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.at - self.at            # ms


def test_device_time_is_resolved_without_waiting_and_reused(monkeypatch):
    from torch.autograd import profiler as autograd_profiler

    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(profiling, "_free", [])
    monkeypatch.setattr(_Event, "made", 0)
    with span("step"):
        with span("forward"):
            pass
    # The device has reached neither end: nothing resolved, nothing waited.
    assert [n for n, *_ in profiling._pending] == ["forward", "step"]
    for _ in range(100):
        for _, _, end in list(profiling._pending):
            end.done = True
        with span("step"):
            pass
    # Each closing span resolves the finished ones, whose events are reused.
    assert len(profiling._pending) == 1 and _Event.made <= 6
    count, seconds = span_totals()["step"]
    assert count == 101 and not profiling._pending
    assert seconds == pytest.approx(101 * 1e-3 * 1.0 + 2e-3)
    assert span_totals()["forward"] == (1, pytest.approx(1e-3))
