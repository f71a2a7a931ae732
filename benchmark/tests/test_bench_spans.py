"""``spans.reduce_spans`` on hand-made events (ids, times and threads set
by hand, as a profile of a card would give them), and on the events of a
tiny cell's traced run on the CPU."""

from __future__ import annotations

import collections
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, ENGINE, WORKER = 1, 2, 3


class Events:
    """Hand-made profile events: host ranges and ops, the runtime calls
    that launch device work, and the device work itself."""

    def __init__(self):
        self.events = []
        self._id = 1000

    def _add(self, name, start, end, thread, ident=0, link=0,
             device=CPU, annotation=False):
        self.events.append(SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=start, end=end),
            thread=thread, id=ident, linked_correlation_id=link,
            device_type=device, is_user_annotation=annotation))

    def span(self, name, start, end, thread=MAIN):
        self._id += 1
        self._add(name, start, end, thread, self._id, annotation=True)
        # the profiler's copy of the range on the device track
        self._add(name, start + 5, end + 5, 7, self._id, device=CUDA,
                  annotation=True)

    def op(self, name, start, end, thread=MAIN):
        self._id += 1
        self._add(name, start, end, thread, self._id)

    def kernel(self, launch_at, start, end, thread=MAIN, name="kern"):
        """Device work launched at host time ``launch_at`` on ``thread``
        (None: by no call the profiler recorded), run over [start, end]
        (microseconds). An op takes the next id, as the profiler's two
        counters can give one id twice."""
        self._id += 1
        if launch_at is not None:
            self._add("cudaLaunchKernel", launch_at, launch_at + 1, thread,
                      self._id)
        self._add(name, start, end, 7, self._id, device=CUDA)
        self._add("aten::collides", launch_at or 0, (launch_at or 0) + 1,
                  WORKER, self._id)


def test_a_kernel_goes_to_the_innermost_span_of_its_launch():
    ev = Events()
    ev.span("ddstore:forward", 0, 100)
    ev.span("ddstore:head_fwd", 50, 90)
    ev.op("aten::mm", 60, 70)
    # runs after both spans have closed on the host
    ev.kernel(62, 1000, 1400)
    ev.op("aten::add", 20, 30)
    ev.kernel(22, 1400, 1500)
    got = spans.reduce_spans(ev.events, 2)
    # ms a traced step: microseconds / 1e3 / 2 steps
    assert got["device_ms"] == {"ddstore:forward": 0.25,
                                "ddstore:head_fwd": 0.2}
    assert got["self_ms"] == {"ddstore:forward": 0.05,
                              "ddstore:head_fwd": 0.2}
    assert got["unattributed_ms"] == 0


def test_self_time_leaves_out_the_children_and_counts_overlap_once():
    ev = Events()
    ev.span("ddstore:backward", 0, 100)
    ev.span("ddstore:head_bwd", 10, 40)
    ev.op("aten::mm", 12, 20)
    ev.kernel(13, 100, 300)
    ev.op("aten::mul", 50, 60)
    ev.kernel(51, 200, 400)  # overlaps the head's kernel
    ev.kernel(52, 400, 500)
    got = spans.reduce_spans(ev.events, 1)
    assert got["device_ms"]["ddstore:backward"] == pytest.approx(0.4)
    assert got["device_ms"]["ddstore:head_bwd"] == pytest.approx(0.2)
    assert got["self_ms"]["ddstore:backward"] == pytest.approx(0.3)
    assert got["self_ms"]["ddstore:head_bwd"] == pytest.approx(0.2)


def test_the_autograd_engine_thread_nests_in_the_main_threads_span():
    ev = Events()
    ev.span("ddstore:backward", 0, 300)
    ev.op("autograd::engine::evaluate_function: MmBackward0", 20, 100,
          thread=ENGINE)
    ev.op("aten::mm", 30, 40, thread=ENGINE)
    ev.kernel(31, 1000, 1100, thread=ENGINE)
    ev.op("autograd::engine::evaluate_function: _FusedLinearXentBackward",
          110, 200, thread=ENGINE)
    ev.span("ddstore:head_bwd", 115, 195, thread=ENGINE)
    ev.op("aten::mm", 120, 130, thread=ENGINE)
    ev.kernel(121, 1100, 1300, thread=ENGINE)
    # a thread outside the engine borrows nothing
    ev.op("aten::copy_", 50, 60, thread=WORKER)
    ev.kernel(51, 1300, 1350, thread=WORKER)
    got = spans.reduce_spans(ev.events, 1)
    assert got["device_ms"] == {"ddstore:backward": pytest.approx(0.3),
                                "ddstore:head_bwd": pytest.approx(0.2)}
    assert got["self_ms"]["ddstore:backward"] == pytest.approx(0.1)
    assert got["unattributed_ms"] == pytest.approx(0.05)


def test_a_launch_outside_every_span_is_unattributed():
    ev = Events()
    ev.span("ddstore:optimizer", 0, 100)
    ev.op("aten::_foreach_add_", 10, 20)
    ev.kernel(11, 500, 600)
    ev.op("aten::copy_", 150, 160)
    ev.kernel(151, 600, 650)
    # a copy from a thread the profiler does not follow: no op, no call
    ev.kernel(None, 650, 700, name="Memcpy HtoD (Pinned -> Device)")
    got = spans.reduce_spans(ev.events, 1)
    assert got["device_ms"] == {"ddstore:optimizer": pytest.approx(0.1)}
    assert got["unattributed_ms"] == pytest.approx(0.1)


def test_an_idle_gap_is_named_by_the_span_open_at_its_middle():
    ev = Events()
    ev.span("ddstore:zero_grad", 0, 100)
    ev.span("ddstore:forward", 100, 400)
    ev.span("ddstore:head_fwd", 300, 390)
    ev.op("aten::mm", 10, 20)
    ev.kernel(11, 20, 50)
    ev.kernel(12, 90, 110)     # gap 50-90, middle 70: zero_grad
    ev.kernel(13, 200, 250)    # gap 110-200, middle 155: forward
    ev.kernel(14, 350, 360)    # gap 250-350, middle 300: head_fwd
    ev.kernel(15, 500, 520)    # gap 360-500, middle 430: none
    got = spans.reduce_spans(ev.events, 1)
    assert got["idle_ms"] == {
        "ddstore:zero_grad": pytest.approx(0.04),
        "ddstore:forward": pytest.approx(0.09),
        "ddstore:head_fwd": pytest.approx(0.1),
        spans.NONE: pytest.approx(0.14)}


def _step_events(with_spans: bool) -> list:
    """One step as the benchmark traces it, with or without the program's
    ranges: a gap under ``Optimizer.zero_grad`` and one under no op."""
    ev = Events()
    ev.span("bench:step", 0, 1000)
    if with_spans:
        ev.span("ddstore:zero_grad", 10, 100)
        ev.span("ddstore:forward", 100, 600)
        ev.span("ddstore:optimizer", 600, 990)
    ev.op("Optimizer.zero_grad#Adam.zero_grad", 20, 90)
    ev.op("aten::mm", 110, 200)
    ev.kernel(30, 40, 60, name="memset")
    ev.kernel(120, 70, 300, name="sm80_xmma_gemm_f32f32")
    ev.kernel(130, 320, 400, name="nvjet_tst")
    ev.op("aten::_foreach_mul_", 610, 700)
    ev.kernel(620, 790, 950, name="multi_tensor_apply_kernel")
    return ev.events


def test_reduce_events_reads_the_same_with_the_programs_spans():
    plain = trace.reduce_events(_step_events(False), 1)
    spanned = trace.reduce_events(_step_events(True), 1)
    assert list(plain) == list(spanned)
    for key in ("busy_s", "window_s", "steps", "by_name"):
        assert plain[key] == spanned[key], key
    # the gaps (longest first): the same lengths; under an op the same
    # name; under no op, the benchmark's span names the program's beneath
    assert ([s for _, s in plain["idle_gaps"]]
            == [s for _, s in spanned["idle_gaps"]])
    fwd = "bench:step / ddstore:forward"
    zero = "bench:step / Optimizer.zero_grad#Adam.zero_grad"
    assert [n for n, _ in plain["idle_gaps"]] == [
        "bench:step", "bench:step", zero]
    assert [n for n, _ in spanned["idle_gaps"]] == [fwd, fwd, zero]


def test_the_spans_add_up_to_the_busy_time():
    events = _step_events(True)
    busy = trace.reduce_events(events, 1)["busy_s"] * 1e3
    got = spans.reduce_spans(events, 1)
    top = ("ddstore:zero_grad", "ddstore:forward", "ddstore:optimizer")
    assert (sum(got["device_ms"][n] for n in top)
            + got["unattributed_ms"]) == pytest.approx(busy)


def test_a_tiny_cells_traced_run_records_the_steps_spans(
        tiny_root, capsys, monkeypatch):
    """On the CPU the profile holds the step's ranges but no device work:
    every span reads 0."""
    from benchmark.tests.test_bench_run import run_cell

    seen = []
    close = trace.Tracer.close

    def keep(self):
        out = close(self)
        seen.append((self.steps, self.prof.events()))
        return out

    monkeypatch.setattr(trace.Tracer, "close", keep)
    res, _ = run_cell(tiny_root, capsys, "tiny.train", trace=1)
    assert res["correct"] is True
    steps, events = seen[-1]
    names = collections.Counter(e.name for e in events
                                if e.name.startswith(spans.PREFIX))
    # the tiny vocabulary takes the unfused head: no head_fwd / head_bwd
    for n in ("ddstore:zero_grad", "ddstore:forward", "ddstore:backward",
              "ddstore:optimizer"):
        assert names[n] == steps, (n, names)
    got = spans.reduce_spans(events, steps)
    zeros = {n: 0.0 for n in names}
    assert got == {"device_ms": zeros, "self_ms": zeros, "idle_ms": {},
                   "unattributed_ms": 0.0}
