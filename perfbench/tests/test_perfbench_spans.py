"""``spans.reduce`` on synthetic events (attribution across threads, the
queue's waits, idle gaps by span), the span readers on a synthetic
reading, the existing readers unchanged by the span fields, and
``span_run`` at the tiny size on the CPU."""
import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import harness, span_run, spans, trace

MAIN, AUTOGRAD = 1, 2


def _events() -> spans.Events:
    """Two steps in a window of 0-1000 us. Step 1: blocks inside forward,
    a backward whose kernel the autograd thread launches and whose host
    time holds a 50 us queue wait, an optimizer; step 2 bare. A copy is
    launched between the steps, and a kernel runs past the window."""
    sp = [("mfv.step", MAIN, 10, 400), ("mfv.forward", MAIN, 10, 100),
          ("mfv.blocks", MAIN, 20, 90), ("mfv.backward", MAIN, 110, 300),
          ("mfv.optim", MAIN, 310, 390), ("mfv.step", MAIN, 500, 900)]
    launches = {1: (MAIN, 30), 2: (AUTOGRAD, 150), 3: (MAIN, 320),
                4: (MAIN, 450), 5: (MAIN, 880)}
    device = [(1, 100, 150, True), (2, 200, 260, True),
              (3, 330, 380, True), (4, 450, 460, False),
              (5, 990, 1100, True)]
    return spans.Events((0, 1000), MAIN, sp, [(120, 170)], launches,
                        device)


def test_backward_kernel_from_another_thread_goes_to_backward():
    got = spans.reduce(_events())
    assert got["span_s"]["mfv.backward"] == pytest.approx(60e-6)
    assert got["span_s"]["mfv.blocks"] == pytest.approx(50e-6)
    assert got["span_s"]["mfv.forward"] == 0.0
    assert got["span_s"]["none"] == pytest.approx(10e-6)   # the copy
    assert got["span_s"]["mfv.optim"] == pytest.approx(50e-6)
    # with what ran inside: blocks in forward, all of step 1 in mfv.step,
    # and step 2's kernel clipped to the window
    assert got["span_total_s"]["mfv.forward"] == pytest.approx(50e-6)
    assert got["span_total_s"]["mfv.step"] == pytest.approx(170e-6)


def test_queue_wait_is_left_out_of_host_time():
    got = spans.reduce(_events())
    assert got["span_host_s"]["mfv.step"] == pytest.approx(
        [340e-6, 400e-6])
    assert got["span_host_s"]["mfv.backward"] == pytest.approx([140e-6])
    assert got["span_host_s"]["mfv.forward"] == pytest.approx([90e-6])
    assert got["span_calls"] == {"mfv.step": 2, "mfv.forward": 1,
                                 "mfv.blocks": 1, "mfv.backward": 1,
                                 "mfv.optim": 1}


def test_idle_gaps_are_named_by_the_span_at_their_middle():
    got = spans.reduce(_events())
    idle = {(name, round(s * 1e6)) for name, s in got["idle_spans"]}
    assert idle == {("mfv.step", 530), ("mfv.blocks", 100),
                    ("none", 70), ("mfv.backward", 70),
                    ("mfv.backward", 50)}
    assert got["idle_spans"][0] == ["mfv.step", pytest.approx(530e-6)]


def test_kernels_count_only_kernels_in_the_window():
    got = spans.reduce(_events())
    assert got["kernels"] == 4          # the copy is not a kernel
    ev = _events()
    ev.device.append((6, 1200, 1300, True))      # after the window
    assert spans.reduce(ev)["kernels"] == 4


def test_a_launch_outside_every_span_is_left_unattributed():
    ev = _events()
    ev.launches[1] = (MAIN, 5)          # before step 1 opened
    got = spans.reduce(ev)
    assert got["span_total_s"]["mfv.step"] == pytest.approx(120e-6)
    # with the copy launched between the steps
    assert got["span_s"]["none"] == pytest.approx(60e-6)


def _reading(cls=trace.Reading, **extra):
    cfg = json.loads((harness.HERE / "configs" / "mfvit_ca_s16.json")
                     .read_text())
    tr = json.loads((harness.HERE / "traffic" / "fuse_ft224_b256.json")
                    .read_text())
    op_s = {"_AttentionBlock": 0.02, "_MlpBlock": 0.01,
            "_AttentionBlockBackward": 0.03, "_MlpBlockBackward": 0.01,
            "_FusionCls": 0.001, "aten::mm": 0.029}
    return cls(1.0, 0.099, 0.1, op_s, {k: 24 for k in op_s}, 3, 768,
               700.0, cfg, tr, [], [], **extra)


SPANNED = dict(
    span_total_s={"mfv.forward": 0.04, "mfv.loss": 0.002,
                  "mfv.backward": 0.05, "mfv.optim": 0.006},
    span_host_s={"mfv.step": [0.011, 0.013, 0.012],
                 "mfv.serve": [0.002, 0.004, 0.003]},
    kernels=300)


@pytest.mark.parametrize("name, want", [
    ("fwd_eager.device_pct.train", 100 * (0.042 - 0.031) / 0.1),
    ("bwd_eager.device_pct.train", 100 * (0.05 - 0.04) / 0.1),
    ("optim.device_pct.train", 6.0),
    ("host.enqueue_ms.train", 12.0), ("host.enqueue_ms.serve", 3.0),
    ("kernels.step.train", 100.0), ("kernels.step.serve", 100.0)])
def test_span_readers(name, want):
    reader = harness.Files().metric(name)
    value, by = reader.read(_reading(spans.SpanReading, **SPANNED))
    assert value == pytest.approx(want) and by is None
    # a trace without the port's spans: nothing to read, nothing raised
    assert reader.read(_reading()) is None
    assert reader.read(_reading(spans.SpanReading)) is None


def test_existing_readers_read_the_same_with_the_span_fields():
    files = harness.Files()
    plain, spanned = _reading(), _reading(spans.SpanReading, **SPANNED)
    names = [m["name"] for m in files.spec()["per_layer"]]
    assert len(names) == 10
    for name in names:
        reader = files.metric(name)
        assert reader.read(spanned) == reader.read(plain), name


def test_events_of_a_cpu_profiler_run():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.SPAN):
            with record_function("mfv.step"):
                with record_function("mfv.forward"):
                    torch.ones(8).sum()
            with record_function("other"):
                pass
    ev = spans.events_of(prof)
    assert [s[0] for s in sorted(ev.spans, key=lambda s: s[2])] == [
        "mfv.step", "mfv.forward"]
    assert {s[1] for s in ev.spans} == {ev.thread}
    assert ev.window[0] <= ev.spans[0][2] and ev.spans[0][3] <= ev.window[1]
    assert ev.device == [] and ev.waits == []


class _Event:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, cuda, corr, linked, start_us, dur_us,
                 thread=MAIN):
        from torch.autograd import DeviceType
        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU, corr,
                   linked, start_us * 1000, dur_us * 1000, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def linked_correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]

    def duration_ns(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_events_of_links_launches_to_their_calls():
    """A kernel is placed at its runtime call (same correlation), a copy
    without one at its operator's start (its linked correlation); a queue
    wait and a span are told apart by name, and a device event with no
    link (a span's device-side range) is left out."""
    raw = [_Event(trace.SPAN, False, 1, 0, 0, 1000),
           _Event("mfv.backward", False, 2, 0, 100, 300),
           _Event("aten::mm", False, 3, 0, 150, 20, AUTOGRAD),
           _Event("cudaLaunchKernel", False, 70, 3, 160, 5, AUTOGRAD),
           _Event("Command Buffer Full", False, 71, 3, 161, 3, AUTOGRAD),
           _Event("sm90_gemm", True, 70, 3, 200, 50),
           _Event("aten::copy_", False, 4, 0, 500, 10),
           _Event("Memcpy DtoH (Device -> Pinned)", True, 72, 4, 520, 5),
           _Event("mfv.backward", True, 73, 0, 100, 300)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    ev = spans.events_of(prof)
    assert ev.window == (0, 1000) and ev.thread == MAIN
    assert ev.spans == [("mfv.backward", MAIN, 100, 400)]
    assert ev.waits == [(161, 164)]
    assert ev.launches == {70: (AUTOGRAD, 160), 72: (MAIN, 500)}
    assert ev.device == [(70, 200, 250, True), (72, 520, 525, False)]


@pytest.mark.parametrize("cell, step_span", [("t.serve", "mfv.serve"),
                                             ("t.train", "mfv.step")])
def test_span_run_on_the_tiny_cells(tiny, cell, step_span):
    """The harness's result line, unchanged in its keys, with the spans'
    reduction beside it: one step span a step, no kernel on the CPU."""
    r = span_run.run(cell, 2 ** 31 + 7, 0.3, torch.device("cpu"), tiny)
    assert r["correct"] is True and r["failed"] == 0
    notes = r["spans"]["notes"]
    assert notes["span_calls"][step_span] == notes["steps"] == 2
    assert notes["kernels"] == 0
    assert notes["port_launches_per_step"] == {"total": 0.0}
    assert set(r["spans"]["metrics"]) == {
        f"host.enqueue_ms.{cell.split('.')[1]}"}
