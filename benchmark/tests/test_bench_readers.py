"""Every metric reader, and the trace arithmetic under them, on a synthetic
profiler trace whose answers are counted by hand."""

import json
import os

import numpy as np
import pytest

from benchmark import harness, tracing
from conftest import ROOT

# Two calls in a window of 0 .. 100 us. Call 1 (0 .. 40) stacks a bucket
# (host 5 .. 15), copies it in (device 16 .. 18) and fills it (20 .. 35);
# call 2 (40 .. 100) buckets (41 .. 43), stacks (44 .. 50) and runs two
# kernels (52 .. 60 and 58 .. 70, overlapping) and a copy out (90 .. 95).
EVENTS = [
    {"name": "bench.window", "cat": "user_annotation", "ts": 0.0, "dur": 100.0},
    {"name": "bench.call", "cat": "user_annotation", "ts": 0.0, "dur": 40.0},
    {"name": "batch.stack_bucket", "cat": "user_annotation", "ts": 5.0,
     "dur": 10.0},
    {"name": "cudaHostAlloc", "cat": "cuda_runtime", "ts": 6.0, "dur": 8.0},
    {"name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy",
     "ts": 16.0, "dur": 2.0},
    {"name": "strip_kernel", "cat": "kernel", "ts": 20.0, "dur": 15.0},
    {"name": "bench.call", "cat": "user_annotation", "ts": 40.0, "dur": 60.0},
    {"name": "batch.bucket_pairs", "cat": "user_annotation", "ts": 41.0,
     "dur": 2.0},
    {"name": "batch.stack_bucket", "cat": "user_annotation", "ts": 44.0,
     "dur": 6.0},
    {"name": "strip_kernel", "cat": "kernel", "ts": 52.0, "dur": 8.0},
    {"name": "pad_kernel", "cat": "kernel", "ts": 58.0, "dur": 12.0},
    {"name": "batch.gather", "cat": "user_annotation", "ts": 71.0,
     "dur": 28.0},
    {"name": "Memcpy DtoH (Device -> Pinned)", "cat": "gpu_memcpy",
     "ts": 90.0, "dur": 5.0},
    # Outside the window: the reference's kernels, never counted.
    {"name": "cummax", "cat": "kernel", "ts": 150.0, "dur": 50.0},
]


def _run(events=EVENTS, laps=({}, {})):
    calls = [harness.Call(0, 0.040, np.zeros((2, 3)), dict(laps[0])),
             harness.Call(1, 0.060, None, dict(laps[1])),
             harness.Call(0, 0.030, np.zeros((2, 3)), {})]
    run = harness.Run("nw_lg", 12.5, 0.130, calls, 2, [1000, 3000],
                      [1e-6, 3e-6])
    if events is not None:
        run.events = list(events)
        run.span = tracing.window(run.events)
    return run


def _read(name, run):
    return harness._module(ROOT, "metrics", name).read(run)


def test_window_union_gaps():
    assert tracing.window(EVENTS) == (0.0, 100.0)
    busy = tracing.busy(EVENTS, (0.0, 100.0))
    assert busy == [(16.0, 18.0), (20.0, 35.0), (52.0, 70.0), (90.0, 95.0)]
    assert tracing.gaps(busy, (0.0, 100.0)) == [
        (0.0, 16.0), (18.0, 20.0), (35.0, 52.0), (70.0, 90.0), (95.0, 100.0)]
    assert tracing.union([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]


def test_host_at_names_the_innermost_span_and_the_op():
    assert tracing.host_at(EVENTS, 10.0) == (
        "batch.stack_bucket/cudaHostAlloc")
    assert tracing.host_at(EVENTS, 80.0) == "batch.gather"
    assert tracing.host_at(EVENTS, 36.0) == "bench.call"
    assert tracing.host_at([EVENTS[0]], 36.0) == "between calls"


def test_host_spans_time_record_function_and_put_it_back():
    from torch.profiler import record_function

    enter, leave = record_function.__enter__, record_function.__exit__
    with tracing.HostSpans() as hs:
        with record_function("outer"):
            with record_function("inner"):
                pass
    with record_function("after"):
        pass
    assert [s[0] for s in hs.spans] == ["inner", "outer"]
    (_, a_in, b_in), (_, a_out, b_out) = hs.spans
    assert a_out <= a_in <= b_in <= b_out
    assert (record_function.__enter__, record_function.__exit__) == (
        enter, leave)


class _Prof:
    """A finished profiler: ``export_chrome_trace`` writes ``events``."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


TRACE = [
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
     "ts": 5000.0, "dur": 4.0},
    {"ph": "X", "cat": "kernel", "name": "k", "ts": 5010.0, "dur": 3.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5011.0,
     "dur": 1.0},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5011.0},
]


def test_collect_puts_host_spans_on_the_trace_s_clock():
    # The marker's host readings at 1000 and 1010 us, its sync in the
    # trace at 5000 .. 5004: trace = host + 3997 us.
    spans = [(tracing.WINDOW_SPAN, 1_006_000, 1_020_000),
             ("batch.stack_bucket", 1_007_000, 1_008_500)]
    ev = tracing.collect(_Prof(TRACE), spans, (1_000_000, 1_010_000))
    assert [e["name"] for e in ev] == [
        "cudaDeviceSynchronize", "k", tracing.WINDOW_SPAN,
        "batch.stack_bucket"]
    assert tracing.window(ev) == pytest.approx((5003.0, 5017.0))
    assert (ev[3]["ts"], ev[3]["dur"]) == pytest.approx((5004.0, 1.5))
    # A trace without the marker cannot be aligned: no reading.
    with pytest.raises(ValueError, match="cudaDeviceSynchronize"):
        tracing.collect(_Prof(TRACE[1:]), spans, (1_000_000, 1_010_000))
    # Without a profiler (no card) the spans keep the host's clock.
    ev = tracing.collect(None, spans, (0, 0))
    assert tracing.window(ev) == pytest.approx((1006.0, 1020.0))


def test_breakdown():
    b = tracing.breakdown(EVENTS, (0.0, 100.0), top=3)
    assert [o[0] for o in b["device_ops"]] == [
        "strip_kernel", "pad_kernel", "Memcpy DtoH (Device -> Pinned)"]
    assert [o[1] for o in b["device_ops"]] == pytest.approx(
        [23e-6, 12e-6, 5e-6])
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx(
        [20e-6, 17e-6, 16e-6])
    assert [g[0] for g in b["idle_gaps"]] == [
        "batch.gather", "bench.call", "batch.stack_bucket/cudaHostAlloc"]


def test_device_readers():
    run = _run()
    # 3 kernels start in the window (not the one after it), 2 traced calls.
    assert _read("launches_per_call", run) == pytest.approx(1.5)
    # Busy 2 + 15 + 18 + 5 = 40 us of 100.
    assert _read("device_idle_pct", run) == pytest.approx(60.0)
    # Bound of the traced calls (items 0 and 1): 4 us over 35 us of kernels.
    assert _read("fill_roofline", run) == pytest.approx(100 * 4 / 35)


def test_host_readers():
    run = _run(laps=({"align.cpy_host": 2.0}, {"align.cpy_host": 4.0}))
    # 10 + 2 + 6 us of bucket and stack spans over 2 traced calls.
    assert _read("host_prep_ms", run) == pytest.approx(9e-3)
    assert _read("cpy_host_ms", run) == pytest.approx(3.0)
    assert _read("setup_s", run) == 12.5
    # Cells of the calls that answered (items 0 and 0) over 0.130 s.
    assert _read("gcups", run) == pytest.approx(2000 / 0.130 / 1e9)
    assert _read("call_p95_ms", run) == pytest.approx(
        np.percentile([40, 60, 30], 95))


def test_readers_find_nothing_to_read():
    """Without a trace, or a trace with no kernels, the device readers
    return None, never 0."""
    bare = _run(events=None)
    host_only = _run(events=[e for e in EVENTS if e["cat"] not in
                             ("kernel", "gpu_memcpy")])
    for name in ("launches_per_call", "device_idle_pct", "fill_roofline",
                 "host_prep_ms"):
        assert _read(name, bare) is None
    for name in ("launches_per_call", "device_idle_pct", "fill_roofline"):
        assert _read(name, host_only) is None
    assert _read("cpy_host_ms", bare) is None


def test_every_metric_has_its_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py")
        assert os.path.exists(path), m["name"]
    assert json.dumps(bench)  # the file is JSON
