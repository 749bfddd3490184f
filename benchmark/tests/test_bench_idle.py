"""The readers of the card's idle time against the program's spans
(``idle_unnamed_pct``, ``store_idle_ms``, ``stack_idle_ms``) on synthetic
traces whose answers are counted by hand."""

import numpy as np
import pytest

from benchmark import harness, idle, tracing
from conftest import ROOT


def _span(name, a, b):
    return {"name": name, "cat": "user_annotation", "ts": float(a),
            "dur": float(b - a)}


def _dev(cat, a, b, name="k"):
    return {"name": name, "cat": cat, "ts": float(a), "dur": float(b - a)}


def _single_call(t):
    """One single-pair call from ``t``: the six steps tile 0 .. 46, the
    harness alone 46 .. 50; the card copies in 5 .. 7, fills 9 .. 19 and
    copies out 21 .. 29."""
    return [
        _span("bench.call", t, t + 50),
        _span("align.setup", t, t + 2), _span("align.alloc", t + 2, t + 4),
        _span("align.cpy_dev", t + 4, t + 8),
        _span("align.calc", t + 8, t + 20),
        _span("align.cpy_host", t + 20, t + 30),
        _span("align.store", t + 30, t + 46),
        _span("align.store.headers", t + 30, t + 40),
        _span("align.store.last_tile", t + 40, t + 46),
        _dev("gpu_memcpy", t + 5, t + 7), _dev("kernel", t + 9, t + 19),
        _dev("gpu_memcpy", t + 21, t + 29),
    ]


# Two calls in a window of 0 .. 100 us.
SINGLE = [_span("bench.window", 0, 100)] + _single_call(0) + _single_call(50)

# One batch call in a window of 0 .. 60 us, two steps apart by 1 us, the
# harness alone after the gather.
BATCH = [
    _span("bench.window", 0, 60), _span("bench.call", 0, 60),
    _span("batch.bucket_pairs", 1, 5), _span("batch.subst", 5, 7),
    _span("batch.stack_bucket", 8, 20), _span("batch.pad_rows", 14, 20),
    _span("batch.bucket_scores", 20, 40), _span("batch.fill", 21, 25),
    _span("batch.copy_back", 36, 38), _span("batch.gather", 41, 58),
    _dev("gpu_memcpy", 10, 11), _dev("kernel", 16, 17),
    _dev("kernel", 24, 36), _dev("gpu_memcpy", 37, 39),
    # After the window: never counted.
    _dev("kernel", 70, 90),
]


def _run(events, calls):
    run = harness.Run("nw_lg", 1.0, 1.0,
                      [harness.Call(0, 0.05, np.zeros((1, 3)), {})] * calls,
                      calls, [1000], [1e-6])
    if events is not None:
        run.events = list(events)
        run.span = tracing.window(run.events)
    return run


def _read(name, run):
    return harness._module(ROOT, "metrics", name).read(run)


def test_overlap_and_program_spans():
    assert idle.overlap([(0, 5), (7, 9), (12, 20)], [(4, 8), (10, 13)]) == 3
    assert idle.overlap([], [(0, 1)]) == 0
    run = _run(BATCH, 1)
    # Clipped to the window, merged; the harness's spans left out.
    assert idle.spans(run, idle.is_program) == [(1, 7), (8, 40), (41, 58)]
    run.events = run.events + [_span("batch.gather", -5, 2)]
    assert idle.spans(run, idle.is_program)[0] == (0, 7)


def test_single_pair_readers():
    run = _run(SINGLE, 2)
    # Busy 2 + 10 + 8 a call: 60 us idle, of which 46 .. 50 and 96 .. 100
    # lie in no program span.
    assert _read("device_idle_pct", run) == pytest.approx(60.0)
    assert _read("idle_unnamed_pct", run) == pytest.approx(8.0)
    # Each store (30 .. 46, 80 .. 96) lies wholly in an idle gap.
    assert _read("store_idle_ms", run) == pytest.approx(16e-3)
    assert _read("stack_idle_ms", run) is None


def test_batch_readers():
    run = _run(BATCH, 1)
    # Idle 0 .. 10, 11 .. 16, 17 .. 24, 36 .. 37, 39 .. 60 (44 us); no
    # program span over 0 .. 1, 7 .. 8, 40 .. 41, 58 .. 60.
    assert _read("device_idle_pct", run) == pytest.approx(100 * 44 / 60)
    assert _read("idle_unnamed_pct", run) == pytest.approx(100 * 5 / 60)
    # Inside the stack (8 .. 20): 8 .. 10, 11 .. 16, 17 .. 20.
    assert _read("stack_idle_ms", run) == pytest.approx(10e-3)
    assert _read("store_idle_ms", run) is None


def test_idle_readers_find_nothing_to_read():
    """No trace, or a trace with no kernel, copy or memset (a CPU run):
    None, never 0. A trace without the program's spans (a program that has
    none) reads all its idle time as unnamed and no store or stack."""
    names = ("idle_unnamed_pct", "store_idle_ms", "stack_idle_ms")
    for events in (None, [e for e in SINGLE + BATCH[2:]
                          if e["cat"] == "user_annotation"]):
        for name in names:
            assert _read(name, _run(events, 2)) is None
    bare = _run([e for e in SINGLE if e["cat"] != "user_annotation"
                 or e["name"].startswith("bench.")], 2)
    assert _read("idle_unnamed_pct", bare) == pytest.approx(60.0)
    assert _read("store_idle_ms", bare) is None
    assert _read("stack_idle_ms", bare) is None
