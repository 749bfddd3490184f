"""The readers of the database search's host flow (``search_idle_ms``,
``search_issue_ms``) on a synthetic trace whose answers are counted by
hand, and the device readers on the same trace."""

import numpy as np
import pytest

from benchmark import harness, tracing
from conftest import ROOT


def _span(name, a, b):
    return {"name": name, "cat": "user_annotation", "ts": float(a),
            "dur": float(b - a)}


def _dev(cat, a, b, name="k"):
    return {"name": name, "cat": cat, "ts": float(a), "dur": float(b - a)}


def _search_call(t):
    """One search from ``t``: the query 1 .. 3, a K6 bucket's launches
    3 .. 6, a K5 bucket's 6 .. 8, the copy back 8 .. 9, the wait and the
    answers out 9 .. 38, the harness alone 38 .. 40; the card copies in
    2 .. 3, fills 4 .. 20 and 20 .. 30, copies out 31 .. 32."""
    return [
        _span("bench.call", t, t + 40), _span("db.search", t + 1, t + 38),
        _span("db.query", t + 1, t + 3), _span("db.tiny", t + 3, t + 6),
        _span("db.fill", t + 6, t + 8), _span("db.copy_back", t + 8, t + 9),
        _span("db.gather", t + 9, t + 38),
        _dev("gpu_memcpy", t + 2, t + 3), _dev("kernel", t + 4, t + 20),
        _dev("kernel", t + 20, t + 30), _dev("gpu_memcpy", t + 31, t + 32),
    ]


# Two searches in a window of 0 .. 80 us; a load before it is not read.
SEARCH = ([_span("bench.window", 0, 80), _span("db.load", -30, -10)]
          + _search_call(0) + _search_call(40))


def _run(events, calls=2):
    run = harness.Run("sw_ag", 1.0, 1.0,
                      [harness.Call(0, 0.04, np.zeros((1, 3)), {})] * calls,
                      calls, [1000], [1e-6])
    if events is not None:
        run.events = list(events)
        run.span = tracing.window(run.events)
    return run


def _read(name, run):
    return harness._module(ROOT, "metrics", name).read(run)


def test_search_readers():
    run = _run(SEARCH)
    # Idle a call: 0 .. 2, 3 .. 4, 30 .. 31, 32 .. 40 (12 us); inside
    # db.search (1 .. 38): 1 .. 2, 3 .. 4, 30 .. 31, 32 .. 38 (9 us).
    assert _read("search_idle_ms", run) == pytest.approx(9e-3)
    # db.query + db.tiny + db.fill + db.copy_back: 2 + 3 + 2 + 1 us.
    assert _read("search_issue_ms", run) == pytest.approx(8e-3)
    assert _read("device_idle_pct", run) == pytest.approx(100 * 24 / 80)
    # Idle outside every program span: 0 .. 1 and 38 .. 40 a call.
    assert _read("idle_unnamed_pct", run) == pytest.approx(100 * 6 / 80)
    assert _read("launches_per_call", run) == 2


def test_search_readers_find_nothing_to_read():
    """No trace, a trace with no device work (a CPU run), or one without
    the search's spans (another cell, or a program without the search):
    None, never 0."""
    spans_only = [e for e in SEARCH if e["cat"] == "user_annotation"]
    batch = [e for e in SEARCH if e["cat"] != "user_annotation"
             or not e["name"].startswith("db.")]
    for events in (None, spans_only, batch):
        assert _read("search_idle_ms", _run(events)) is None
    for events in (None, batch):
        assert _read("search_issue_ms", _run(events)) is None
    # The host spans alone, with no device work: the issue cost is a host
    # reading, but a CPU run opens no such span (``utils.spans.span`` is
    # open only while a profiler records).
    assert _read("search_issue_ms", _run(spans_only)) == pytest.approx(
        8e-3)
    assert _read("search_issue_ms", _run(SEARCH, calls=0)) is None
