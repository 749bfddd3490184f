"""The traced window: the card's trace and the program's spans, and the
arithmetic on them.

The profiler records device activity alone (``ProfilerActivity.CUDA``):
kernels, copies, memsets and the CUDA runtime calls the host made. No
torch operator is recorded, so the calls run at nearly their untraced
speed. The spans (the harness's ``bench.window`` and ``bench.call``, the
program's ``batch.*``) are timed on the host's clock by ``HostSpans``,
which wraps ``record_function`` while the window is traced, and are moved
onto the trace's clock by one ``torch.cuda.synchronize`` that the harness
makes right after the profiler starts (``mark``): the trace's first
``cudaDeviceSynchronize`` lies inside the host's two readings around it.

An event is a dict with ``name``, ``cat``, ``ts`` and ``dur`` (both in
microseconds on the trace's clock), as in a Chrome trace. ``cat`` is one
of ``kernel``, ``gpu_memcpy``, ``gpu_memset`` (device work),
``cuda_runtime`` (a runtime call on the host) and ``user_annotation`` (a
span).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CAT = "cuda_runtime"
SPAN_CAT = "user_annotation"
WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
MARK_CALL = "cudaDeviceSynchronize"
Event = Dict
Interval = Tuple[float, float]
HostSpan = Tuple[str, int, int]  # name, start and end in perf_counter_ns


class HostSpans:
    """While entered, every ``record_function`` span that ends is kept as
    (name, start, end) on the host's clock (``time.perf_counter_ns``)."""

    def __init__(self) -> None:
        self.spans: List[HostSpan] = []

    def __enter__(self) -> "HostSpans":
        from torch.autograd.profiler import record_function

        cls, spans = record_function, self.spans
        self._saved = enter, leave = cls.__enter__, cls.__exit__

        def timed_enter(rf):
            rf._host_start_ns = time.perf_counter_ns()
            return enter(rf)

        def timed_exit(rf, *exc):
            out = leave(rf, *exc)
            start = getattr(rf, "_host_start_ns", None)
            if start is not None:
                spans.append((rf.name, start, time.perf_counter_ns()))
            return out

        cls.__enter__, cls.__exit__ = timed_enter, timed_exit
        return self

    def __exit__(self, *exc) -> None:
        from torch.autograd.profiler import record_function

        record_function.__enter__, record_function.__exit__ = self._saved


def mark(cuda: bool) -> Tuple[int, int]:
    """The host's clock around one ``torch.cuda.synchronize``: the event
    that ties the host's clock to the trace's."""
    import torch

    t0 = time.perf_counter_ns()
    if cuda:
        torch.cuda.synchronize()
    return t0, time.perf_counter_ns()


def _chrome_events(prof) -> List[Event]:
    """Device and runtime events of a finished ``torch.profiler.profile``,
    through its Chrome trace (a file under ``TMPDIR``, removed again)."""
    keep = set(DEVICE_CATS) | {RUNTIME_CAT}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    return [{"name": e["name"], "cat": e["cat"], "ts": float(e["ts"]),
             "dur": float(e.get("dur", 0.0))}
            for e in raw.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in keep]


def offset_us(events: List[Event], host_mark: Tuple[int, int]) -> float:
    """Trace time minus host time (us) from the harness's marker sync:
    the middle of the trace's first ``cudaDeviceSynchronize`` against the
    middle of the host's readings around it."""
    syncs = [e for e in events
             if e["cat"] == RUNTIME_CAT and e["name"] == MARK_CALL]
    if not syncs:
        raise ValueError(f"the trace holds no {MARK_CALL}: the host's "
                         "spans cannot be put on its clock")
    first = min(syncs, key=lambda e: e["ts"])
    return first["ts"] + first["dur"] / 2 - sum(host_mark) / 2e3


def collect(prof, spans: List[HostSpan], host_mark: Tuple[int, int]
            ) -> List[Event]:
    """The trace's device and runtime events, and the host spans as
    ``user_annotation`` events on the trace's clock; without ``prof`` (no
    card) the spans alone, on the host's clock."""
    events, shift = [], 0.0
    if prof is not None:
        events = _chrome_events(prof)
        shift = offset_us(events, host_mark)
    events += [{"name": name, "cat": SPAN_CAT, "ts": a / 1e3 + shift,
                "dur": (b - a) / 1e3} for name, a, b in spans]
    return events


def window(events: Iterable[Event]) -> Optional[Interval]:
    """(start, end) of the ``bench.window`` span, in microseconds."""
    for e in events:
        if e["name"] == WINDOW_SPAN and e["cat"] == SPAN_CAT:
            return e["ts"], e["ts"] + e["dur"]
    return None


def inside(events: Iterable[Event], cats: Tuple[str, ...],
           span: Interval) -> List[Event]:
    """Events of ``cats`` that start inside ``span``."""
    lo, hi = span
    return [e for e in events if e["cat"] in cats and lo <= e["ts"] < hi]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged where they overlap, in order."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy(events: Iterable[Event], span: Interval) -> List[Interval]:
    """Merged intervals in which device work ran, clipped to ``span``."""
    lo, hi = span
    return union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                 for e in events if e["cat"] in DEVICE_CATS
                 and e["ts"] < hi and e["ts"] + e["dur"] > lo)


def gaps(busy_intervals: List[Interval], span: Interval) -> List[Interval]:
    """The idle intervals of ``span`` between busy ones."""
    out, t = [], span[0]
    for a, b in busy_intervals:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if span[1] > t:
        out.append((t, span[1]))
    return out


def host_at(events: List[Event], t: float) -> str:
    """What the host was doing at ``t``: the innermost span that holds it
    (``bench.call`` or a ``batch.*`` step), with the CUDA runtime call
    running then, if any; "between calls" outside every call."""
    spans = [e for e in events if e["cat"] == SPAN_CAT
             and e["name"] != WINDOW_SPAN and e["ts"] <= t < e["ts"] + e["dur"]]
    if not spans:
        return "between calls"
    name = min(spans, key=lambda e: e["dur"])["name"]
    calls = [e for e in events if e["cat"] == RUNTIME_CAT
             and e["ts"] <= t < e["ts"] + e["dur"]]
    if calls:
        name += "/" + max(calls, key=lambda e: e["dur"])["name"]
    return name


def breakdown(events: List[Event], span: Interval, top: int = 10) -> Dict:
    """The device operations that took most time, by name, and the
    longest idle gaps, by what the host was doing in each; seconds."""
    per_op: Dict[str, float] = {}
    for e in inside(events, DEVICE_CATS, span):
        per_op[e["name"]] = per_op.get(e["name"], 0.0) + e["dur"] * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(busy(events, span), span),
                  key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[host_at(events, (a + b) / 2), (b - a) * 1e-6]
                          for a, b in idle]}
