"""The card's idle time in the traced window, held against the program's
spans: how much of it each host step covers, and how much none does.

A program span is a ``user_annotation`` event whose name does not start
with ``bench.`` (the harness's own spans). Times are in microseconds on
the trace's clock, as in ``tracing``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from benchmark import tracing

HARNESS_PREFIX = "bench."


def idle(run) -> Optional[List[tracing.Interval]]:
    """The idle intervals of the traced window, or None without a trace or
    with no kernel, copy or memset in it (nothing to hold spans against)."""
    if run.events is None:
        return None
    busy = tracing.busy(run.events, run.span)
    if not busy:
        return None
    return tracing.gaps(busy, run.span)


def spans(run, keep: Callable[[str], bool]) -> List[tracing.Interval]:
    """The merged intervals of the spans whose names ``keep`` takes,
    clipped to the traced window."""
    lo, hi = run.span
    return tracing.union(
        (max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
        for e in run.events if e["cat"] == tracing.SPAN_CAT
        and keep(e["name"]) and e["ts"] < hi and e["ts"] + e["dur"] > lo)


def is_program(name: str) -> bool:
    return not name.startswith(HARNESS_PREFIX)


def overlap(a: Iterable[tracing.Interval],
            b: Iterable[tracing.Interval]) -> float:
    """The length of the intersection of two lists of disjoint intervals,
    each in order."""
    a, b = list(a), list(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ms(run, name: str) -> Optional[float]:
    """The card's idle time inside the spans ``name`` a traced call, in
    milliseconds; None where nothing is traced or no such span ran."""
    gaps = idle(run)
    if gaps is None or not run.traced:
        return None
    inside = spans(run, name.__eq__)
    if not inside:
        return None
    return overlap(gaps, inside) * 1e-3 / run.traced
