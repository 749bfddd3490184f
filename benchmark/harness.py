"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` reads the cell from ``BENCHMARK.json`` and every file it
names, and ``prepare`` makes the pool of requests from the seed and warms
up every request of the pool (set-up, with any build of the kernels).
Then requests go back to back, in pool order and round again, until
``seconds`` have passed (closed loop, one caller). With ``trace`` the
first ``TRACE_SECONDS`` of the window are traced (``tracing``: the card's
activity and the program's spans, no torch operator). After the window
it reads the device's memory peak, frees the program's state, runs the
plain reference once over every request of the pool, in chunks of
bounded size, and compares every answer of every call with it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import generate, roofline, tracing
from .reference import dp

BENCH_DIR = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# With --trace 1, the profiler records the first seconds of the window
# only: a longer trace costs more to read than a run may take.
TRACE_SECONDS = 3.0
# The reference's chunks hold at most this many padded elements a row of
# the DP (pairs x (widest + 1)): its tensors of that size, several tens of
# bytes an element together, then fit on the card at any pool size.
REFERENCE_ELEMENTS = 2 ** 25


@dataclasses.dataclass
class Call:
    item: int  # which request of the pool
    seconds: float  # wall time, host clock
    answers: Optional[np.ndarray]  # (n, 3) [cost, best_i, best_j]; None: failed
    laps: Dict[str, float]  # the program's stopwatch laps, ms


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""

    algorithm: str
    setup_s: float
    window_s: float  # host clock, first request sent to last answer
    calls: List[Call]
    traced: int  # the first ``traced`` calls ran in the traced window
    cells: List[int]  # live DP cells of each request of the pool
    bound_s: List[float]  # the roofline bound of each request
    events: Optional[List[tracing.Event]] = None  # the trace (--trace 1)
    span: Optional[tracing.Interval] = None  # the traced window, us

    @property
    def traced_calls(self) -> List[Call]:
        return self.calls[:self.traced]


def _json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(root: str, kind: str, name: str):
    path = os.path.join(root, BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{BENCH_DIR}_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and
    metrics, every file found by name under ``root``."""

    def __init__(self, name: str, root: str = DEFAULT_ROOT) -> None:
        self.root = root
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = _json(os.path.join(
            root, BENCH_DIR, "traffic", f"{self.workload['traffic']}.json"))
        self.bench = bench

    def metrics(self, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]

    def entry(self, pool, subst, device: str):
        mod = _module(self.root, "entries", self.traffic["entry"]["name"])
        return mod.Entry(self.config, self.traffic, pool, subst, device)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def prepare(cell: Cell, seed: int, device: str):
    """A run's set-up: the matrix, the pool of requests from the seed and
    the entry, each request of the pool called once (the warm-up, with
    any build of the kernels)."""
    subst = dp.matrix(cell.config)
    pool = generate.make_pool(cell.traffic, cell.config, seed)
    entry = cell.entry(pool, subst, device)
    for k in range(len(pool)):
        entry.call(k)
    _sync(device)
    return subst, pool, entry


def measure(entry, n_items: int, seconds: float, trace: bool = False,
            cuda: bool = False):
    """Requests back to back until ``seconds`` have passed; with ``trace``
    the first ``TRACE_SECONDS`` of them traced (the card's activity when
    ``cuda``, and the spans on the host's clock). Returns the calls, the
    window's seconds, how many calls were traced and what the trace left
    (the profiler, the host spans, the marker; None untraced)."""
    from torch.profiler import record_function

    calls: List[Call] = []
    n_traced, traced, span = 0, None, None
    if trace:
        prof = None
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        spans = tracing.HostSpans().__enter__()
        traced = (prof, spans, tracing.mark(cuda))
        span = record_function(tracing.WINDOW_SPAN)
        span.__enter__()
    t0 = t = time.perf_counter()
    while t - t0 < seconds:
        k = len(calls) % n_items
        if span is not None:
            with record_function(tracing.CALL_SPAN):
                answers, laps = entry.call(k)
        else:
            answers, laps = entry.call(k)
        t1 = time.perf_counter()
        calls.append(Call(k, t1 - t, answers, laps))
        t = t1
        if span is not None and (t - t0 >= TRACE_SECONDS
                                 or t - t0 >= seconds):
            span.__exit__(None, None, None)
            spans.__exit__()
            if prof is not None:
                prof.stop()
            span, n_traced = None, len(calls)
            t = time.perf_counter()  # the next call's time leaves it out
    return calls, t - t0, n_traced, traced


def _ms(calls: List[Call], q: float) -> str:
    return f"{np.percentile([c.seconds for c in calls], q) * 1e3:.3f}"


def _card(cuda: bool) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    if not cuda:
        return "none"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name()} (nvidia-smi: {e})"
    return out.stdout.strip() or torch.cuda.get_device_name()


def wrong_answers(calls: List[Call], reference: List[np.ndarray],
                  algorithm: str) -> int:
    """Pairs whose answer differs from the reference's, over every call;
    a call that failed counts every pair of its request. NW is judged by
    its cost, SW by its cost and best cell."""
    cols = 3 if algorithm.startswith("sw") else 1
    wrong = 0
    for c in calls:
        ref = reference[c.item]
        if c.answers is None or c.answers.shape != ref.shape:
            wrong += len(ref)
        else:
            wrong += int((c.answers[:, :cols] != ref[:, :cols]).any(1).sum())
    return wrong


def chunks(pairs, budget: int) -> List[np.ndarray]:
    """The pairs' indices cut into chunks for the reference: sorted by
    rows and then by width, each chunk as long as its n x (widest + 1)
    stays within ``budget`` (a wider pair alone); the widest is the
    longest sequence of the chunk, rows or columns, as ``dp.align`` pads
    every pair of a call to it."""
    rows = np.array([len(y) - 1 for y, _ in pairs], np.int64)
    cols = np.array([len(x) - 1 for _, x in pairs], np.int64)
    order = np.lexsort((cols, rows))
    width = np.maximum(rows, cols)[order].tolist()
    out, start, widest = [], 0, 0
    for k, w in enumerate(width):
        if k > start and (k - start + 1) * (max(widest, w) + 1) > budget:
            out.append(order[start:k])
            start, widest = k, 0
        widest = max(widest, w)
    out.append(order[start:])
    return out


def reference_answers(cell: Cell, pool, subst, device: str,
                      bits: int = 32) -> List[np.ndarray]:
    """The plain reference over every request of the pool: one
    ``dp.align`` call a chunk of at most ``REFERENCE_ELEMENTS``
    (``chunks``), the answers in input order."""
    cfg = cell.config
    flat = [p for pairs in pool for p in pairs]
    out = np.zeros((len(flat), 3), np.int64)
    for idx in chunks(flat, REFERENCE_ELEMENTS):
        out[idx] = dp.align([flat[b] for b in idx], subst,
                            algorithm=cfg["algorithm"], gapo=cfg["gapo"],
                            gape=cfg["gape"], device=device, bits=bits)
    sizes = np.cumsum([len(pairs) for pairs in pool])[:-1]
    return np.split(out, sizes)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             root: str = DEFAULT_ROOT) -> Dict:
    """One run of the cell ``name``; the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, root)
    cfg = cell.config
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    subst, pool, entry = prepare(cell, seed, device)
    setup_s = time.perf_counter() - t_start

    calls, window_s, n_traced, traced = measure(entry, len(pool), seconds,
                                                trace, cuda)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del entry
    if cuda:
        torch.cuda.empty_cache()

    run = Run(cfg["algorithm"], setup_s, window_s, calls, n_traced,
              [roofline.live_cells(p) for p in pool],
              [roofline.bound_s(cfg["algorithm"], p, len(subst))
               for p in pool])
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    result: Dict = {}
    t_after = time.perf_counter()
    if traced is not None:
        prof, spans, host_mark = traced
        run.events = tracing.collect(prof, spans.spans, host_mark)
        run.span = tracing.window(run.events)
        busy = tracing.busy(run.events, run.span)
        device_info["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        device_info["window_s"] = (run.span[1] - run.span[0]) * 1e-6
        result["breakdown"] = tracing.breakdown(run.events, run.span)

    t_ref = time.perf_counter()
    reference = reference_answers(cell, pool, subst, device)
    t_done = time.perf_counter()
    wrong = wrong_answers(calls, reference, cfg["algorithm"])
    failed = sum(c.answers is None for c in calls)

    metrics = {}
    for m in cell.metrics(trace):
        value = _module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"wrong": {"value": wrong, "limit": 0}}
    slowest = int(np.argmax([c.seconds for c in calls]))
    traced_p50 = (f", traced p50 {_ms(calls[:n_traced], 50)} untraced p50 "
                  f"{_ms(calls[n_traced:], 50)}"
                  if 0 < n_traced < len(calls) else "")
    print(f"{name}: seed {seed}, {len(calls)} calls in {window_s:.3f} s "
          f"({n_traced} traced{traced_p50}; ms p50 {_ms(calls, 50)} "
          f"p95 {_ms(calls, 95)} max {_ms(calls, 100)} at call {slowest}), "
          f"set-up {setup_s:.3f} s, {failed} failed, trace read in "
          f"{t_ref - t_after:.3f} s, reference in {t_done - t_ref:.3f} s, "
          f"card {_card(cuda)}", file=sys.stderr)
    for key, c in checks.items():
        print(f"check {key} {c['value']} limit {c['limit']}", file=sys.stderr)
    return {"correct": wrong <= checks["wrong"]["limit"] and not failed,
            "attempted": len(calls), "failed": failed, "metrics": metrics,
            "device": device_info, **result, "checks": checks}
