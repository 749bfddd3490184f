"""Named-lap stopwatch (ref: src/stopwatch.{hpp,cpp}).

Laps are in milliseconds. ``lap(name)`` accumulates the time since the last
mark under ``name`` (re-hitting the same name adds to it). ``combine``
averages each lap over only the stopwatches where that lap appears
(ref: src/stopwatch.cpp:38-50). Insertion order of laps is preserved
(Python dicts are insertion-ordered, mirroring the reference's Dict).

On the card the caller is responsible for bounding laps with
``torch.cuda.synchronize()`` so device work lands in the right phase —
the analog of the reference's cudaDeviceSynchronize between phases
(ref: src/nwalign_gpu3_ml_diagdiag.cu:425,576).

``phase(name)`` is a lap that is also a ``torch.profiler`` span of the
same name while a profiler records (``spans.span``), so that a trace and
the laps split a flow the same way.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Iterator, Optional

from .spans import span


class Stopwatch:
    def __init__(self) -> None:
        self._start: Optional[float] = None
        self._laps: Dict[str, float] = {}

    def start(self) -> None:
        self._start = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        if self._start is None:
            self._start = now
        elapsed_ms = (now - self._start) * 1000.0
        self._laps[name] = self._laps.get(name, 0.0) + elapsed_ms
        self._start = now

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """A ``span(name)`` over the block, which laps ``name`` when it
        leaves."""
        with span(name):
            yield
            self.lap(name)

    def add_ms(self, name: str, ms: float) -> None:
        """Directly account time measured externally (e.g. device timers)."""
        self._laps[name] = self._laps.get(name, 0.0) + ms

    def get_or_default(self, name: str, default: float = 0.0) -> float:
        return self._laps.get(name, default)

    def laps(self) -> Dict[str, float]:
        return dict(self._laps)

    @staticmethod
    def combine(sws: Iterable["Stopwatch"]) -> "Stopwatch":
        """Average each lap over the stopwatches where it appears."""
        sws = list(sws)
        res = Stopwatch()
        counts: Dict[str, int] = {}
        sums: Dict[str, float] = {}
        for sw in sws:
            for name, ms in sw._laps.items():
                sums[name] = sums.get(name, 0.0) + ms
                counts[name] = counts.get(name, 0) + 1
        for name in sums:
            res._laps[name] = sums[name] / counts[name]
        return res
