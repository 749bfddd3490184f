"""Plain (dense-matrix) result ops: traceback, score hash, printers.

PyTorch/CUDA port of the reference's plain result ops
(ref: src/nwtrace1_plain.cpp, src/print_mat.hpp). The traceback itself is an
inherently sequential O(rows+cols) walk, so it runs on host — accelerated by
the native C++ runtime when available (native/nw_native.cpp), with the
oracle's Python walk as fallback. Timing laps use the reference's names.
"""

from __future__ import annotations

from typing import TextIO

import numpy as np

from ..core.types import AlgInput, AlgResult, AlignKind, GapKind, NEG_INF_I32, Status
from ..core.hashing import djb2_array
from ..models import oracle as _oracle


class _LazyE:
    """E[i, j] reconstructed on demand from H row i — no O(n^2) refill.

    Valid because gapo <= 0 (the guarded affine domain): reopening a gap
    never beats extending one, so
        E[i, j] = max_{0 <= k < j} (H[i, k] + gapo + (j - k) * gape),
    which is row-local in H. One cummax per distinct row queried (the
    traceback's row index is monotone, so a one-slot cache suffices).
    Arithmetic is int32, identical to the oracle's row fill.
    """

    def __init__(self, H: np.ndarray, gapo: int, gape: int):
        self.H = H
        self.go = np.int32(gapo)
        self.offs = (
            np.arange(H.shape[1], dtype=np.int32) * np.int32(gape)
        ).astype(np.int32)
        self._i = -1
        self._m: np.ndarray | None = None

    def __getitem__(self, idx):
        i, j = idx
        # The true E is -inf along BOTH borders (the oracle never writes
        # row 0 and pins column 0 each row); returning a finite
        # reconstruction at i == 0 would let the debug-mode attainment
        # walk enter the E state on the header row, double-appending the
        # visited cell and diverging the trace hash from the sparse walk.
        if i == 0 or j == 0:
            return np.int32(NEG_INF_I32)
        if i != self._i:
            m = (self.H[i] + self.go - self.offs).astype(np.int32)
            np.maximum.accumulate(m, out=m)
            self._m = m
            self._i = i
        return np.int32(self._m[j - 1] + self.offs[j])


class _LazyF:
    """F[i, j] reconstructed on demand from H column j (see _LazyE)."""

    def __init__(self, H: np.ndarray, gapo: int, gape: int):
        self.H = H
        self.go = np.int32(gapo)
        self.offs = (
            np.arange(H.shape[0], dtype=np.int32) * np.int32(gape)
        ).astype(np.int32)
        self._j = -1
        self._m: np.ndarray | None = None

    def __getitem__(self, idx):
        i, j = idx
        # -inf along BOTH borders, mirroring _LazyE (true F is never
        # finite at row 0 or column 0).
        if i == 0 or j == 0:
            return np.int32(NEG_INF_I32)
        if j != self._j:
            m = (self.H[:, j] + self.go - self.offs).astype(np.int32)
            np.maximum.accumulate(m, out=m)
            self._m = m
            self._j = j
        return np.int32(self._m[i - 1] + self.offs[i])


def trace_plain(nw: AlgInput, res: AlgResult, calc_debug_trace: bool) -> Status:
    sw = res.sw_trace
    sw.start()

    if nw.score is None:
        return Status.errorInvalidValue
    sw.lap("trace.alloc")

    mats = {"H": nw.score}
    if nw.spec.kind == AlignKind.SW:
        mats["best"] = np.array([nw.best_i, nw.best_j], dtype=np.int64)
    if nw.spec.gap == GapKind.AFFINE:
        # E/F views reconstructed lazily from H during the walk — the
        # kernels only keep H dense, and a full oracle refill here would
        # be a second O(n^2) pass.
        mats["E"] = _LazyE(nw.score, nw.gapo_cost, nw.gape_cost)
        mats["F"] = _LazyF(nw.score, nw.gapo_cost, nw.gape_cost)

    use_native = (
        nw.spec.kind == AlignKind.NW
        and nw.spec.gap == GapKind.LINEAR
        and not calc_debug_trace
    )
    transcript = None
    if use_native:
        try:
            from ..native import trace_linear_nw_native

            transcript, thash = trace_linear_nw_native(nw.score, nw.seqY, nw.seqX)
        except Exception:
            transcript = None
    if transcript is None:
        transcript, thash, cells = _oracle.oracle_trace_dense(
            nw.spec, mats, nw.subst, nw.seqY, nw.seqX,
            nw.gapo_cost, nw.gape_cost, debug=calc_debug_trace,
        )
        if calc_debug_trace:
            nw.trace = cells

    res.edit_trace = transcript
    res.trace_hash = thash
    sw.lap("trace.calc")
    return Status.success


def hash_plain(nw: AlgInput, res: AlgResult) -> Status:
    sw = res.sw_hash
    sw.start()
    if nw.score is None:
        return Status.errorInvalidValue
    res.score_hash = djb2_array(nw.score)
    sw.lap("hash.calc")
    return Status.success


def print_score_plain(os: TextIO, nw: AlgInput, res: AlgResult) -> Status:
    """Fixed-width matrix dump (ref: src/print_mat.hpp:8-95)."""
    if nw.score is None:
        return Status.errorInvalidValue
    for i in range(nw.adjrows):
        row = nw.score[i]
        os.write("".join(f"{int(v):4d}," for v in row))
        os.write("\n")
    return Status.success


def print_trace_plain(os: TextIO, nw: AlgInput, res: AlgResult) -> Status:
    vals = nw.trace or []
    os.write("".join(f"{int(v):4d}," for v in vals))
    os.write("\n")
    return Status.success
