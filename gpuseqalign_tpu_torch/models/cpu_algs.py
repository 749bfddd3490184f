"""Host (CPU) alignment algorithms — the golden references.

These are the port's analogs of the reference's four CPU kernels
(ref: src/nwalign_cpu1_st_row.cpp, nwalign_cpu2_st_diag.cpp,
nwalign_cpu3_st_diagrow.cpp, nwalign_cpu4_mt_diagrow.cpp). `cpu1_st_row` is
the canonical oracle. All four produce identical dense score matrices; they
differ in evaluation order / backend:

  cpu1_st_row      vectorized row sweep (numpy max-plus prefix scan), or the
                   native C++ row-major loop when the native runtime is built
  cpu2_st_diag     native C++ anti-diagonal element order
  cpu3_st_diagrow  native C++ tile-diagonal order, row-major in tile (blocksz)
  cpu4_mt_diagrow  native C++ tile-wavefront with OpenMP threads (blocksz)

When the native runtime is unavailable the last three fall back to the
numpy sweep (same results, different machinery).
"""

from __future__ import annotations

import numpy as np

from ..core.types import (
    AlgInput,
    AlgParams,
    AlgResult,
    AlignKind,
    GapKind,
    Status,
)
from . import oracle as _oracle


def _finish_dense(nw: AlgInput, res: AlgResult, mats) -> Status:
    nw.score = mats["H"]
    if nw.spec.kind == AlignKind.SW:
        nw.best_i, nw.best_j = (int(v) for v in mats["best"])
        res.align_cost = int(mats["H"][nw.best_i, nw.best_j])
    else:
        res.align_cost = int(mats["H"][-1, -1])
    res.update_peak_mem(nw)
    return Status.success


def _native_order(order: str):
    """Return the native align entry point or None."""
    try:
        from ..native import align_dense_native

        return lambda nw, blocksz: align_dense_native(
            nw.subst, nw.seqY, nw.seqX, nw.gapo_cost, order, blocksz
        )
    except Exception:
        return None


def _align_cpu(order: str):
    def align(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
        blocksz = pr.get("blocksz", 0) or 0
        if order in ("diagrow", "mt_diagrow") and blocksz <= 0:
            return Status.errorInvalidValue

        sw = res.sw_align
        sw.start()
        sw.lap("align.alloc")

        is_nw_lg = (
            nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR
        )
        native = _native_order(order) if is_nw_lg else None
        if native is not None:
            try:
                H = native(nw, blocksz)
                sw.lap("align.calc")
                return _finish_dense(nw, res, {"H": H})
            except Exception:
                pass

        mats = _oracle.oracle_align_dense(
            nw.spec, nw.subst, nw.seqY, nw.seqX, nw.gapo_cost, nw.gape_cost
        )
        sw.lap("align.calc")
        return _finish_dense(nw, res, mats)

    return align


align_cpu1_st_row = _align_cpu("row")
align_cpu2_st_diag = _align_cpu("diag")
align_cpu3_st_diagrow = _align_cpu("diagrow")
align_cpu4_mt_diagrow = _align_cpu("mt_diagrow")
