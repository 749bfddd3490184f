"""Host side of the tiny-pair fill (K6, ``ops/csrc/mlsp_tiny.cu``), the
kernel of ``batch_cuda.tiny_scores``.

The kernel fills one pair a warp, ``warps`` pairs a block, one launch a
bucket: a warp sweeps its pair's row strips of 32*K rows in turn, lane l
holding K consecutive rows of a strip, the carry row between strips in
the warp's shared memory (or in global scratch when a block's rows do not
fit). What the wrapper decides on the host lives here as plain functions,
so the CPU tests reach it: the strips and rows a lane of a pair, a
block's shared memory, the carry scratch and the warps a block.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

# Rows a lane a strip holds at most (mlsp_tiny.cu's kLaneRows): a pair of
# R live rows runs ceil(R / (32*LANE_ROWS)) strips.
LANE_ROWS = 8
# Warps (one pair each) a block: 1..MAX_WARPS.
MAX_WARPS = 4
# Words of a warp's ring of column letters (mlsp_tiny.cu's kRing).
RING = 128
# Shared memory a block uses at most; the carry rows go to global scratch
# before a block would need more (mlsp_tiny.cu's kSmemLimit).
SMEM_LIMIT = 48 * 1024
# Warps a block tiny_scores launches with. On an H100 (chip_smoke.py's
# sweep, four runs, PERF.md) 1 and 2 were within 4% of each other at
# 16384 pairs, each ahead in two runs, and changed order between runs on
# smaller buckets; 3 and 4 ran up to 28% slower in some runs.
WARPS = 2

_lib = None


def pair_strips(rows: int) -> Tuple[int, int]:
    """(strips, rows a lane) of a pair of ``rows`` live rows: the fewest
    strips of at most 32*LANE_ROWS rows, then the fewest rows a lane that
    cover ``rows`` in that many, so the strips overshoot by fewer than 32
    rows a strip."""
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    ns = -(-rows // (32 * LANE_ROWS))
    return ns, -(-rows // (32 * ns))


def carry_words(cols_p: int, affine: bool) -> int:
    """Words of one pair's carry row: H, and F for affine gaps, each
    ``cols_p + 1`` wide."""
    return (2 if affine else 1) * (cols_p + 1)


def smem_bytes(S: int, warps: int, cols_p: int, affine: bool,
               carry: bool) -> int:
    """Dynamic shared memory of one block (the kernel's ``smem_words``):
    the substitution matrix, a letter ring a warp and, with ``carry``, a
    carry row a warp."""
    words = S * S + warps * RING
    if carry:
        words += warps * carry_words(cols_p, affine)
    return 4 * words


def scratch_words(S: int, warps: int, cols_p: int, affine: bool) -> int:
    """Words of global scratch a pair: 0 when a block's carry rows fit in
    its shared memory, else one carry row."""
    if smem_bytes(S, warps, cols_p, affine, True) <= SMEM_LIMIT:
        return 0
    return carry_words(cols_p, affine)


def check_warps(warps: int, S: int) -> None:
    """Raise on a block the kernel refuses: 0 or more than MAX_WARPS
    warps, or a substitution matrix and letter rings above SMEM_LIMIT."""
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps must be in 1..{MAX_WARPS}, got {warps}")
    if smem_bytes(S, warps, 0, False, False) > SMEM_LIMIT:
        raise ValueError(f"a {S}x{S} substitution matrix does not fit in "
                         f"{SMEM_LIMIT} bytes of shared memory")


def load_lib() -> ctypes.CDLL:
    """The library of ``ops/csrc/mlsp_tiny.cu``, built on first use."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("mlsp_tiny")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mlsp_tiny.argtypes = [
            i, i, i,                   # sw, affine, warps
            p, i, p, p, i, i,          # subst, S, ys, xs, gapo, gape
            p, p, i, i, i,             # adjrs, adjcs, rows_p, cols_p, npairs
            i, i,                      # ys_stride, adjrs_stride
            p, p, p, p,                # cost, best, scratch, stream
        ]
        lib.mlsp_tiny.restype = ctypes.c_int
        _lib = lib
    return _lib
