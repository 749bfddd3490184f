"""Host side of the persistent row-strip fill (``ops/csrc/strip_fill.cu``),
the kernel of the single-pair sparse fill (K1, ``mlsp_cuda.mlsp_fill``),
the dense fill (K3, ``dense_cuda.dense_fill``), the batched fill (K5,
``batch_cuda.mlsp_fill_batch``) and the banded pass (K7,
``banded_cuda.banded_pass``).

The kernel cuts each matrix (a band's pass, or a pair) into strips of
``32*K`` rows, one warp a strip, and hands strips out by an atomic ticket.
What the wrappers decide on the host lives here as plain functions, so
the CPU tests reach it: the strip height for a tile height, whether the
carry between strips can live in the tile headers, the sizes of the
counter and carry scratch, a block's shared memory and warps, and the
order in which tickets map to strips.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import torch

# Rows a lane can hold, and so the strip heights 32*K the kernel is built for.
LANE_ROWS = (1, 2, 4, 8)
STRIP_HEIGHTS = tuple(32 * k for k in LANE_ROWS)
# Warps a block of the single-pair sparse fill (K1): at 23728^2 on an H100
# the pair entry at 1 ran 1-4% below the batch entry at 4 (chip_smoke.py's
# A/B, PERF.md). The kernel takes 1..MAX_WARPS.
PAIR_WARPS = 1
MAX_WARPS = 4
# Shared memory one block may opt in to on an H100 (227 KB).
SMEM_MAX = 232448
# The kernel's shared-memory layout (strip_fill.cu): words of a warp's
# letter ring, and columns of a dense warp's staging buffer.
_RING, _STAGE_COLS = 128, 64

_lib = None


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How the kernel covers a matrix of ``tile_h``-row tiles: strips of
    ``rows`` = 32*``lane_rows`` rows, and whether each strip's bottom row
    is a tile-header row (the carry then needs no scratch where the
    headers are written)."""

    rows: int
    lane_rows: int
    carry_in_headers: bool


def strip_rows(tile_h: int) -> int:
    """The strip height for tiles of ``tile_h`` rows: the smallest of
    ``STRIP_HEIGHTS`` that is a multiple of ``tile_h`` (so strips end on
    tile rows), else the largest that divides it, else 32 for a tile
    shorter than 32 rows and 128 for a taller one. Every choice keeps
    ``tile_h`` >= K, so a lane's K rows hold at most one tile-row
    boundary."""
    if tile_h < 1:
        raise ValueError(f"tile_h must be >= 1, got {tile_h}")
    for sh in STRIP_HEIGHTS:
        if sh % tile_h == 0:
            return sh
    for sh in reversed(STRIP_HEIGHTS):
        if tile_h % sh == 0:
            return sh
    return 32 if tile_h < 32 else 128


def schedule(tile_h: int, tile_w: int) -> Schedule:
    """The kernel's schedule for tiles of ``tile_h`` x ``tile_w``."""
    if tile_w < 1:
        raise ValueError(f"tile_w must be >= 1, got {tile_w}")
    sh = strip_rows(tile_h)
    return Schedule(rows=sh, lane_rows=sh // 32,
                    carry_in_headers=sh % tile_h == 0)


def n_strips(rows: int, strip: int) -> int:
    """Strips of ``strip`` rows that cover ``rows`` rows (the last may be
    ragged)."""
    return -(-rows // strip)


def ticket_order(nmat: int, ns: int) -> List[Tuple[int, int]]:
    """(matrix, strip) of each ticket, in ticket order: the kernel's
    mapping, strip t // nmat of matrix t % nmat. Strip s of a matrix comes
    before its strip s + 1, so a warp waits only on an earlier ticket."""
    return [(t % nmat, t // nmat) for t in range(nmat * ns)]


def smem_bytes(lane_rows: int, S: int, warps: int, dense: bool) -> int:
    """Dynamic shared memory of one block of ``warps`` warps (the kernel's
    ``smem_words``): MAX_WARPS letter rings, the substitution matrix and,
    for the dense fill, each warp's staging buffer of 32*K rows by two
    32-column chunks."""
    words = MAX_WARPS * _RING + S * S
    if dense:
        words += warps * 32 * lane_rows * _STAGE_COLS
    return 4 * words


def max_warps(lane_rows: int, S: int, dense: bool) -> int:
    """The most warps a block (at most MAX_WARPS) whose shared memory
    fits in SMEM_MAX; 0 if not even one warp's does."""
    fits = [w for w in range(1, MAX_WARPS + 1)
            if smem_bytes(lane_rows, S, w, dense) <= SMEM_MAX]
    return max(fits, default=0)


def dense_scratch_words(ns: int, cols: int, affine: bool) -> Tuple[int, int]:
    """(counter words, carry words) of one dense fill of ``ns`` strips and
    ``cols`` live columns: the ticket and a counter a strip; H of each
    strip's bottom row is a row of H itself, so the carry holds only F
    (affine gaps), ``cols + 1`` wide a strip."""
    return 1 + ns, (ns * (cols + 1) if affine else 0)


def scratch_words(nmat: int, ns: int, cols: int, carry: bool,
                  affine: bool) -> Tuple[int, int]:
    """(counter words, carry words) of one launch over ``nmat`` matrices
    of ``ns`` strips and ``cols`` columns: the ticket and a progress
    counter a strip, and, where the carry is not in the headers, H (and F
    for ``affine`` gaps) of each strip's bottom row. A carry row is
    ``cols + 1`` wide for every matrix, also for a pair of a bucket whose
    live region is narrower, so that one offset serves every pair."""
    planes = 1 + int(affine)
    return 1 + nmat * ns, (planes * nmat * ns * (cols + 1) if carry else 0)


def _alloc(n_prog: int, n_carry: int, dev: torch.device
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    prog = torch.zeros(n_prog, dtype=torch.int32, device=dev)
    rows = (torch.empty(n_carry, dtype=torch.int32, device=dev)
            if n_carry else None)
    return prog, rows


def alloc_scratch(nmat: int, ns: int, cols: int, carry: bool,
                  affine: bool, dev: torch.device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A launch's own scratch: the counters zeroed (every call), and the
    carry rows where needed (never read before their counter passes
    them)."""
    return _alloc(*scratch_words(nmat, ns, cols, carry, affine), dev)


def alloc_dense_scratch(ns: int, cols: int, affine: bool, dev: torch.device
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A dense fill's own scratch: the counters zeroed, and F's carry rows
    for affine gaps."""
    return _alloc(*dense_scratch_words(ns, cols, affine), dev)


def load_lib() -> ctypes.CDLL:
    """The library of ``ops/csrc/strip_fill.cu``, built on first use."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("strip_fill")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.strip_fill_banded.argtypes = [
            i, i, i, p, i,             # sw, affine, K, subst, S
            p, p, i, i, i, i,          # y, x, gapo, gape, adjr, adjc
            i, i, i, i,                # th, tw, trows, tcols
            p, p, p, p, p,             # hrows, hcols, frows, ecols, tbest
            p, p, p,                   # carry, prog, stream
        ]
        lib.strip_fill_batch.argtypes = [
            i, i, i, i, p, i,          # sw, affine, K, headers, subst, S
            p, p, i, i, p, p,          # ys, xs, gapo, gape, adjrs, adjcs
            i, i, i, i, i,             # th, tw, trows, tcols, npairs
            i, i,                      # ys_stride, adjrs_stride
            p, p, p, p, p, p,          # hrows, hcols, frows, ecols, tbest, cost
            p, p, p,                   # carry, prog, stream
        ]
        lib.strip_fill_pair.argtypes = [
            i, i, i, i, i,             # sw, affine, K, warps, bodyoff
            p, i, p, p, i, i, i, i,    # subst, S, y, x, gapo, gape, adjr, adjc
            i, i, i, i,                # th, tw, trows, tcols
            p, p, p, p, p,             # hrows, hcols, frows, ecols, tbest
            p, p, p,                   # carry, prog, stream
        ]
        lib.strip_fill_dense.argtypes = [
            i, i, i, i,                # sw, affine, K, warps
            p, i, p, p, i, i, i, i,    # subst, S, y, x, gapo, gape, adjr, adjc
            p, p, p, p,                # H, carry, prog, stream
        ]
        for entry in ("banded", "batch", "pair", "dense"):
            getattr(lib, f"strip_fill_{entry}").restype = ctypes.c_int
        _lib = lib
    return _lib
