"""Native C++ host runtime: DP oracles, traceback, djb2 hashing.

The reference's runtime is C++17 (ref: src/ layer L1/L2a); this package
provides the port's native host components, built with g++ into a shared
library on first use (not at import) and bound via ctypes. Pure-Python
fallbacks exist everywhere, so the framework degrades gracefully when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .build import load_library


def available() -> bool:
    """Build (once, on first use) and report the native library."""
    return load_library() is not None


def djb2_i32(arr: np.ndarray, h: int = 5381) -> int:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    arr = np.ascontiguousarray(arr, dtype=np.int32).ravel()
    return int(
        lib.nw_djb2_i32(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(arr.size),
            ctypes.c_uint32(h & 0xFFFFFFFF),
        )
    )


def align_dense_native(
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    order: str,
    blocksz: int = 0,
) -> np.ndarray:
    """NW linear-gap dense fill with the given evaluation order:
    'row' | 'diag' | 'diagrow' | 'mt_diagrow'."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    orders = {"row": 0, "diag": 1, "diagrow": 2, "mt_diagrow": 3}
    subst = np.ascontiguousarray(subst, dtype=np.int32)
    seqY = np.ascontiguousarray(seqY, dtype=np.int32)
    seqX = np.ascontiguousarray(seqX, dtype=np.int32)
    adjrows, adjcols = seqY.size, seqX.size
    H = np.empty((adjrows, adjcols), dtype=np.int32)
    rc = lib.nw_align_dense(
        subst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(subst.shape[0]),
        seqY.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(adjrows),
        seqX.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(adjcols),
        ctypes.c_int(gapo),
        ctypes.c_int(orders[order]),
        ctypes.c_int(blocksz),
        H.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"nw_align_dense failed: {rc}")
    return H


def trace_linear_nw_native(
    H: np.ndarray, seqY: np.ndarray, seqX: np.ndarray
) -> Tuple[str, int]:
    """Reference-exact NW linear traceback; returns (edit_trace, trace_hash)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    H = np.ascontiguousarray(H, dtype=np.int32)
    seqY = np.ascontiguousarray(seqY, dtype=np.int32)
    seqX = np.ascontiguousarray(seqX, dtype=np.int32)
    adjrows, adjcols = H.shape
    # Worst-case transcript: every step flips the edit letter.
    cap = 16 * (adjrows + adjcols) + 64
    buf = ctypes.create_string_buffer(cap)
    out_hash = ctypes.c_uint32(0)
    n = lib.nw_trace_linear(
        H.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(adjrows),
        ctypes.c_int(adjcols),
        seqY.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        seqX.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        buf,
        ctypes.c_int64(cap),
        ctypes.byref(out_hash),
    )
    if n < 0:
        raise RuntimeError("nw_trace_linear failed")
    return buf.raw[:n].decode("ascii"), int(out_hash.value)


def hash_sparse_native(
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int,
    kind: str,
    gap: str,
    hrowmat: Optional[np.ndarray],
    hcolmat: Optional[np.ndarray],
    th: int,
    tw: int,
    mat_rows: int,
    mat_cols: int,
    seed: int = 5381,
) -> int:
    """Sparse score hash (rolling-row recompute with stored-header
    substitution) — the C++ twin of trace/sparse._recompute_rows +
    _stored_header_overlay; ~15x the NumPy path on big pairs. Pass
    hrowmat/hcolmat None to hash the pure recompute."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    subst = np.ascontiguousarray(subst, dtype=np.int32)
    seqY = np.ascontiguousarray(seqY, dtype=np.int32)
    seqX = np.ascontiguousarray(seqX, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if hrowmat is not None and hcolmat is not None:
        hrowmat = np.ascontiguousarray(hrowmat, dtype=np.int32)
        hcolmat = np.ascontiguousarray(hcolmat, dtype=np.int32)
        hr = hrowmat.ctypes.data_as(i32p)
        hc = hcolmat.ctypes.data_as(i32p)
    else:
        hr = ctypes.cast(None, i32p)
        hc = ctypes.cast(None, i32p)
        th = tw = mat_rows = mat_cols = 0
    return int(
        lib.nw_hash_sparse(
            subst.ctypes.data_as(i32p), ctypes.c_int(subst.shape[0]),
            seqY.ctypes.data_as(i32p), ctypes.c_int(seqY.size),
            seqX.ctypes.data_as(i32p), ctypes.c_int(seqX.size),
            ctypes.c_int32(gapo), ctypes.c_int32(gape),
            ctypes.c_int(1 if kind == "sw" else 0),
            ctypes.c_int(1 if gap == "affine" else 0),
            hr, hc,
            ctypes.c_int(th), ctypes.c_int(tw),
            ctypes.c_int(mat_rows), ctypes.c_int(mat_cols),
            ctypes.c_uint32(seed & 0xFFFFFFFF),
        )
    )
