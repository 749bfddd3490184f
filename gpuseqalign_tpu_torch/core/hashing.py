"""djb2-xor hashing, the reference's correctness fingerprint.

Replicates the exact byte stream semantics of the reference
(ref: src/nwtrace1_plain.cpp:113-128,133-154):
    hash = 5381
    for each value v (int, converted to unsigned 32-bit):
        hash = ((hash << 5) + hash) ^ v      # all mod 2**32

The score hash covers ALL adjrows x adjcols cells in row-major order,
header row/column included, padding excluded. The trace hash covers the
edit-transcript characters, then (debug mode only) the visited cell values.

A native C++ fast path lives in native/nw_native.cpp (djb2_i32); this module
is the reference implementation and fallback.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

DJB2_SEED = 5381
_M32 = 0xFFFFFFFF


def djb2_init() -> int:
    return DJB2_SEED


def djb2_ints(values: Iterable[int], h: int = DJB2_SEED) -> int:
    """Fold int values (any sign) into the hash, mod 2**32."""
    h &= _M32
    for v in values:
        h = (((h << 5) + h) & _M32) ^ (int(v) & _M32)
    return h


def djb2_str(s: str, h: int = DJB2_SEED) -> int:
    """Fold character code points (ASCII edit transcript) into the hash."""
    h &= _M32
    for ch in s:
        h = (((h << 5) + h) & _M32) ^ ord(ch)
    return h


def djb2_array(arr: np.ndarray, h: int = DJB2_SEED) -> int:
    """Hash a numpy int array in row-major (C) order.

    Uses the native C++ fast path when available, else a Python loop.
    """
    flat = np.ascontiguousarray(arr, dtype=np.int32).ravel()
    try:
        from .. import native

        if native.available():
            return native.djb2_i32(flat, h)
    except Exception:
        pass
    return djb2_ints(flat.tolist(), h)
