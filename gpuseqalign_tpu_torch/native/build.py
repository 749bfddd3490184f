"""Build + load the native host runtime (g++ -> shared library, ctypes).

The library is rebuilt automatically whenever the C++ source is newer than
the cached .so. Returns None (pure-Python fallbacks everywhere) when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "nw_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_SO = os.path.join(_BUILD_DIR, "libnw_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> bool:
    # Build under a private name and rename into place, so processes that
    # build at the same time never load a half-written library.
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        # Retry without -march=native (portability).
        cmd.remove("-march=native")
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.TimeoutExpired):
            return False
        if proc.returncode != 0:
            print(
                f"gpuseqalign_tpu_torch: native build failed:\n{proc.stderr}",
                file=sys.stderr,
            )
            return False
    os.replace(tmp, _SO)
    return True


def _set_signatures(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nw_djb2_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_uint32]
    lib.nw_djb2_i32.restype = ctypes.c_uint32
    lib.nw_align_dense.argtypes = [
        i32p, ctypes.c_int, i32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, i32p,
    ]
    lib.nw_align_dense.restype = ctypes.c_int
    lib.nw_trace_linear.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.nw_trace_linear.restype = ctypes.c_int64
    lib.nw_hash_sparse.argtypes = [
        i32p, ctypes.c_int,              # subst, substsz
        i32p, ctypes.c_int,              # Y, adjrows
        i32p, ctypes.c_int,              # X, adjcols
        ctypes.c_int32, ctypes.c_int32,  # gapo, gape
        ctypes.c_int, ctypes.c_int,      # kind, gap
        i32p, i32p,                      # hrowmat, hcolmat (nullable)
        ctypes.c_int, ctypes.c_int,      # th, tw
        ctypes.c_int, ctypes.c_int,      # Rt, C
        ctypes.c_uint32,                 # seed
    ]
    lib.nw_hash_sparse.restype = ctypes.c_uint32


def load_library() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            needs_build = (not os.path.exists(_SO)) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_SO)
            )
            if needs_build and not _compile():
                return None
            lib = ctypes.CDLL(_SO)
            _set_signatures(lib)
            _lib = lib
        except Exception:
            _lib = None
        return _lib
