"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` is compiled on first use into
``gpuseqalign_tpu_torch/_build/lib<name>-<hash>.so`` with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu

The file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import
time, and nothing but the repository's own sources is compiled.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()


def sources() -> List[str]:
    """Names of the kernel sources (``ops/csrc/<name>.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def so_path(name: str) -> str:
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str, so: str) -> subprocess.Popen:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(_CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Optional[List[str]] = None) -> float:
    """Compile every missing library, one nvcc per source, all started
    together and all waited for. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    errors = []
    with _lock:
        todo = [(n, so_path(n)) for n in (names or sources())]
        todo = [(n, so) for n, so in todo if not os.path.exists(so)]
        procs = [(n, so, _start(n, so)) for n, so in todo]
        for n, so, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu:\n{out}")
            else:
                os.replace(f"{so}.{os.getpid()}.tmp", so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``ops/csrc/<name>.cu``, building it if needed.
    Callers keep the handle (and set its argtypes) once."""
    build_all([name])
    return ctypes.CDLL(so_path(name))
