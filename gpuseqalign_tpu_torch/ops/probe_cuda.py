"""Wrappers of the step-body probes (``ops/csrc/probe.cu``, K8a–d).

``probe_chain``, ``probe_fullstep`` (linear or affine by ``gap``) and
``probe_int16`` take the layouts of ``ops/probe_plain.py`` and return what
their plain versions return. On a CUDA tensor each launches its kernel on
the current stream (one block per row of ``a`` or ``y``; the caller sizes
the grid) or raises; it uses the plain version only for tensors that lie
on the CPU. ``kernel_info`` reports what the compiler made of a probe
kernel (registers, spills, resident blocks a SM).

``LAUNCHES`` counts kernel launches by kernel name, so a run can show that
it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .probe_plain import (
    CHAIN_BODIES,
    INT16_MODES,
    VARIANTS,
    chain_plain,
    fullstep_plain,
    int16_plain,
)

KERNELS = ("probe_chain", "probe_fullstep", "probe_fullstep_affine",
           "probe_int16")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# Chains a thread of the elementwise bodies may hold, and strips a block
# of the skeletons and of the fullstep bodies (the kernel's instantiations).
CHAIN_NCH = (1, 12)
STRIP_K = (1, 2, 4, 6, 8)
MAX_THREADS = 256

_lib = None


def load_lib() -> ctypes.CDLL:
    """The library of ``ops/csrc/probe.cu``, built on first use."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("probe")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.probe_chain.argtypes = [i, i, p, i, i, i, i, i, p, p]
        lib.probe_fullstep.argtypes = [
            i, i, p, i, p, p, p,       # variant, K, subst, S, y, x, a
            i, i, i, i,                # gapo, iters, blocks, nt
            p, p, p, p,                # hcol, hrow, best, stream
        ]
        lib.probe_fullstep_affine.argtypes = [
            i, i, p, i, p, p, p,       # variant, K, subst, S, y, x, a
            i, i, i, i, i,             # gapo, gape, iters, blocks, nt
            p, p, p, p, p, p,          # hcol, ecol, hrow, frow, best, stream
        ]
        lib.probe_int16.argtypes = [i, p, i, i, i, p, p]
        lib.probe_kernel_info.argtypes = [i, i, i, i, i, p]
        for fn in (lib.probe_chain, lib.probe_fullstep,
                   lib.probe_fullstep_affine, lib.probe_int16,
                   lib.probe_kernel_info):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dim: int, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _check_threads(nt: int, onewarp: bool = False) -> None:
    if onewarp and nt != 32:
        raise ValueError(f"the onewarp variant runs 32 rows a strip, got {nt}")
    if nt < 32 or nt > MAX_THREADS or nt % 32:
        raise ValueError(f"threads a block must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {nt}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, fn, *args) -> None:
    dev = torch.cuda.current_device()
    rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device: {t.device}")
    return True


def probe_chain(a: torch.Tensor, body: str, nch: int, iters: int,
                gapo: int = -11, gape: int = -2) -> torch.Tensor:
    """K8a: ``iters`` iterations of ``body`` on ``nch`` chains a thread;
    a (blocks, nt) -> (blocks, nt). The skeletons take ``iters`` columns
    and the gap costs; their nch is the strips a block."""
    if body not in CHAIN_BODIES:
        raise ValueError(f"unknown probe_chain body {body!r}")
    skeleton = body.startswith("skeleton_")
    if nch not in (STRIP_K if skeleton else CHAIN_NCH):
        raise ValueError(f"{body} takes no {nch} chains")
    if iters < (1 if skeleton else 0):
        raise ValueError(f"iters must be positive, got {iters}")
    _check("a", a, 2, a.device)
    _check_threads(a.shape[1])
    if not _on_cuda(a):
        return chain_plain(a, body, nch, iters, gapo, gape)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch("probe_chain", load_lib().probe_chain,
                CHAIN_BODIES.index(body), nch, _ptr(a), gapo, gape, iters,
                a.shape[0], a.shape[1], _ptr(out))
    return out


def probe_fullstep(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                   a: torch.Tensor, gapo: int, gape: int = 0, *,
                   gap: str = "linear", variant: str = "base"
                   ) -> Dict[str, torch.Tensor]:
    """K8b (``gap`` "linear") and K8c ("affine"): K strips a block of
    ``y.shape[2]`` rows and ``x.shape[1] - 1`` columns; subst (S, S),
    y (blocks, K, nt), x (K, 1 + iters), a (blocks, nt)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if gap not in ("linear", "affine"):
        raise ValueError(f"unknown gap {gap!r}")
    dev = y.device
    _check("subst", subst, 2, dev)
    _check("y", y, 3, dev)
    _check("x", x, 2, dev)
    _check("a", a, 2, dev)
    blocks, K, nt = y.shape
    iters = x.shape[1] - 1
    S = subst.shape[0]
    if subst.shape[1] != S or x.shape[0] != K or iters < 1:
        raise ValueError(f"shapes subst {tuple(subst.shape)}, y "
                         f"{tuple(y.shape)}, x {tuple(x.shape)} disagree")
    if tuple(a.shape) != (blocks, nt):
        raise ValueError(f"a must be {(blocks, nt)}, got {tuple(a.shape)}")
    if K not in STRIP_K:
        raise ValueError(f"K must be one of {STRIP_K}, got {K}")
    _check_threads(nt, variant == "onewarp")
    affine = gap == "affine"
    if not _on_cuda(y):
        return fullstep_plain(subst, y, x, a, gapo, gape if affine else 0,
                              gap=gap, variant=variant)

    def new(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = {"hcol": new(blocks, K, nt)}
    if affine:
        out["ecol"] = new(blocks, K, nt)
    if variant != "noheader":
        out["hrow"] = new(blocks, K, iters)
        if affine:
            out["frow"] = new(blocks, K, iters)
    if variant == "sw":
        out["best"] = new(blocks, K, nt, 3)
    lib = load_lib()
    head = (VARIANTS.index(variant), K, _ptr(subst), S, _ptr(y), _ptr(x),
            _ptr(a), gapo)
    with torch.cuda.device(dev):
        if affine:
            _launch("probe_fullstep_affine", lib.probe_fullstep_affine,
                    *head, gape, iters, blocks, nt, _ptr(out["hcol"]),
                    _ptr(out["ecol"]), _ptr(out.get("hrow")),
                    _ptr(out.get("frow")), _ptr(out.get("best")))
        else:
            _launch("probe_fullstep", lib.probe_fullstep, *head, iters,
                    blocks, nt, _ptr(out["hcol"]), _ptr(out.get("hrow")),
                    _ptr(out.get("best")))
    return out


def probe_int16(a: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """K8d: twelve max(c + a, a + 7) chains a thread in ``mode`` ("i32",
    "i16x2" or "i16x2_dpx"); a (blocks, nt) -> (blocks, nt)."""
    if mode not in INT16_MODES:
        raise ValueError(f"unknown probe_int16 mode {mode!r}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    _check("a", a, 2, a.device)
    _check_threads(a.shape[1])
    if not _on_cuda(a):
        return int16_plain(a, mode, iters)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch("probe_int16", load_lib().probe_int16,
                INT16_MODES.index(mode), _ptr(a), iters, a.shape[0],
                a.shape[1], _ptr(out))
    return out


def kernel_info(kernel: str, sel: str, K: int, nt: int, S: int = 25
                ) -> Dict[str, int]:
    """Registers a thread, local (spill) bytes a thread, resident blocks a
    SM at ``nt`` threads and dynamic shared bytes of one probe kernel:
    ``kernel`` one of KERNELS, ``sel`` its body, variant or mode."""
    names = {"probe_chain": CHAIN_BODIES, "probe_fullstep": VARIANTS,
             "probe_fullstep_affine": VARIANTS, "probe_int16": INT16_MODES}
    info = (ctypes.c_int * 4)()
    rc = load_lib().probe_kernel_info(KERNELS.index(kernel),
                                      names[kernel].index(sel), K, nt, S,
                                      info)
    if rc != 0:
        raise RuntimeError(f"probe_kernel_info({kernel}, {sel}, K={K}, "
                           f"nt={nt}): cudaError {rc}")
    return dict(zip(("regs", "local_bytes", "blocks_per_sm", "smem_bytes"),
                    info))
