"""Wrappers of the CUDA row-block wavefront fills (``ops/csrc/wavefront.cu``).

``mlsp_nw_lg_fill`` (K2, the tile headers) and ``dense_nw_lg_fill`` (K4,
the wavefront history) take the inputs of their plain versions in
``ops/wavefront_plain.py`` and return the same outputs. On a CUDA tensor
each launches its kernel, one launch per row block in stream order on the
current stream (row block b reads the row that block b-1 wrote), or
raises; it uses the plain version only for tensors that lie on the CPU.

``LAUNCHES`` counts kernel launches by kernel name, so a run can show that
it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .wavefront_plain import dense_nw_lg_plain, mlsp_nw_lg_plain

KERNELS = ("wavefront_mlsp", "wavefront_dense")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# The largest row block the kernel has an instance for: R/K threads of K
# consecutive rows each, K in {1, 2, 4, 8, 16}, at most 1024 threads.
MAX_R = 4096
# The kernel's own shared memory: a double-buffered hand-off slot for each
# of up to 32 warps (``xh`` in ops/csrc/wavefront.cu), in bytes.
SMEM_BYTES = 2 * 32 * 4

_lib = None


def load_lib() -> ctypes.CDLL:
    """The library of ``ops/csrc/wavefront.cu``, built on first use."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("wavefront")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavefront_fill_block.argtypes = [
            i, p, i, i, i, i,          # mlsp, pskew, B, nspad, R, cols_p
            i, i, i, i,                # tw, ct, gapo, b
            p, i, p, p, p,             # hrow, hrow_len, hcol, vhist, stream
        ]
        lib.wavefront_fill_block.restype = ctypes.c_int
        _lib = lib
    return _lib


def nspad_of(R: int, cols_p: int, W: int) -> int:
    """The padded step count of a row block (the TPU kernel's NSpad): its
    R + cols_p - 1 steps and 128 more, rounded up to W."""
    return -(-(R + cols_p - 1 + 128) // W) * W


def _check(pskew: torch.Tensor, cols_p: int, W: int,
           TW: Optional[int] = None) -> None:
    """Raise on anything the kernel does not take."""
    if pskew.dtype != torch.int32:
        raise TypeError(f"pskew must be int32, got {pskew.dtype}")
    if pskew.dim() != 4 or pskew.shape[3] != 128:
        raise ValueError(f"pskew must be (B, NSpad, SUB, 128), got "
                         f"{tuple(pskew.shape)}")
    if not pskew.is_contiguous() or pskew.data_ptr() % 16:
        raise ValueError("pskew must be contiguous and 16-byte aligned")
    B, nspad, sub, _ = pskew.shape
    R = sub * 128
    if B < 1 or sub < 1 or cols_p < 1:
        raise ValueError(f"empty fill: B {B}, R {R}, cols_p {cols_p}")
    if R > MAX_R:
        raise ValueError(f"row block R = {R} is above the largest kernel "
                         f"instance ({MAX_R})")
    if W < 128 or W % 128:
        raise ValueError(f"W = {W} must be a positive multiple of 128")
    if nspad != nspad_of(R, cols_p, W):
        raise ValueError(f"pskew has {nspad} steps, expected "
                         f"{nspad_of(R, cols_p, W)} for R {R}, cols_p "
                         f"{cols_p}, W {W}")
    if TW is not None and (TW % 128 or TW < R or TW % W or cols_p % TW):
        raise ValueError(f"tile width TW = {TW} must be a multiple of 128 "
                         f"and of W = {W}, >= R = {R}, and divide cols_p = "
                         f"{cols_p}")


def _launch(name: str, pskew: torch.Tensor, cols_p: int, gapo: int,
            hrow: torch.Tensor, tw: int, ct: int,
            hcol: Optional[torch.Tensor],
            vhist: Optional[torch.Tensor]) -> None:
    lib = load_lib()
    B, nspad, sub, _ = pskew.shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    dev = pskew.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b in range(B):
            rc = lib.wavefront_fill_block(
                int(hcol is not None), ptr(pskew), B, nspad, sub * 128,
                cols_p, tw, ct, gapo, b, ptr(hrow), hrow.shape[1],
                ptr(hcol), ptr(vhist), stream)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed on row block {b}: "
                                   f"cudaError {rc}")
            LAUNCHES[name] += 1


def mlsp_nw_lg_fill(pskew: torch.Tensor, gapo: int, *, cols_p: int,
                    W: int, TW: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (hrow, hcol) of the sparse fill whose profile ``pskew`` holds
    (``wavefront_plain`` layout)."""
    _check(pskew, cols_p, W, TW)
    if pskew.device.type == "cpu":
        return mlsp_nw_lg_plain(pskew, gapo, cols_p=cols_p, W=W, TW=TW)
    if pskew.device.type != "cuda":
        raise ValueError(f"unsupported device: {pskew.device}")
    B, nspad, sub, lanes = pskew.shape
    ct = -(-(nspad // W) // (TW // W))
    i32 = dict(dtype=torch.int32, device=pskew.device)
    hrow = torch.empty((B, nspad + 128), **i32)
    hcol = torch.empty((B, ct, sub, lanes), **i32)
    _launch("wavefront_mlsp", pskew, cols_p, gapo, hrow, TW, ct, hcol, None)
    return hrow, hcol


def dense_nw_lg_fill(pskew: torch.Tensor, gapo: int, *, cols_p: int,
                     W: int) -> torch.Tensor:
    """K4: the wavefront history vhist of the fill whose profile ``pskew``
    holds (``wavefront_plain`` layout)."""
    _check(pskew, cols_p, W)
    if pskew.device.type == "cpu":
        return dense_nw_lg_plain(pskew, gapo, cols_p=cols_p)
    if pskew.device.type != "cuda":
        raise ValueError(f"unsupported device: {pskew.device}")
    B = pskew.shape[0]
    i32 = dict(dtype=torch.int32, device=pskew.device)
    # Row (b+1)*R of H, which row block b+1 reads as its top row.
    carry = torch.empty((B, cols_p + 1), **i32)
    vhist = torch.empty(pskew.shape, **i32)
    _launch("wavefront_dense", pskew, cols_p, gapo, carry, 1, 0, None, vhist)
    return vhist
