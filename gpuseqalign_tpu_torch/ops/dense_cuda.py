"""Wrapper of the CUDA dense fill of one pair (K3, ``strip_fill_dense`` of
``ops/csrc/strip_fill.cu``, host side ``ops/strip_cuda.py``).

``dense_fill`` returns the H window (adjr, adjc) of one pair, header row
and column included. On a CUDA tensor it launches the kernel once on the
current stream (row strips over the live cells, each strip's top row read
back from H, the cells stored row-wise through shared memory) or raises;
on a CPU tensor it runs the plain version, ``dense_plain.rowscan_dense``.
A pair with an empty side (adjr or adjc 1) has H = its header alone and
launches nothing.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import strip_cuda
from .dense_plain import rowscan_dense
from .mlsp_plain import edge_col, edge_row

LAUNCHES = 0

# The schedule, from chip_smoke.py's sweep over strip heights and warps a
# block at 23728^2 on an H100 (PERF.md): strips of 32*LANE_ROWS rows,
# WARPS warps a block.
LANE_ROWS, WARPS = 4, 1


def _check(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
           adjr: int, adjc: int) -> None:
    for name, t in (("subst", subst), ("y", y), ("x", x)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if subst.dim() != 2 or subst.shape[0] != subst.shape[1]:
        raise ValueError(f"subst must be square, got {tuple(subst.shape)}")
    if y.dim() != 1 or x.dim() != 1:
        raise ValueError("y and x must be 1-D")
    if not (1 <= adjr <= y.numel() and 1 <= adjc <= x.numel()):
        raise ValueError(
            f"adjr {adjr} / adjc {adjc} must lie in [1, {y.numel()}] / "
            f"[1, {x.numel()}]"
        )


def dense_fill(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
               gapo: int, gape: int, adjr: int, adjc: int, *, kind: str,
               gap: str, _lane_rows: Optional[int] = None,
               _warps: Optional[int] = None) -> torch.Tensor:
    """H (adjr, adjc) int32 of the header-prefixed ``y[:adjr]`` against
    ``x[:adjc]`` (both may be padded past their true lengths).
    ``_lane_rows`` and ``_warps`` override the schedule (hooks for the
    checks and the sweep of ``chip_smoke.py``)."""
    global LAUNCHES
    _check(subst, y, x, adjr, adjc)
    if y.device.type == "cpu":
        return rowscan_dense(subst, y[:adjr], x[:adjc], gapo, gape,
                             kind=kind, gap=gap)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device: {y.device}")

    dev = y.device
    i32 = dict(dtype=torch.int32, device=dev)
    H = torch.empty((adjr, adjc), **i32)
    H[0] = edge_row(adjc, gapo, gape, kind, gap, dev)
    H[1:, 0] = edge_col(torch.arange(1, adjr, **i32), gapo, gape, kind, gap)
    if adjr < 2 or adjc < 2:
        return H

    lib = strip_cuda.load_lib()
    is_sw, affine = kind == "sw", gap == "affine"
    S = subst.shape[0]
    k = _lane_rows or LANE_ROWS
    warps = _warps or WARPS
    ns = strip_cuda.n_strips(adjr - 1, 32 * k)
    prog, carry = strip_cuda.alloc_dense_scratch(ns, adjc - 1, affine, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.strip_fill_dense(
            int(is_sw), int(affine), k, warps, ptr(subst), S,
            ptr(y), ptr(x), gapo, gape, adjr, adjc, ptr(H), ptr(carry),
            ptr(prog), torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"dense_fill launch failed: cudaError {rc}")
        LAUNCHES += 1
    return H
