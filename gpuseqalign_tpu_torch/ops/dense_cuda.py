"""Wrapper of the CUDA dense fill (the dense entry of
``ops/csrc/mlsp_fill.cu``).

``dense_fill`` returns the H window (adjr, adjc) of one pair, header row
and column included. On a CUDA tensor it launches the kernel (one launch
per tile anti-diagonal, on the current stream, no host sync between
launches) or raises; on a CPU tensor it runs the plain version,
``dense_plain.rowscan_dense``. A pair with an empty side (adjr or adjc 1)
has H = its header alone and launches nothing.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import torch

from .dense_plain import rowscan_dense
from .mlsp_cuda import alloc_headers, load_lib
from .mlsp_plain import edge_col, edge_row

LAUNCHES = 0

# The tile of the sweep, from chip_smoke.py's tile sweep at 23728^2 on an
# H100 (PERF.md): square 128-cell tiles keep up to 186 tiles in flight
# per launch where 128x512 keeps 47. The TPU tuning keys never reach it.
TILE_H, TILE_W = 128, 128


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
               gap: str) -> torch.Tensor:
    """H (adjr, adjc) int32 of the header-prefixed ``y[:adjr]`` against
    ``x[:adjc]`` (both may be padded past their true lengths)."""
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

    lib = load_lib()
    trows, tcols = -(-(adjr - 1) // TILE_H), -(-(adjc - 1) // TILE_W)
    rows_p, cols_p = trows * TILE_H, tcols * TILE_W
    yp = torch.zeros(1 + rows_p, **i32)
    xp = torch.zeros(1 + cols_p, **i32)
    yp[:adjr] = y[:adjr]
    xp[:adjc] = x[:adjc]
    hdr = alloc_headers((), rows_p, cols_p, TILE_H, TILE_W, gapo, gape, kind,
                        gap, dev)
    is_sw, affine = kind == "sw", gap == "affine"
    n_scratch = lib.mlsp_fill_scratch_words(
        subst.shape[0], TILE_H, TILE_W, tcols, int(is_sw), int(affine))
    scratch = torch.empty(n_scratch, **i32) if n_scratch else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for d in range(trows + tcols - 1):
            rc = lib.mlsp_fill_dense_diag(
                int(is_sw), int(affine), ptr(subst), subst.shape[0],
                ptr(yp), ptr(xp), gapo, gape, adjr, adjc,
                TILE_H, TILE_W, trows, tcols, d,
                ptr(hdr["hrows"]), ptr(hdr["hcols"]), ptr(hdr.get("frows")),
                ptr(hdr.get("ecols")), ptr(H), ptr(scratch), stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"dense_fill launch failed on diagonal {d}: "
                    f"cudaError {rc}"
                )
            LAUNCHES += 1
    return H
