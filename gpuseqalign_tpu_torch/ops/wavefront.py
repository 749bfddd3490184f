"""NW linear-gap row-block wavefront fills (the v1 path): entry points and
host flows.

Port of gpuseqalign_tpu's ``ops/pallas_wavefront.py``: the pre-skewed
profile (``_build_pskew``), the two fills with the JAX signatures and
return shapes (``mlsp_nw_lg``: the tile headers, K2; ``dense_nw_lg``: the
full H, K4) and the host flows around them (``align_mlsp``,
``align_dense``), which run on ``nw.device``. The fills go through
``wavefront_cuda``: the CUDA kernels of ``ops/csrc/wavefront.cu`` on the
card, their plain versions (``wavefront_plain``) on the CPU.

No registry name reaches this path, in the port as in the JAX package;
``align_mlsp`` with its tile left out takes the tile from the parameters
as the registry's sparse names do, so it can stand in a registry bundle.
Departures from the JAX flows: a spec other than nw_lg gets
``Status.errorInvalidValue`` (the JAX flows fill NW-linear H whatever
the spec), as do a sparse tile that ``mlsp_params_ok`` refuses and a row
block above the largest the wrappers take (``wavefront_cuda.MAX_R``).
``res.shmem_peak_allocs`` stays 0: the row-strip kernel uses no shared
memory (its state is in registers, its carry in device memory), and the
TPU's VMEM count (``_v1_vmem_bytes``) has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import (
    AlgInput,
    AlgParams,
    AlgResult,
    AlignKind,
    GapKind,
    Status,
)
from ..utils.device import resolve_device, synchronize
from . import wavefront_cuda
from .dense_kernels import _finish_dense_from_device
from .mlsp_kernels import _mlsp_setup, _mlsp_store, tile_headers
from .skew import skew_rows, unskew_cols


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _build_pskew(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                 B: int, R: int, NSpad: int) -> torch.Tensor:
    """Pskew[b, c, r] = P[b*R + r, c - r] for P = subst[y[1:]][:, x[1:]]
    (0 where c - r lies outside the columns), as (B, NSpad, R//128, 128)
    int32 on the device of ``y``: each row block's P^T skewed, padded to
    NSpad steps. One block at a time, to keep the peak near the output."""
    cols_p = x.numel() - 1
    NS = R + cols_p - 1
    sub_x = subst[:, x[1:].long()]  # sub_x[a, u] = subst[a, x[u+1]]
    out = torch.empty((B, NSpad, R), dtype=torch.int32, device=y.device)
    out[:, NS:] = 0
    for b in range(B):
        P = sub_x[y[1 + b * R:1 + (b + 1) * R].long()]
        out[b, :NS] = skew_rows(P.t())
    return out.view(B, NSpad, R // 128, 128)


def _shapes(y: torch.Tensor, x: torch.Tensor, R: int, W: int):
    rows_p, cols_p = y.numel() - 1, x.numel() - 1
    return rows_p // R, cols_p, wavefront_cuda.nspad_of(R, cols_p, W)


def mlsp_nw_lg(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
               gapo: int, *, R: int, W: int, TW: int):
    """Sparse fill: (hrow, hcol) of the header-prefixed ``y`` against
    ``x``, padded so rows_p % R == 0 and cols_p % TW == 0 (TW % W == 0,
    TW >= R).

    hrow (B, NSpad+128): row (b+1)*R of H by column (NEG_INF_I32 past
    cols_p); hcol (B, CT, R//128, 128): hcol[b, k] = H[b*R+1 .. (b+1)*R,
    k*TW] for k >= 1 (``wavefront_plain`` has the whole contract)."""
    B, cols_p, NSpad = _shapes(y, x, R, W)
    pskew = _build_pskew(subst, y, x, B, R, NSpad)
    return wavefront_cuda.mlsp_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W,
                                          TW=TW)


def dense_nw_lg(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                gapo: int, *, R: int, W: int) -> torch.Tensor:
    """Full dense H (rows_p+1, cols_p+1) of the header-prefixed ``y``
    against ``x``, padded so rows_p % R == 0 and cols_p % 128 == 0: the
    wavefront history unskewed a row block at a time, with the analytic
    top row and left column."""
    B, cols_p, NSpad = _shapes(y, x, R, W)
    pskew = _build_pskew(subst, y, x, B, R, NSpad)
    vhist = wavefront_cuda.dense_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W)
    del pskew
    i32 = dict(dtype=torch.int32, device=y.device)
    H = torch.empty((B * R + 1, cols_p + 1), **i32)
    H[0] = torch.arange(cols_p + 1, **i32) * gapo
    H[1:, 0] = torch.arange(1, B * R + 1, **i32) * gapo
    V = vhist.view(B, NSpad, R)
    for b in range(B):
        H[1 + b * R:1 + (b + 1) * R, 1:] = unskew_cols(V[b], cols_p)
    return H


def _choose_r(rows: int, tile_by: int) -> int:
    if tile_by and tile_by % 128 == 0:
        return tile_by
    return min(1024, max(128, _cdiv(rows, 128) * 128))


def mlsp_params_ok(tile_h: int, tile_w: int) -> bool:
    return (
        tile_h % 128 == 0
        and tile_w % 128 == 0
        and tile_w >= tile_h
        and tile_w % min(512, tile_w) == 0
    )


def _is_nw_lg(nw: AlgInput) -> bool:
    return nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR


def _inputs(nw: AlgInput, res: AlgResult, rows_p: int, cols_p: int,
            dev: torch.device):
    """The matrix and the zero-padded sequences on ``dev``, under the
    align.alloc and align.cpy_dev laps."""
    sw = res.sw_align
    sw.start()
    y = np.zeros(1 + rows_p, np.int32)
    x = np.zeros(1 + cols_p, np.int32)
    y[: nw.adjrows] = nw.seqY
    x[: nw.adjcols] = nw.seqX
    sw.lap("align.alloc")
    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst)).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    x_d = torch.from_numpy(x).to(dev)
    synchronize(dev)
    sw.lap("align.cpy_dev")
    return subst_d, y_d, x_d


def align_dense(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
    """The dense v1 flow: rows padded to R (``_choose_r``, from tileBy) and
    columns to 128, ``dense_nw_lg``, then the H window to the host for the
    plain trace and hash, on ``nw.device``. nw_lg only."""
    if not _is_nw_lg(nw):
        return Status.errorInvalidValue
    rows = nw.adjrows - 1
    cols = nw.adjcols - 1
    R = _choose_r(rows, int(pr.get("tileBy", 0) or 0))
    if not 128 <= R <= wavefront_cuda.MAX_R:
        return Status.errorInvalidValue
    dev = resolve_device(nw.device)
    rows_p = _cdiv(max(rows, 1), R) * R
    cols_p = _cdiv(max(cols, 1), 128) * 128
    subst_d, y_d, x_d = _inputs(nw, res, rows_p, cols_p, dev)

    H_dev = dense_nw_lg(subst_d, y_d, x_d, nw.gapo_cost, R=R, W=256)
    synchronize(dev)
    res.sw_align.lap("align.calc")
    return _finish_dense_from_device(nw, res, H_dev)


def align_mlsp(pr: AlgParams, nw: AlgInput, res: AlgResult,
               tile_h: "int | None" = None, tile_w: "int | None" = None,
               trows: "int | None" = None, tcols: "int | None" = None
               ) -> Status:
    """The sparse v1 flow: ``mlsp_nw_lg`` at tile tile_h x tile_w (R = tile
    height, TW = tile width, W = min(512, TW)), its outputs to the host and
    into the reference sparse layout (``_mlsp_store``), on ``nw.device``.
    nw_lg only, and tiles that ``mlsp_params_ok`` takes. With the tile left
    out it comes from ``pr`` (tileBy x tileBx, 128x512 by default)."""
    if tile_h is None:
        setup = _mlsp_setup(pr, nw)
        if setup is None:
            return Status.errorInvalidValue
        tile_h, tile_w, trows, tcols = setup
    if (not _is_nw_lg(nw) or not mlsp_params_ok(tile_h, tile_w)
            or tile_h > wavefront_cuda.MAX_R):
        return Status.errorInvalidValue
    dev = resolve_device(nw.device)
    R, TW = tile_h, tile_w
    rows_p, cols_p = trows * R, tcols * TW
    subst_d, y_d, x_d = _inputs(nw, res, rows_p, cols_p, dev)

    hrow_d, hcol_d = mlsp_nw_lg(subst_d, y_d, x_d, nw.gapo_cost, R=R,
                                W=min(512, TW), TW=TW)
    synchronize(dev)
    sw = res.sw_align
    sw.lap("align.calc")
    hrow = hrow_d.cpu().numpy()
    hcol = hcol_d.cpu().numpy()
    sw.lap("align.cpy_host")
    nw.note_device_alloc(int(hrow.nbytes + hcol.nbytes))

    # The generic (hrows, hcols) form of tile_headers: hrows[it] = row
    # it*R; hcols[it, r, jt] = H[it*R + 1 + r, jt*TW].
    g = nw.gapo_cost
    width = cols_p + 1
    hrows = np.empty((trows, width), dtype=np.int32)
    hrows[0] = (np.arange(width, dtype=np.int64) * g).astype(np.int32)
    hrows[1:] = hrow[: trows - 1, :width]
    hcols = np.empty((trows, R, tcols), dtype=np.int32)
    hcols[:, :, 0] = (np.arange(1, rows_p + 1, dtype=np.int64) * g
                      ).astype(np.int32).reshape(trows, R)
    # hcol[b, jt] holds column jt*TW for jt >= 1.
    hc = hcol.reshape(trows, -1, R)
    hcols[:, :, 1:] = np.transpose(hc[:, 1:tcols, :], (0, 2, 1))
    return _mlsp_store(
        nw, res, tile_headers(hrows, hcols, tile_h, tile_w, trows, tcols),
        tile_h, tile_w, trows, tcols)
