"""Sparse (mlsp) single-pair alignment: host flow around the device fill.

Port of gpuseqalign_tpu's ``ops/pallas_kernels.py`` (``_mlsp_setup``,
``_mlsp_store``, ``align_pallas_mlsp``) and of the host half of
``ops/pallas_wavefront2.py::align_mlsp_v2``. The device fill is
``mlsp_cuda.mlsp_fill``: the CUDA kernel when the input lies on the card,
its plain PyTorch version when it lies on the CPU, and nothing else.
Outputs are converted to the reference sparse layout
(ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352).
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
    NEG_INF_I32,
    Status,
)
from ..trace.sparse import align_tile, align_tile_full, get_tile_and_elem_ij
from ..utils.device import resolve_device, synchronize
from . import mlsp_cuda

# Default tile; no tuned cache exists for the card yet.
TILE_H_DEFAULT, TILE_W_DEFAULT = 128, 512


def _mlsp_setup(pr: AlgParams, nw: AlgInput):
    tile_h = int(pr.get("tileBy", 0) or TILE_H_DEFAULT)
    tile_w = int(pr.get("tileBx", 0) or TILE_W_DEFAULT)
    if tile_h < 1 or tile_w < 1:
        return None
    rows = nw.adjrows - 1
    cols = nw.adjcols - 1
    trows = max(1, -(-rows // tile_h))
    tcols = max(1, -(-cols // tile_w))
    return tile_h, tile_w, trows, tcols


def _mlsp_store(nw: AlgInput, res: AlgResult, hrows: np.ndarray,
                hcols: np.ndarray, tile_h: int, tile_w: int,
                trows: int, tcols: int,
                frows: "np.ndarray | None" = None,
                ecols: "np.ndarray | None" = None,
                best: "np.ndarray | None" = None) -> Status:
    """Convert fill outputs to the reference sparse layout
    (ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352) and recompute the last
    tile on host for align_cost (ref: ...gpu7...cu:619-622).

    frows/ecols carry the affine extension's F-top-row / E-left-col headers
    (same indexing as hrows/hcols); best is SW's (value, i, j) argmax.
    """
    nw.tile_hdr_mat_rows = trows
    nw.tile_hdr_mat_cols = tcols
    nw.tile_hrow_len = 1 + tile_w
    nw.tile_hcol_len = 1 + tile_h

    n_tiles = trows * tcols
    affine = frows is not None

    # hrows[it] = padded row it*tile_h (width >= 1 + tcols*tile_w), and
    # tile (it, jt)'s top row is its tile_w + 1 values from jt*tile_w: a
    # strided window view, copied once into the tile-major mat.
    # hcols[it, r, jt] = H[it*tile_h + 1 + r, jt*tile_w].
    def tile_rows(rows):
        win = np.lib.stride_tricks.sliding_window_view(
            rows[:trows, :tcols * tile_w + 1], tile_w + 1, axis=1)
        mat = np.empty((trows, tcols, tile_w + 1), dtype=np.int32)
        mat[...] = win[:, ::tile_w]
        return mat.reshape(n_tiles, tile_w + 1)

    def tile_cols(first, cols):
        mat = np.empty((n_tiles, 1 + tile_h), dtype=np.int32)
        mat[:, 0] = first
        mat[:, 1:] = np.swapaxes(cols[:trows, :, :tcols], 1, 2).reshape(
            n_tiles, tile_h)
        return mat

    nw.tileHrowMat = tile_rows(hrows)
    nw.tileHcolMat = tile_cols(nw.tileHrowMat[:, 0], hcols)
    if affine:
        nw.tileFrowMat = tile_rows(frows)
        # E of a tile's top-left corner belongs to the header row above it;
        # it is never read by the within-tile recompute (row 0 is given),
        # so the corner element only needs a consistent value.
        nw.tileEcolMat = tile_cols(np.int32(NEG_INF_I32), ecols)
    res.update_peak_mem(nw)

    if best is not None:
        res.align_cost = int(best[0])
        nw.best_i = int(best[1])
        nw.best_j = int(best[2])
        return Status.success

    # align_cost: host recompute of the bottom-right tile.
    co = get_tile_and_elem_ij(nw, nw.adjrows - 1, nw.adjcols - 1)
    if nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR:
        tile = np.zeros((nw.tile_hcol_len, nw.tile_hrow_len), dtype=np.int32)
        align_tile(tile, nw, co)
        res.align_cost = int(tile[co.i_elem, co.j_elem])
    else:
        mats = align_tile_full(nw, co)
        res.align_cost = int(mats["H"][co.i_elem, co.j_elem])
    return Status.success


def align_mlsp(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
    """Sparse tile-header fill for any spec (NW/SW x linear/affine), on
    ``nw.device``.

    O(rows/tile_h * cols + rows * cols/tile_w) memory instead of
    O(rows*cols). NW linear-gap is the reference's mlsp surface; the other
    specs carry the extra (F-row, E-col) affine headers / SW argmax in the
    same layout. The TPU tuning keys (kChains, winW, packedx, packedef,
    rematHdr, noBc, subProw) are accepted and ignored.
    """
    setup = _mlsp_setup(pr, nw)
    if setup is None:
        return Status.errorInvalidValue
    tile_h, tile_w, trows, tcols = setup
    spec = nw.spec
    if spec.gap == GapKind.AFFINE and (nw.gapo_cost > 0 or nw.gape_cost > 0):
        return Status.errorInvalidValue  # the fill's Gotoh needs costs <= 0
    dev = resolve_device(nw.device)

    sw = res.sw_align
    sw.start()
    y = np.zeros(1 + trows * tile_h, np.int32)
    x = np.zeros(1 + tcols * tile_w, np.int32)
    y[: nw.adjrows] = nw.seqY
    x[: nw.adjcols] = nw.seqX
    sw.lap("align.alloc")

    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst)).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    x_d = torch.from_numpy(x).to(dev)
    synchronize(dev)
    sw.lap("align.cpy_dev")

    out_d = mlsp_cuda.mlsp_fill(
        subst_d, y_d, x_d, nw.gapo_cost, nw.gape_cost, nw.adjrows,
        nw.adjcols, tile_h=tile_h, tile_w=tile_w, kind=spec.kind.value,
        gap=spec.gap.value,
    )
    synchronize(dev)
    sw.lap("align.calc")
    out = {k: v.cpu().numpy() for k, v in out_d.items()}
    sw.lap("align.cpy_host")
    nw.note_device_alloc(sum(int(v.nbytes) for v in out.values()))
    return _mlsp_store(
        nw, res, out["hrows"], out["hcols"], tile_h, tile_w, trows, tcols,
        frows=out.get("frows"), ecols=out.get("ecols"),
        best=out.get("best"),
    )
