"""Sparse (mlsp) single-pair alignment: host flow around the device fill.

Port of gpuseqalign_tpu's ``ops/pallas_kernels.py`` (``_mlsp_setup``,
``_mlsp_store``, ``align_pallas_mlsp``) and of the host half of
``ops/pallas_wavefront2.py::align_mlsp_v2``. The device fill is
``mlsp_cuda.mlsp_fill``: the CUDA kernel when the input lies on the card,
its plain PyTorch version when it lies on the CPU, and nothing else.
Outputs are converted to the reference sparse layout
(ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352).

``align_mlsp``'s host flow is tiled by profiler spans (``utils.spans``:
open only while a profiler records), in order:
``align.setup`` (the tile, with the tuned cache's read), ``align.alloc``,
``align.cpy_dev``, ``align.calc``, ``align.cpy_host`` (each also the
stopwatch lap of its name; ``align.cpy_host`` lays the headers out
tile-major where the fill left them and brings them to the host,
``tile_headers``) and ``align.store``, which holds ``align.store.headers``
(the host arrays attached to the input) and ``align.store.last_tile`` (the
last tile's recompute for the cost).

``PINNED_COPIES`` counts the aligns whose headers came back from the card
through pinned host memory, so a run can show that the copy engaged.
"""

from __future__ import annotations

import math
from typing import Dict

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
from ..utils.spans import span
from . import mlsp_cuda, tuned

# Default tile where the card's tuned cache (``ops/tuned.py``) has none,
# and always on the CPU.
TILE_H_DEFAULT, TILE_W_DEFAULT = 128, 512

PINNED_COPIES = 0


def _mlsp_setup(pr: AlgParams, nw: AlgInput):
    tile_h_def, tile_w_def = tuned.tuned_tile(
        nw.spec.name, nw.device, (TILE_H_DEFAULT, TILE_W_DEFAULT))
    tile_h = int(pr.get("tileBy", 0) or tile_h_def)
    tile_w = int(pr.get("tileBx", 0) or tile_w_def)
    if tile_h < 1 or tile_w < 1:
        return None
    rows = nw.adjrows - 1
    cols = nw.adjcols - 1
    trows = max(1, -(-rows // tile_h))
    tcols = max(1, -(-cols // tile_w))
    return tile_h, tile_w, trows, tcols


def tile_headers(hrows, hcols, tile_h: int, tile_w: int, trows: int,
                 tcols: int, frows=None, ecols=None, best=None
                 ) -> Dict[str, np.ndarray]:
    """The fill's headers in the reference sparse layout
    (ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352), as host arrays under
    ``AlgInput``'s names: ``tileHrowMat``, ``tileHcolMat`` and, with
    frows/ecols, ``tileFrowMat``, ``tileEcolMat``; and SW's ``best``
    (value, i, j) when given.

    The inputs are tensors on one device, or numpy arrays: hrows[it] =
    padded row it*tile_h (width >= 1 + tcols*tile_w), hcols[it, r, jt] =
    H[it*tile_h + 1 + r, jt*tile_w]; frows/ecols the same for F and E.
    The matrices are laid out where the inputs lie, in one flat buffer.
    From the card that buffer comes back in one copy into pinned memory of
    torch's caching host allocator: the block goes back to the allocator
    when the last of the arrays is dropped, so no two calls share one.
    """
    global PINNED_COPIES
    src = {k: torch.as_tensor(v) for k, v in (
        ("hrows", hrows), ("hcols", hcols), ("frows", frows),
        ("ecols", ecols), ("best", best)) if v is not None}
    n_tiles = trows * tcols
    shapes = {"tileHrowMat": (n_tiles, 1 + tile_w),
              "tileHcolMat": (n_tiles, 1 + tile_h)}
    if "frows" in src:
        shapes["tileFrowMat"] = (n_tiles, 1 + tile_w)
        shapes["tileEcolMat"] = (n_tiles, 1 + tile_h)
    if "best" in src:
        shapes["best"] = (3,)
    sizes = [math.prod(shape) for shape in shapes.values()]

    def views(flat):
        return {k: part.view(shape) for (k, shape), part
                in zip(shapes.items(), flat.split(sizes))}

    dev = src["hrows"].device
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    mats = views(buf)

    def tile_rows(dst, rows):
        # tile (it, jt)'s top row: the tile_w + 1 values from jt*tile_w.
        dst.view(trows, tcols, 1 + tile_w).copy_(
            rows[:trows, :tcols * tile_w + 1].unfold(1, tile_w + 1, tile_w))

    def tile_cols(dst, corner, cols):
        dst = dst.view(trows, tcols, 1 + tile_h)
        dst[:, :, 0] = corner
        dst[:, :, 1:].copy_(cols[:trows, :, :tcols].transpose(1, 2))

    tile_rows(mats["tileHrowMat"], src["hrows"])
    tile_cols(mats["tileHcolMat"],
              src["hrows"][:trows, :tcols * tile_w:tile_w], src["hcols"])
    if "frows" in src:
        tile_rows(mats["tileFrowMat"], src["frows"])
        # E of a tile's top-left corner belongs to the header row above
        # it; it is never read by the within-tile recompute (row 0 is
        # given), so the corner element only needs a consistent value.
        tile_cols(mats["tileEcolMat"], NEG_INF_I32, src["ecols"])
    if "best" in src:
        mats["best"].copy_(src["best"])
    if dev.type == "cuda":
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        synchronize(dev)
        PINNED_COPIES += 1
        mats = views(host)
    return {k: v.numpy() for k, v in mats.items()}


def _mlsp_store(nw: AlgInput, res: AlgResult, mats: Dict[str, np.ndarray],
                tile_h: int, tile_w: int, trows: int, tcols: int) -> Status:
    """Attach the tile-major headers (``tile_headers``' host arrays) to
    ``nw`` (ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352) and recompute
    the last tile on host for align_cost (ref: ...gpu7...cu:619-622); SW
    takes its cost and best cell from ``mats["best"]``.
    """
    nw.tile_hdr_mat_rows = trows
    nw.tile_hdr_mat_cols = tcols
    nw.tile_hrow_len = 1 + tile_w
    nw.tile_hcol_len = 1 + tile_h

    with span("align.store.headers"):
        nw.tileHrowMat = mats["tileHrowMat"]
        nw.tileHcolMat = mats["tileHcolMat"]
        nw.tileFrowMat = mats.get("tileFrowMat")
        nw.tileEcolMat = mats.get("tileEcolMat")
    res.update_peak_mem(nw)

    best = mats.get("best")
    if best is not None:
        res.align_cost = int(best[0])
        nw.best_i = int(best[1])
        nw.best_j = int(best[2])
        return Status.success

    # align_cost: host recompute of the bottom-right tile.
    with span("align.store.last_tile"):
        co = get_tile_and_elem_ij(nw, nw.adjrows - 1, nw.adjcols - 1)
        if nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR:
            tile = np.zeros((nw.tile_hcol_len, nw.tile_hrow_len),
                            dtype=np.int32)
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
    with span("align.setup"):
        setup = _mlsp_setup(pr, nw)
        if setup is None:
            return Status.errorInvalidValue
        tile_h, tile_w, trows, tcols = setup
        spec = nw.spec
        if spec.gap == GapKind.AFFINE and (nw.gapo_cost > 0
                                           or nw.gape_cost > 0):
            # the fill's Gotoh needs costs <= 0
            return Status.errorInvalidValue
        dev = resolve_device(nw.device)

    sw = res.sw_align
    sw.start()
    with sw.phase("align.alloc"):
        y = np.zeros(1 + trows * tile_h, np.int32)
        x = np.zeros(1 + tcols * tile_w, np.int32)
        y[: nw.adjrows] = nw.seqY
        x[: nw.adjcols] = nw.seqX

    with sw.phase("align.cpy_dev"):
        subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst)).to(dev)
        y_d = torch.from_numpy(y).to(dev)
        x_d = torch.from_numpy(x).to(dev)
        synchronize(dev)

    with sw.phase("align.calc"):
        out_d = mlsp_cuda.mlsp_fill(
            subst_d, y_d, x_d, nw.gapo_cost, nw.gape_cost, nw.adjrows,
            nw.adjcols, tile_h=tile_h, tile_w=tile_w, kind=spec.kind.value,
            gap=spec.gap.value,
        )
        synchronize(dev)
    with sw.phase("align.cpy_host"):
        mats = tile_headers(
            out_d["hrows"], out_d["hcols"], tile_h, tile_w, trows, tcols,
            frows=out_d.get("frows"), ecols=out_d.get("ecols"),
            best=out_d.get("best"))
    with span("align.store"):
        # The card holds the fill's outputs and their tile-major copy.
        nw.note_device_alloc(sum(int(v.nbytes) for v in out_d.values())
                             + sum(int(v.nbytes) for v in mats.values()))
        return _mlsp_store(nw, res, mats, tile_h, tile_w, trows, tcols)
