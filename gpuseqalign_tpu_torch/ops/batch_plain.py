"""Plain PyTorch versions of the batch engine's two device fills.

``scores_batch_plain`` is a port of gpuseqalign_tpu's vmapped XLA row-scan
(``parallel/batch.py::_scores_single`` / ``scores_batch``) that works on a
whole stacked bucket at once: the ``(B, 1+cols_p)`` rows are one tensor,
``lax.cummax`` becomes ``torch.cummax(dim=1)`` and ``lax.scan`` a Python
loop over rows. It is the plain version of the tiny-pair kernel
(``ops/csrc/mlsp_tiny.cu``) and of the batched tile fill's cost and best.

``mlsp_fill_batch_plain`` is the plain version of the batched fill
(``strip_fill_batch`` of ``ops/csrc/strip_fill.cu``): ``mlsp_fill_plain``
run pair by pair, with the cost captured.

Both run on whatever device their tensors lie on; every output is int32.
Like the kernels, both take ``ys`` (B, 1+rows_p) with ``adjrs`` (B,), or
one query (1, 1+rows_p) with ``adjrs`` (1,) that every pair reads.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.types import NEG_INF_I32
from .mlsp_plain import edge_col, edge_row, mlsp_fill_plain, row_step


def scores_batch_plain(subst: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor, adjrs: torch.Tensor,
                       adjcs: torch.Tensor, gapo: int, gape: int, *,
                       kind: str, gap: str
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cost-only alignment of a stacked bucket.

    ys: (B, 1+rows_p), or one query (1, 1+rows_p) for every pair; xs:
    (B, 1+cols_p); zero-padded, header-prefixed. adjrs (as ys's rows) and
    adjcs (B,): true lengths with the header. Returns (costs,
    best_i, best_j), each (B,) int32: NW the cost at (adjr-1, adjc-1) and
    best 0; SW the row-major first maximum over live cells (i < adjr,
    j < adjc), (0, 0, 0) if no cell is > 0.
    """
    dev = ys.device
    n, rows_p = xs.shape[0], ys.shape[1] - 1
    width = xs.shape[1]
    is_sw = kind == "sw"
    i32 = dict(dtype=torch.int32, device=dev)

    offs = torch.arange(width, **i32)
    goffs = offs * gapo
    geoffs = offs * gape
    flat = subst.reshape(-1)
    S = subst.shape[0]
    xl = xs.long()
    yl = ys.long() * S
    adjr = adjrs.long().expand(n)
    adjc_1 = (adjcs.long() - 1).view(n, 1)
    lane_valid = offs.view(1, width) < adjcs.view(n, 1)
    col0 = edge_col(torch.arange(rows_p + 1, **i32), gapo, gape, kind, gap)

    hprev = edge_row(width, gapo, gape, kind, gap, dev).expand(n, width)
    fprev = torch.full((n, width), NEG_INF_I32, **i32)
    cost = hprev.gather(1, adjc_1).view(n)
    bval = torch.zeros(n, **i32)
    bi = torch.zeros(n, **i32)
    bj = torch.zeros(n, **i32)
    for i in range(1, rows_p + 1):
        hrow, fprev, _ = row_step(
            hprev, fprev, flat[yl[:, i:i + 1] + xl], col0[i].expand(n, 1),
            gapo, gape, goffs, geoffs, kind=kind, gap=gap)
        at = adjr == i + 1
        cost = torch.where(at, hrow.gather(1, adjc_1).view(n), cost)
        if is_sw:
            masked = torch.where(lane_valid, hrow, 0)
            rmax, rj = masked.amax(1), masked.argmax(1)
            upd = (i < adjr) & (rmax > bval)
            bval = torch.where(upd, rmax, bval)
            bi = torch.where(upd, i, bi)
            bj = torch.where(upd, rj.to(torch.int32), bj)
        hprev = hrow
    if is_sw:
        return bval, bi, bj
    return cost, torch.zeros_like(cost), torch.zeros_like(cost)


def mlsp_fill_batch_plain(subst: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor, gapo: int, gape: int,
                          adjrs: torch.Tensor, adjcs: torch.Tensor, *,
                          tile_h: int, tile_w: int, kind: str, gap: str
                          ) -> Dict[str, torch.Tensor]:
    """``mlsp_fill_plain`` over the pairs of a stacked bucket, outputs
    stacked on a leading pair axis, plus ``cost`` (B,): NW the cell
    (adjr-1, adjc-1), SW the best value (``best`` (B, 3)). ``ys`` and
    ``adjrs`` may hold one query for every pair, as in
    ``scores_batch_plain``."""
    n = xs.shape[0]
    ys, adjrs = ys.expand(n, -1), adjrs.expand(n)
    outs = []
    for b, (r, c) in enumerate(zip(adjrs.tolist(), adjcs.tolist())):
        outs.append(mlsp_fill_plain(subst, ys[b], xs[b], gapo, gape, r, c,
                                    tile_h=tile_h, tile_w=tile_w, kind=kind,
                                    gap=gap, capture_cost=True))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
