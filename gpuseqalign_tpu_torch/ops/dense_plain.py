"""Plain PyTorch dense fills: the full H matrix, any spec.

Ports of gpuseqalign_tpu's XLA dense fills (``ops/xla_kernels.py``), for
NW/SW x linear/affine, all arithmetic int32 with ``NEG_INF_I32`` as -inf:

  rowscan_dense  one step per DP row; the in-row left dependency is a
                 max-plus prefix scan (``lax.cummax`` -> ``torch.cummax``),
                 the row body ``mlsp_plain.row_step``
  diag_dense     one step per anti-diagonal over the skewed profile
                 (``ops/skew.py``); the carries are the previous two
                 diagonals (and E, F for affine)

Both take the header-prefixed ``y`` (adjr,) and ``x`` (adjc,) and return
H (adjr, adjc) with its header row and column; ``lax.scan`` becomes a
Python loop, so each runs on whatever device its tensors lie on.
``rowscan_dense`` is also the plain version of the dense-fill kernel
(``strip_fill_dense`` of ``ops/csrc/strip_fill.cu``, wrapper
``ops/dense_cuda.py``).
"""

from __future__ import annotations

import torch

from ..core.types import NEG_INF_I32
from .mlsp_plain import edge_col, edge_row, row_step
from .skew import skew_rows, unskew_rows


def rowscan_dense(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                  gapo: int, gape: int, *, kind: str, gap: str
                  ) -> torch.Tensor:
    """Fill the dense H row by row; y/x include the header element."""
    dev = y.device
    adjr, adjc = y.numel(), x.numel()
    offs = torch.arange(adjc, dtype=torch.int32, device=dev)
    goffs, geoffs = offs * gapo, offs * gape
    sx = subst[:, x.long()]  # sx[a, j] = subst[a, x[j]]
    yl = y.long()
    col0 = edge_col(torch.arange(adjr, dtype=torch.int32, device=dev),
                    gapo, gape, kind, gap)
    H = torch.empty((adjr, adjc), dtype=torch.int32, device=dev)
    H[0] = edge_row(adjc, gapo, gape, kind, gap, dev)
    hprev = H[0]
    fprev = torch.full((adjc,), NEG_INF_I32, dtype=torch.int32, device=dev)
    for i in range(1, adjr):
        hprev, fprev, _ = row_step(
            hprev, fprev, sx.index_select(0, yl[i:i + 1])[0],
            col0[i:i + 1], gapo, gape, goffs, geoffs, kind=kind, gap=gap)
        H[i] = hprev
    return H


def diag_dense(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
               gapo: int, gape: int, *, kind: str, gap: str
               ) -> torch.Tensor:
    """Fill the dense H by one step per anti-diagonal.

    Diagonal d holds lanes j (columns) with cell (i = d-j, j). The skewed
    profile S[d, j] = subst[y[d-j], x[j]] makes each step's substitution
    read one contiguous row.
    """
    dev = y.device
    adjr, adjc = y.numel(), x.numel()
    is_sw = kind == "sw"
    affine = gap == "affine"
    ns = adjr + adjc - 1
    j_idx = torch.arange(adjc, dtype=torch.int32, device=dev)
    S = skew_rows(subst[y.long()][:, x.long()])  # (ns, adjc)
    ninf = torch.full((1,), NEG_INF_I32, dtype=torch.int32, device=dev)

    def shift1(v):
        return torch.cat([ninf, v[:-1]])

    def hdr_h(d):
        # Header value of H at distance d from the corner.
        if is_sw:
            return 0
        if affine:
            return 0 if d == 0 else gapo + d * gape
        return d * gapo

    out = torch.empty((ns, adjc), dtype=torch.int32, device=dev)
    v1 = v2 = e1 = f1 = ninf.expand(adjc)
    for d in range(ns):
        sh1 = shift1(v1)
        if affine:
            frow = torch.maximum(f1, v1 + gapo) + gape
            erow = torch.maximum(shift1(e1), sh1 + gapo) + gape
            cell = torch.maximum(shift1(v2) + S[d],
                                 torch.maximum(erow, frow))
        else:
            cell = torch.maximum(shift1(v2) + S[d],
                                 torch.maximum(v1, sh1) + gapo)
        if is_sw:
            cell = cell.clamp_min(0)
        # Header column (j = 0, i = d) and header row (i = 0, j = d).
        edge = (j_idx == 0) | (j_idx == d)
        cell = torch.where(edge, hdr_h(d), cell)
        valid = (j_idx <= d) & (j_idx > d - adjr)
        cell = torch.where(valid, cell, NEG_INF_I32)
        if affine:
            # E[i, 0] and F[0, j] are -inf: reset both on the edge lanes.
            interior = valid & ~edge
            f1 = torch.where(interior, frow, NEG_INF_I32)
            e1 = torch.where(interior, erow, NEG_INF_I32)
        v2, v1 = v1, cell
        out[d] = cell
    return unskew_rows(out, adjr)
