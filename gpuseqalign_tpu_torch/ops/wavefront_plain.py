"""Plain PyTorch versions of the row-block wavefront fills (K2, K4).

gpuseqalign_tpu's ``ops/pallas_wavefront.py`` fills NW linear gap in
blocks of R DP rows, each block swept anti-diagonally with one lane a
row: at step c, lane r holds cell (b*R + r + 1, c - r + 1) and reads the
pre-skewed profile ``pskew[b, c, r]`` = subst[y[b*R+r+1], x[c-r+1]].
``pallas_mlsp_nw_lg`` (K2) keeps only tile headers, ``pallas_dense_nw_lg``
(K4) the whole wavefront history. The CUDA kernels
(``ops/csrc/wavefront.cu``, wrappers ``ops/wavefront_cuda.py``) sweep the
same way; the functions here take the kernels' inputs (``pskew``, the
gap cost and the static shapes) and return their outputs, but compute by
rows: the profile is unskewed back from ``pskew``, each DP row is one
``mlsp_plain.row_step`` (the max-plus prefix scan), and the rows are then
laid out in the kernels' format. They run on whatever device ``pskew``
lies on.

Output contract, shared with the kernels, for ``pskew`` (B, NSpad, SUB,
128), R = SUB*128 and the padded width cols_p (every element is defined;
the TPU kernel leaves the ones marked * as scratch, here NEG_INF_I32):

  hrow   (B, NSpad+128)       H[(b+1)*R, j] for j <= cols_p, NEG_INF_I32*
                              beyond
  hcol   (B, CT, SUB, 128)    hcol[b, k] = H[b*R+1 .. (b+1)*R, k*TW] for
                              1 <= k and k*TW <= cols_p; NEG_INF_I32 for
                              k = 0 and* past cols_p; CT = ceil((NSpad/W)
                              / (TW/W)), the TPU's output blocks
  vhist  (B, NSpad, SUB, 128) vhist[b, c, r] = H[b*R+r+1, c-r+1] where
                              0 <= c-r < cols_p, NEG_INF_I32 elsewhere
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ..core.types import NEG_INF_I32
from .mlsp_plain import row_step
from .skew import skew_rows, unskew_cols


def _h_blocks(pskew: torch.Tensor, gapo: int, cols_p: int
              ) -> Iterator[torch.Tensor]:
    """Yield, for each row block b, H rows b*R+1 .. (b+1)*R over columns
    0..cols_p (R, cols_p+1), filled row by row from the profile that
    ``pskew`` holds."""
    B, NSpad, SUB, lanes = pskew.shape
    R = SUB * lanes
    dev = pskew.device
    i32 = dict(dtype=torch.int32, device=dev)
    width = cols_p + 1
    goffs = torch.arange(width, **i32) * gapo
    col0 = torch.arange(B * R + 1, **i32) * gapo
    srow = torch.zeros(width, **i32)
    hprev = goffs  # H row 0
    for b in range(B):
        # P[r, u] = pskew[b, u + r, r] = subst[y[b*R+r+1], x[u+1]]
        P = unskew_cols(pskew[b].reshape(NSpad, R), cols_p)
        rows = torch.empty((R, width), **i32)
        for r in range(R):
            i = b * R + r + 1
            srow[1:] = P[r]
            hprev, _, _ = row_step(hprev, hprev, srow, col0[i:i + 1], gapo,
                                   0, goffs, goffs, kind="nw", gap="linear")
            rows[r] = hprev
        yield rows


def mlsp_nw_lg_plain(pskew: torch.Tensor, gapo: int, *, cols_p: int,
                     W: int, TW: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's outputs (hrow, hcol) from its inputs; see the module
    docstring."""
    B, NSpad, SUB, lanes = pskew.shape
    R = SUB * lanes
    ct = -(-(NSpad // W) // (TW // W))
    hrow = torch.full((B, NSpad + 128), NEG_INF_I32, dtype=torch.int32,
                      device=pskew.device)
    hcol = torch.full((B, ct, R), NEG_INF_I32, dtype=torch.int32,
                      device=pskew.device)
    ks = torch.arange(1, cols_p // TW + 1, device=pskew.device)
    for b, rows in enumerate(_h_blocks(pskew, gapo, cols_p)):
        hrow[b, :cols_p + 1] = rows[-1]
        hcol[b, ks] = rows[:, ks * TW].t()
    return hrow, hcol.view(B, ct, SUB, lanes)


def dense_nw_lg_plain(pskew: torch.Tensor, gapo: int, *, cols_p: int
                      ) -> torch.Tensor:
    """K4's output, the wavefront history vhist; see the module
    docstring."""
    B, NSpad, SUB, lanes = pskew.shape
    R = SUB * lanes
    NS = R + cols_p - 1
    dev = pskew.device
    c = torch.arange(NS, device=dev).view(-1, 1)
    u = c - torch.arange(R, device=dev).view(1, -1)
    live = (u >= 0) & (u < cols_p)
    vhist = torch.full((B, NSpad, R), NEG_INF_I32, dtype=torch.int32,
                       device=dev)
    for b, rows in enumerate(_h_blocks(pskew, gapo, cols_p)):
        # skew_rows(A^T)[c, r] = A[r, c - r] for A = rows[:, 1:]
        skewed = skew_rows(rows[:, 1:].t())
        vhist[b, :NS] = torch.where(live, skewed, NEG_INF_I32)
    return vhist.view(B, NSpad, SUB, lanes)
