"""Plain PyTorch version of the banded pass (K7), the per-band fill of the
giant-pair engine (``parallel/giant2.py``).

The semantics of gpuseqalign_tpu's ``ops/pallas_banded.py::banded_pass``:
one pass of B row blocks (``tile_h`` rows each) over one column band of
``band_cols`` columns, all four specs. Everything that is analytic at the
matrix's own edges is an input here, because a band need not touch them:

  prev_row   (1+band_cols,)  H[row0, c0 + j]: the row above the pass (the
                             previous pass's last row, or the header row)
  prevF_row  (1+band_cols,)  affine only: F likewise; F flows down, so it
                             stays inside the band
  haloH      (1+B*tile_h,)   H[row0 + r, c0]: the band's left column for
                             r = 0..B*tile_h, the top corner included
  haloE      (B*tile_h,)     affine only: E[row0 + 1 + r, c0]; E crosses
                             the band edge, so the band to the left hands
                             its right-edge E over with its H
  adjr_loc, adjc_loc         adjr - row0 and adjc - c0: the SW live mask

``y`` is (1+B*tile_h,), the pass's row letters behind one leading element
that is not read, and ``x`` is (1+band_cols,), the band's column letters
likewise. Outputs, at the same (tile_h, tile_w) tiles as ``mlsp_fill``
(``ops/mlsp_plain.py``) but one row and one column wider, so that the
pass's last row and the band's right edge (the next pass's carry and the
next band's halo) are kept:

  hrows  (B+1, 1+band_cols)     H rows row0 + b*tile_h, b = 0..B (row 0 is
                                ``prev_row``)
  hcols  (B, tile_h, 1+jtE)     H[row0 + b*tile_h + 1 + r, c0 + jl*tile_w]
                                for jl = 0..jtE = band_cols/tile_w (jl = 0
                                is ``haloH``, jl = jtE the right edge)
  frows  (B+1, 1+band_cols)     affine only: F at the rows of hrows (column
                                0 is -inf below row 0)
  ecols  (B, tile_h, 1+jtE)     affine only: E at the cells of hcols
  best   (3,)                   SW only: [value, i, j] in the pass's own
                                coordinates (i = 1..B*tile_h, j =
                                1..band_cols) of the row-major first
                                maximum over live cells (i < adjr_loc, j <
                                adjc_loc); (0, 0, 0) if no cell is > 0

``adjc_loc`` is clamped to 1+band_cols, as the TPU kernel clamps it
(``pallas_banded.py:144-154``): a band left of the pair's last column has
no cell past its own edge.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .mlsp_plain import row_step


def banded_pass_plain(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                      gapo: int, gape: int, prev_row: torch.Tensor,
                      prevF_row: Optional[torch.Tensor],
                      haloH: torch.Tensor, haloE: Optional[torch.Tensor],
                      adjr_loc: int, adjc_loc: int, *, tile_h: int,
                      tile_w: int, kind: str, gap: str
                      ) -> Dict[str, torch.Tensor]:
    """One pass over one column band, row by row; see the module
    docstring for the inputs and outputs."""
    dev = y.device
    B = (y.numel() - 1) // tile_h
    band_cols = x.numel() - 1
    jtE = band_cols // tile_w
    is_sw = kind == "sw"
    affine = gap == "affine"
    width = band_cols + 1
    adjc_loc = min(adjc_loc, band_cols + 1)

    offs = torch.arange(width, dtype=torch.int32, device=dev)
    goffs = offs * gapo
    geoffs = offs * gape
    sx = subst[:, x.long()]
    yl = y.long()
    col_ids = torch.arange(jtE + 1, device=dev) * tile_w
    # Column 0 is the halo, a cell of the band to the left.
    live_cols = (offs >= 1) & (offs < adjc_loc)

    hprev, fprev = prev_row, prevF_row if affine else None
    hrows, frows, hcols, ecols, rmax, rarg = [hprev], [fprev], [], [], [], []
    for i in range(1, B * tile_h + 1):
        hrow, fprev, erow = row_step(
            hprev, fprev, sx.index_select(0, yl[i:i + 1])[0],
            haloH[i:i + 1], gapo, gape, goffs, geoffs, kind=kind, gap=gap,
            efirst=haloE[i - 1:i] if affine else None)
        if is_sw:
            masked = torch.where(live_cols, hrow, 0)
            rmax.append(masked.max())
            rarg.append(masked.argmax())
        hcols.append(hrow[col_ids])
        if affine:
            ecols.append(erow[col_ids])
        if i % tile_h == 0:
            hrows.append(hrow)
            frows.append(fprev)
        hprev = hrow

    out = {
        "hrows": torch.stack(hrows),
        "hcols": torch.stack(hcols).view(B, tile_h, jtE + 1),
    }
    if affine:
        out["frows"] = torch.stack(frows)
        out["ecols"] = torch.stack(ecols).view(B, tile_h, jtE + 1)
    if is_sw:
        live_rows = torch.arange(1, B * tile_h + 1, device=dev) < adjr_loc
        vals = torch.where(live_rows, torch.stack(rmax), 0)
        k = vals.argmax().view(1)
        bv = vals.gather(0, k)
        bj = torch.stack(rarg).gather(0, k)
        best = torch.cat([bv, k + 1, bj]).to(torch.int32)
        out["best"] = torch.where(bv > 0, best, 0)
    return out
