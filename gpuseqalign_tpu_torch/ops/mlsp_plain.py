"""Plain PyTorch version of the sparse (mlsp) tile-header fill.

A row-by-row port of gpuseqalign_tpu's XLA row-scan fill
(``ops/xla_kernels.py::rowscan_mlsp`` and ``rowscan_mlsp_full``), all four
specs in one function: each DP row is one vector step, and the in-row left
dependency is solved with a max-plus prefix scan,
    H[j] = max(cand[j], H[j-1] + g) == cummax(cand[k] - k*g)[j] + j*g
(``lax.cummax`` -> ``torch.cummax``; ``lax.scan`` -> a Python loop over
rows). The CUDA kernel (``strip_fill_pair`` of ``ops/csrc/strip_fill.cu``)
computes the same outputs cell by cell; this function is its reference on the CPU tests and
on the card, and it runs on whatever device its tensors lie on. The row
body, ``row_step``, is shared with the batch and dense plain fills
(``ops/batch_plain.py``, ``ops/dense_plain.py``).

Output contract, shared with the kernel (``ops/mlsp_cuda.py``), for
``rows_p = trows*tile_h`` and ``cols_p = tcols*tile_w`` padded DP sizes:

  hrows  (trows, 1+cols_p)       H row it*tile_h (row 0 is the header row)
  hcols  (trows, tile_h, tcols)  H[it*tile_h + 1 + r, jt*tile_w]
  frows  (trows, 1+cols_p)       affine only: F row it*tile_h
  ecols  (trows, tile_h, tcols)  affine only: E at the same cells as hcols
  best   (3,)                    SW only: [value, i, j] of the row-major
                                 first maximum over live cells
                                 (i < adjr, j < adjc); (0, 0, 0) if no
                                 cell is > 0
  cost   ()                      only with capture_cost: NW the cell
                                 (adjr-1, adjc-1), SW best[0]

Padded cells are computed with pad letter 0 through the same recurrence,
so the padded region of the headers is part of the contract.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.types import NEG_INF_I32


def edge_row(width: int, gapo: int, gape: int, kind: str, gap: str,
             device: torch.device) -> torch.Tensor:
    """H row 0 over ``width`` columns (header column included)."""
    j = torch.arange(width, dtype=torch.int32, device=device)
    if kind == "sw":
        return torch.zeros_like(j)
    if gap == "affine":
        row = gapo + j * gape
        row[0] = 0
        return row
    return j * gapo


def edge_col(i: torch.Tensor, gapo: int, gape: int, kind: str,
             gap: str) -> torch.Tensor:
    """H[i, 0] for DP rows ``i >= 1`` (int32 tensor of row indices)."""
    if kind == "sw":
        return torch.zeros_like(i)
    if gap == "affine":
        return gapo + i * gape
    return i * gapo


def row_step(hprev: torch.Tensor, fprev: torch.Tensor, srow: torch.Tensor,
             first: torch.Tensor, gapo: int, gape: int, goffs: torch.Tensor,
             geoffs: torch.Tensor, *, kind: str, gap: str,
             efirst: "torch.Tensor | None" = None):
    """DP row i from row i-1 along the last dimension (any leading batch
    shape), the one row body of every plain fill of the port.

    ``hprev``/``fprev`` are H and F of row i-1 (``fprev`` is unused for a
    linear gap), ``srow`` is subst[y_i, x_j] for every column j, ``first``
    is H[i, 0] with a trailing dimension of 1, and ``goffs``/``geoffs`` are
    j*gapo and j*gape. Returns (H, F, E) of row i; for a linear gap F is
    ``fprev`` unchanged and E is None.

    ``efirst`` (affine only) is E[i, 0], shaped like ``first``: None means
    -inf, the matrix's own left edge; a column band passes the E of the
    band to its left (its halo), and E[i, j] = max(E[i, 0] + j*gape, the
    scan) for j >= 1.
    """
    is_sw = kind == "sw"
    if gap != "affine":
        cand = torch.maximum(hprev[..., :-1] + srow[..., 1:],
                             hprev[..., 1:] + gapo)
        if is_sw:
            cand = cand.clamp_min(0)
        a = torch.cat([first, cand], -1)
        return torch.cummax(a - goffs, -1).values + goffs, fprev, None
    frow = torch.maximum(fprev, hprev + gapo) + gape
    frow[..., 0] = NEG_INF_I32
    v = torch.maximum(hprev[..., :-1] + srow[..., 1:], frow[..., 1:])
    vfull = torch.cat([first, v.clamp_min(0) if is_sw else v], -1)
    m = torch.cummax(vfull + gapo - geoffs, -1).values
    if efirst is None:
        erow = torch.cat([torch.full_like(first, NEG_INF_I32),
                          m[..., :-1] + geoffs[1:]], -1)
    else:
        erow = torch.cat([efirst, torch.maximum(m[..., :-1], efirst)
                          + geoffs[1:]], -1)
    hrow = torch.cat([first, torch.maximum(v, erow[..., 1:])], -1)
    if is_sw:
        hrow = hrow.clamp_min(0)
    return hrow, frow, erow


def mlsp_fill_plain(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    gapo: int, gape: int, adjr: int, adjc: int, *,
                    tile_h: int, tile_w: int, kind: str, gap: str,
                    capture_cost: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Sparse fill of the zero-padded, header-prefixed ``y`` (1+rows_p,)
    against ``x`` (1+cols_p,), int32, for any spec; see the module
    docstring for the outputs."""
    dev = y.device
    rows_p = y.numel() - 1
    cols_p = x.numel() - 1
    trows = rows_p // tile_h
    tcols = cols_p // tile_w
    is_sw = kind == "sw"
    affine = gap == "affine"
    width = cols_p + 1

    offs = torch.arange(width, dtype=torch.int32, device=dev)
    goffs = offs * gapo
    geoffs = offs * gape
    sx = subst[:, x.long()]
    yl = y.long()
    col_ids = torch.arange(tcols, device=dev) * tile_w
    col0 = edge_col(torch.arange(rows_p + 1, dtype=torch.int32, device=dev),
                    gapo, gape, kind, gap)
    live_cols = offs < adjc

    hprev = edge_row(width, gapo, gape, kind, gap, dev)
    cost = hprev[adjc - 1]
    fprev = torch.full((width,), NEG_INF_I32, dtype=torch.int32, device=dev)
    hrows, frows, hcols, ecols, rmax, rarg = [], [], [], [], [], []
    for b in range(trows):
        hrows.append(hprev)
        frows.append(fprev)
        for r in range(tile_h):
            i = b * tile_h + r + 1
            hrow, fprev, erow = row_step(
                hprev, fprev, sx.index_select(0, yl[i:i + 1])[0],
                col0[i:i + 1], gapo, gape, goffs, geoffs, kind=kind, gap=gap)
            if is_sw:
                masked = torch.where(live_cols, hrow, 0)
                rmax.append(masked.max())
                rarg.append(masked.argmax())
            elif i == adjr - 1:
                cost = hrow[adjc - 1]
            hcols.append(hrow[col_ids])
            if affine:
                ecols.append(erow[col_ids])
            hprev = hrow

    out = {
        "hrows": torch.stack(hrows),
        "hcols": torch.stack(hcols).view(trows, tile_h, tcols),
    }
    if affine:
        out["frows"] = torch.stack(frows)
        out["ecols"] = torch.stack(ecols).view(trows, tile_h, tcols)
    if is_sw:
        live_rows = torch.arange(1, rows_p + 1, device=dev) < adjr
        vals = torch.where(live_rows, torch.stack(rmax), 0)
        k = vals.argmax().view(1)
        bv = vals.gather(0, k)
        bj = torch.stack(rarg).gather(0, k)
        best = torch.cat([bv, k + 1, bj]).to(torch.int32)
        out["best"] = torch.where(bv > 0, best, 0)
        cost = out["best"][0]
    if capture_cost:
        out["cost"] = cost
    return out
