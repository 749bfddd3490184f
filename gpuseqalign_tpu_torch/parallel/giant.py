"""Giant-pair alignment, the portable NW linear-gap engine.

Port of gpuseqalign_tpu's ``parallel/giant.py``: the columns of one pair
are split into one band of ``band_w`` columns per mesh entry, rows advance
in blocks of ``block_h``, and the only traffic between bands is a block's
right-edge column (block_h + 1 int32) handed to the next band. Written as
torch ops on whatever device each band's tensors lie on (the
``mlsp_plain.row_step`` row body, one DP row a step), like tpu1/tpu2; the
registry's ``tpu9_giant_mlsp`` takes ``giant2.align_giant2`` instead,
whose bands run the banded kernel.

It is kept for the callers of the JAX package's
``parallel.align_giant_mlsp``, whose layout has one tile column per band
(tiles of blockH x band width) where ``align_giant2`` has one per 128
columns: code that reads that layout (D header columns for D bands)
moves to the port unchanged. No registry name, benchmark or smoke phase
runs it.

Outputs are the mlsp sparse representation with tiles of block_h x
band_w: the per-block bottom rows and the per-band right-edge columns, so
the sparse trace and hash run unchanged. The cost captured in the fill
must equal the host recompute of the last tile, or the call returns
errorInvalidResult.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
from ..ops.mlsp_kernels import _mlsp_store
from ..ops.mlsp_plain import row_step
from .mesh import Mesh, default_mesh, synchronize_mesh


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def giant_mlsp_nw_lg(subst: torch.Tensor, y: torch.Tensor,
                     x_nohdr: torch.Tensor, gapo: int, adjr: int, adjc: int,
                     *, mesh: Mesh, block_h: int, n_blocks: int, band_w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Banded sparse fill of one pair, NW linear gap.

    y: (1+rows_p,) with its header element; x_nohdr: (cols_p,) without
    it, cols_p = D*band_w; adjr/adjc: true lengths with the header.

    Returns, on the CPU:
      hrows (n_blocks, cols_p)           H[(i+1)*block_h, 1:] per block
      hcols (n_blocks, D*(block_h+1))    each band's right-edge column per
                                         block, its top corner first
      cost                               H[adjr-1, adjc-1]
    """
    D = mesh.size
    BH, nb, Wb, g = block_h, n_blocks, band_w, gapo
    devs = mesh.devices
    i32 = dict(dtype=torch.int32)
    # Band k's letters, substitution rows and header row H[0, c0+1..c0+Wb].
    bands = []
    for k, dev in enumerate(devs):
        c0 = k * Wb
        xb = torch.cat([torch.zeros(1, **i32), x_nohdr[c0:c0 + Wb]]).to(dev)
        offs = torch.arange(Wb + 1, **i32, device=dev)
        bands.append(dict(
            dev=dev, c0=c0, sx=subst.to(dev)[:, xb.long()], y=y.to(dev),
            goffs=offs * g, top=(c0 + offs[1:]) * g))
    hrows = [[None] * D for _ in range(nb)]
    msgs = [[None] * D for _ in range(nb)]
    cost = (adjc - 1) * g if adjr == 1 else None

    # Step t runs block t - k of band k; bands go right to left within a
    # step, so band k reads band k-1's message of step t-1.
    for t in range(nb + D - 1):
        for k in reversed(range(D)):
            i = t - k
            if not 0 <= i < nb:
                continue
            b = bands[k]
            r0 = i * BH
            if k == 0:
                halo = g * torch.arange(r0, r0 + BH + 1, **i32,
                                        device=b["dev"])
            else:
                halo = msgs[i][k - 1].to(b["dev"])
            top, rights = b["top"], []
            yl = b["y"][r0:r0 + BH + 1].long()
            for rr in range(1, BH + 1):
                prev_full = torch.cat([halo[rr - 1:rr], top])
                rowf, _, _ = row_step(
                    prev_full, None, b["sx"][yl[rr]], halo[rr:rr + 1], g, 0,
                    b["goffs"], b["goffs"], kind="nw", gap="linear")
                ll = adjc - 1 - b["c0"]
                if (r0 + rr == adjr - 1 and 0 <= ll <= Wb
                        and (ll >= 1 or k == 0)):
                    cost = int(rowf[ll])
                rights.append(rowf[-1:])
                top = rowf[1:]
            msgs[i][k] = torch.cat([b["top"][-1:]] + rights)
            hrows[i][k] = top
            b["top"] = top
    synchronize_mesh(mesh)
    hrows_t = torch.stack([torch.cat([r.cpu() for r in row]) for row in hrows])
    hcols_t = torch.stack([torch.cat([m.cpu() for m in row]) for row in msgs])
    return hrows_t, hcols_t, cost


def align_giant_mlsp(pr: AlgParams, nw: AlgInput, res: AlgResult,
                     mesh: Optional[Mesh] = None) -> Status:
    """Registry-shaped align fn of the portable engine, NW linear gap only,
    over ``mesh`` (default as ``align_giant2``). Produces the reference
    mlsp layout with tiles of blockH (default 128) x band width."""
    if not (nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR):
        return Status.errorInvalidValue
    if mesh is None:
        mesh = default_mesh(nw.device)
    D = mesh.size

    sw = res.sw_align
    sw.start()
    rows = nw.adjrows - 1
    cols = nw.adjcols - 1
    BH = int(pr.get("blockH", 0) or 128)
    Wb = _pad_to(max(cols, 1), D * 128) // D
    rows_p = _pad_to(max(rows, 1), BH)
    nb = rows_p // BH
    cols_p = Wb * D

    y = np.zeros(1 + rows_p, np.int32)
    x = np.zeros(1 + cols_p, np.int32)
    y[: nw.adjrows] = nw.seqY
    x[: nw.adjcols] = nw.seqX
    sw.lap("align.alloc")

    dev0 = mesh.devices[0]
    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst, np.int32)).to(
        dev0)
    y_d = torch.from_numpy(y).to(dev0)
    x_d = torch.from_numpy(x[1:]).to(dev0)
    synchronize_mesh(mesh)
    sw.lap("align.cpy_dev")

    hrows_t, hcols_t, cost = giant_mlsp_nw_lg(
        subst_d, y_d, x_d, nw.gapo_cost, nw.adjrows, nw.adjcols, mesh=mesh,
        block_h=BH, n_blocks=nb, band_w=Wb)
    sw.lap("align.calc")
    hrows_g = hrows_t.numpy()
    hcols_g = hcols_t.numpy().reshape(nb, D, BH + 1)
    sw.lap("align.cpy_host")
    nw.note_device_alloc(int(hrows_g.nbytes + hcols_g.nbytes))

    # The generic (hrows, hcols) form of _mlsp_store with tile BH x Wb:
    #   hrows[it] = full row it*BH (with the header column), 1 + cols_p
    #   hcols[it, r, jt] = H[it*BH + 1 + r, jt*Wb]
    g = nw.gapo_cost
    width = 1 + cols_p
    hrows = np.empty((nb, width), np.int32)
    hrows[0] = (np.arange(width, dtype=np.int64) * g).astype(np.int32)
    if nb > 1:
        hrows[1:, 0] = (
            np.arange(1, nb, dtype=np.int64) * BH * g).astype(np.int32)
        hrows[1:, 1:] = hrows_g[: nb - 1]
    hcols = np.empty((nb, BH, D), np.int32)
    hcols[:, :, 0] = (
        np.arange(1, rows_p + 1, dtype=np.int64) * g
    ).astype(np.int32).reshape(nb, BH)
    if D > 1:
        # hcols_g[i, k, 1:] = H[i*BH+1 .. (i+1)*BH, (k+1)*Wb]; jt = k+1.
        hcols[:, :, 1:] = np.transpose(hcols_g[:, : D - 1, 1:], (0, 2, 1))

    stat = _mlsp_store(nw, res, hrows, hcols, BH, Wb, nb, D)
    if stat != Status.success:
        return stat
    if res.align_cost != cost:
        # The cost captured in the fill must agree with the host recompute.
        return Status.errorInvalidResult
    return stat
