"""Wrapper of the CUDA banded pass (K7, ``strip_fill_banded`` of
``ops/csrc/strip_fill.cu``, host side ``ops/strip_cuda.py``), the per-band
fill of the giant-pair engine.

``banded_pass`` takes a pass's inputs in the meaning of gpuseqalign_tpu's
``ops/pallas_banded.py::banded_pass`` (``prev_row``, ``prevF_row``,
``haloH`` with its B*tile_h + 1 values, ``haloE``, ``adjr_loc``,
``adjc_loc``) and returns the outputs of ``banded_plain.banded_pass_plain``:
the pass's tile headers, with the band's right-edge column (the next
band's halo) at ``hcols[..., -1]`` and ``ecols[..., -1]``, and the pass's
last row (the next pass's carry) at ``hrows[-1]``. A pass may hold any
number of row blocks: the engine gives one call a whole band where its
halo is known in advance.

On a CUDA tensor it writes the inputs into the header grid where K1 has
the analytic edge and launches the kernel once on the current stream, with
no host sync: every row strip of the pass in flight at once, each strip
following the one above it column by column. A launch error raises. On a
CPU tensor it runs the plain version. ``out``, when given, is a dict of
preallocated grids (``alloc_band``) that the pass fills in place, so that
the engine's passes write into one grid per band.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.types import NEG_INF_I32
from .banded_plain import banded_pass_plain
from . import strip_cuda
from .mlsp_cuda import tile_best

LAUNCHES = 0


def alloc_band(n_blocks: int, band_cols: int, tile_h: int, tile_w: int,
               gap: str, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Empty header grids of ``n_blocks`` row blocks of one band."""
    i32 = dict(dtype=torch.int32, device=dev)
    jtE = band_cols // tile_w
    out = {"hrows": torch.empty((n_blocks + 1, band_cols + 1), **i32),
           "hcols": torch.empty((n_blocks, tile_h, jtE + 1), **i32)}
    if gap == "affine":
        out["frows"] = torch.empty_like(out["hrows"])
        out["ecols"] = torch.empty_like(out["hcols"])
    return out


def _check(subst, y, x, prev_row, prevF_row, haloH, haloE, tile_h, tile_w,
           gap) -> None:
    affine = gap == "affine"
    named = [("subst", subst), ("y", y), ("x", x), ("prev_row", prev_row),
             ("haloH", haloH)]
    if affine:
        if prevF_row is None or haloE is None:
            raise ValueError("affine needs prevF_row and haloE")
        named += [("prevF_row", prevF_row), ("haloE", haloE)]
    for name, t in named:
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != (2 if name == "subst" else 1):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not (y.is_contiguous() and x.is_contiguous()
            and subst.is_contiguous()):
        raise ValueError("subst, y and x must be contiguous")
    if subst.shape[0] != subst.shape[1]:
        raise ValueError(f"subst must be square, got {tuple(subst.shape)}")
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile must be >= 1x1, got {tile_h}x{tile_w}")
    rows_p, band_cols = y.numel() - 1, x.numel() - 1
    if rows_p < 1 or rows_p % tile_h or band_cols < 1 or band_cols % tile_w:
        raise ValueError(
            f"pass {rows_p}x{band_cols} must be a positive multiple of the "
            f"tile {tile_h}x{tile_w}")
    if prev_row.numel() != band_cols + 1 or haloH.numel() != rows_p + 1:
        raise ValueError(
            f"prev_row has {prev_row.numel()} values (want {band_cols + 1}),"
            f" haloH {haloH.numel()} (want {rows_p + 1})")
    if affine and (prevF_row.numel() != band_cols + 1
                   or haloE.numel() != rows_p):
        raise ValueError("prevF_row / haloE have the wrong length")


def banded_pass(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                gapo: int, gape: int, prev_row: torch.Tensor,
                prevF_row: Optional[torch.Tensor], haloH: torch.Tensor,
                haloE: Optional[torch.Tensor], adjr_loc: int, adjc_loc: int,
                *, tile_h: int, tile_w: int, kind: str, gap: str,
                out: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """One pass (or more) over one column band; the outputs of
    ``banded_pass_plain``, written into ``out`` when it is given."""
    global LAUNCHES
    _check(subst, y, x, prev_row, prevF_row, haloH, haloE, tile_h, tile_w,
           gap)
    dev = y.device
    B, band_cols = (y.numel() - 1) // tile_h, x.numel() - 1
    jtE = band_cols // tile_w
    is_sw, affine = kind == "sw", gap == "affine"
    adjc_loc = min(adjc_loc, band_cols + 1)  # no live cell past the band
    if out is None:
        out = alloc_band(B, band_cols, tile_h, tile_w, gap, dev)
    if dev.type == "cpu":
        got = banded_pass_plain(
            subst, y, x, gapo, gape, prev_row, prevF_row, haloH, haloE,
            adjr_loc, adjc_loc, tile_h=tile_h, tile_w=tile_w, kind=kind,
            gap=gap)
        for k in ("hrows", "hcols", "frows", "ecols"):
            if k in out:
                out[k].copy_(got[k])
        if is_sw:
            out["best"] = got["best"]
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device: {dev}")

    lib = strip_cuda.load_lib()
    hrows, hcols = out["hrows"], out["hcols"]
    frows, ecols = out.get("frows"), out.get("ecols")
    # The band's inputs where K1 has the analytic edge.
    hrows[0].copy_(prev_row)
    hrows[1:, 0] = haloH[tile_h::tile_h]
    hcols[:, :, 0] = haloH[1:].view(B, tile_h)
    if affine:
        frows[0].copy_(prevF_row)
        frows[1:, 0] = NEG_INF_I32
        ecols[:, :, 0] = haloE.view(B, tile_h)
    sched = strip_cuda.schedule(tile_h, tile_w)
    ns = strip_cuda.n_strips(B * tile_h, sched.rows)
    prog, carry = strip_cuda.alloc_scratch(1, ns, band_cols,
                                           not sched.carry_in_headers,
                                           affine, dev)
    tbest = (torch.zeros((ns, 3), dtype=torch.int32, device=dev)
             if is_sw else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.strip_fill_banded(
            int(is_sw), int(affine), sched.lane_rows, ptr(subst),
            subst.shape[0], ptr(y), ptr(x), gapo, gape,
            adjr_loc, adjc_loc, tile_h, tile_w, B, jtE,
            ptr(hrows), ptr(hcols), ptr(frows), ptr(ecols), ptr(tbest),
            ptr(carry), ptr(prog), stream,
        )
        if rc != 0:
            raise RuntimeError(f"banded_pass launch failed: cudaError {rc}")
        LAUNCHES += 1
    if is_sw:
        out["best"] = tile_best(tbest.view(1, -1, 3), band_cols + 1)[0]
    return out
