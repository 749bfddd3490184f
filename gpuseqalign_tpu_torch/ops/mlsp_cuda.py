"""Wrapper of the CUDA sparse (mlsp) tile-header fill.

``mlsp_fill`` takes the inputs of ``mlsp_plain.mlsp_fill_plain`` and
returns the same outputs. On a CUDA tensor it launches the kernel of
``ops/csrc/mlsp_fill.cu`` (one launch per tile anti-diagonal, on the
current stream, no host sync between launches) or raises; it uses the
plain version only for tensors that lie on the CPU. ``load_lib``,
``alloc_headers`` and ``tile_best`` serve the batched entry of the same
library too (``batch_cuda.mlsp_fill_batch``), the first two its dense
entry (``dense_cuda.dense_fill``), and ``load_lib`` and ``tile_best`` its
banded entry (``banded_cuda.banded_pass``).

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.types import NEG_INF_I32
from .mlsp_plain import edge_col, edge_row, mlsp_fill_plain

LAUNCHES = 0

_lib = None


def load_lib() -> ctypes.CDLL:
    """The library of ``ops/csrc/mlsp_fill.cu``, built on first use."""
    global _lib
    if _lib is None:
        from .build import load

        lib = load("mlsp_fill")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mlsp_fill_scratch_words.argtypes = [i, i, i, i, i, i]
        lib.mlsp_fill_scratch_words.restype = ctypes.c_longlong
        lib.mlsp_fill_diag.argtypes = [
            i, i, p, i, p, p,          # sw, affine, subst, S, y, x
            i, i, i, i,                # gapo, gape, adjr, adjc
            i, i, i, i, i,             # th, tw, trows, tcols, d
            p, p, p, p, p, p,          # hrows, hcols, frows, ecols, tbest,
            p,                         # scratch, stream
        ]
        lib.mlsp_fill_diag.restype = ctypes.c_int
        lib.mlsp_fill_batch_diag.argtypes = [
            i, i, p, i, p, p,          # sw, affine, subst, S, ys, xs
            i, i, p, p,                # gapo, gape, adjrs, adjcs
            i, i, i, i, i, i,          # th, tw, trows, tcols, d, npairs
            p, p, p, p, p, p,          # hrows, hcols, frows, ecols, tbest,
            p, p,                      # cost, scratch, stream
        ]
        lib.mlsp_fill_batch_diag.restype = ctypes.c_int
        lib.mlsp_fill_dense_diag.argtypes = [
            i, i, p, i, p, p,          # sw, affine, subst, S, y, x
            i, i, i, i,                # gapo, gape, adjr, adjc
            i, i, i, i, i,             # th, tw, trows, tcols, d
            p, p, p, p, p,             # hrows, hcols, frows, ecols, H
            p, p,                      # scratch, stream
        ]
        lib.mlsp_fill_dense_diag.restype = ctypes.c_int
        for entry in (lib.mlsp_fill_banded_diag, lib.mlsp_fill_bodyoff_diag):
            entry.argtypes = lib.mlsp_fill_diag.argtypes
            entry.restype = ctypes.c_int
        _lib = lib
    return _lib


def alloc_headers(lead: tuple, rows_p: int, cols_p: int, tile_h: int,
                  tile_w: int, gapo: int, gape: int, kind: str, gap: str,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
    """The fill's header outputs (``mlsp_plain`` layout) for a leading
    shape ``lead`` of pairs (``()`` for one), with the analytic edge
    written: header row 0 and column 0. Everything else is the kernel's."""
    trows, tcols = rows_p // tile_h, cols_p // tile_w
    width = cols_p + 1
    i32 = dict(dtype=torch.int32, device=dev)
    hrows = torch.empty((*lead, trows, width), **i32)
    hcols = torch.empty((*lead, trows, tile_h, tcols), **i32)
    hrows[..., 0, :] = edge_row(width, gapo, gape, kind, gap, dev)
    hrows[..., 1:, 0] = edge_col(torch.arange(1, trows, **i32) * tile_h,
                                 gapo, gape, kind, gap)
    hcols[..., 0] = edge_col(
        torch.arange(1, rows_p + 1, **i32).view(trows, tile_h),
        gapo, gape, kind, gap)
    out = {"hrows": hrows, "hcols": hcols}
    if gap == "affine":
        frows = torch.empty((*lead, trows, width), **i32)
        ecols = torch.empty((*lead, trows, tile_h, tcols), **i32)
        frows[..., 0, :] = NEG_INF_I32
        frows[..., 1:, 0] = NEG_INF_I32
        ecols[..., 0] = NEG_INF_I32
        out["frows"], out["ecols"] = frows, ecols
    return out


def tile_best(tbest: torch.Tensor, width: int) -> torch.Tensor:
    """Per pair, the row-major first maximum over its tiles' SW bests: the
    largest value, then the smallest i, then the smallest j; (0, 0, 0) if
    nothing is > 0. tbest (B, tiles, 3) -> (B, 3)."""
    v = tbest[:, :, 0]
    key = tbest[:, :, 1].long() * width + tbest[:, :, 2].long()
    key = torch.where(v == v.amax(1, keepdim=True), key,
                      torch.iinfo(torch.int64).max)
    best = tbest.gather(1, key.argmin(1).view(-1, 1, 1).expand(-1, 1, 3))
    best = best[:, 0]
    return torch.where(best[:, :1] > 0, best, 0)


def _check(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
           tile_h: int, tile_w: int) -> None:
    for name, t in (("subst", subst), ("y", y), ("x", x)):
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if subst.dim() != 2 or subst.shape[0] != subst.shape[1]:
        raise ValueError(f"subst must be square, got {tuple(subst.shape)}")
    if y.dim() != 1 or x.dim() != 1:
        raise ValueError("y and x must be 1-D")
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile must be >= 1x1, got {tile_h}x{tile_w}")
    rows_p, cols_p = y.numel() - 1, x.numel() - 1
    if rows_p < 1 or rows_p % tile_h or cols_p < 1 or cols_p % tile_w:
        raise ValueError(
            f"padded sizes {rows_p}x{cols_p} must be positive multiples "
            f"of the tile {tile_h}x{tile_w}"
        )


def mlsp_fill(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
              gapo: int, gape: int, adjr: int, adjc: int, *,
              tile_h: int, tile_w: int, kind: str, gap: str,
              _bodyoff: bool = False) -> Dict[str, torch.Tensor]:
    """Sparse fill for any spec; the outputs of ``mlsp_fill_plain``.

    ``_bodyoff`` is for ``bench/vpu_probe.py::probe_gridcost`` alone: the
    same launches with the DP step skipped (CUDA only), whose outputs are
    not an alignment's."""
    global LAUNCHES
    _check(subst, y, x, tile_h, tile_w)
    args = (subst, y, x, gapo, gape, adjr, adjc)
    kw = dict(tile_h=tile_h, tile_w=tile_w, kind=kind, gap=gap)
    if y.device.type == "cpu" and not _bodyoff:
        return mlsp_fill_plain(*args, **kw)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device: {y.device}")

    lib = load_lib()
    dev = y.device
    is_sw = kind == "sw"
    affine = gap == "affine"
    rows_p, cols_p = y.numel() - 1, x.numel() - 1
    trows, tcols = rows_p // tile_h, cols_p // tile_w
    width = cols_p + 1
    i32 = dict(dtype=torch.int32, device=dev)

    out = alloc_headers((), rows_p, cols_p, tile_h, tile_w, gapo, gape,
                        kind, gap, dev)
    hrows, hcols = out["hrows"], out["hcols"]
    frows, ecols = out.get("frows"), out.get("ecols")
    tbest = scratch = None
    if is_sw:
        tbest = torch.empty((trows * tcols, 3), **i32)
    n_scratch = lib.mlsp_fill_scratch_words(
        subst.shape[0], tile_h, tile_w, tcols, int(is_sw), int(affine))
    if n_scratch:
        scratch = torch.empty(n_scratch, **i32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = lib.mlsp_fill_bodyoff_diag if _bodyoff else lib.mlsp_fill_diag
        for d in range(trows + tcols - 1):
            rc = entry(
                int(is_sw), int(affine), ptr(subst), subst.shape[0],
                ptr(y), ptr(x), gapo, gape, adjr, adjc,
                tile_h, tile_w, trows, tcols, d,
                ptr(hrows), ptr(hcols), ptr(frows), ptr(ecols), ptr(tbest),
                ptr(scratch), stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"mlsp_fill launch failed on diagonal {d}: "
                    f"cudaError {rc}"
                )
            LAUNCHES += 1

    if is_sw:
        out["best"] = tile_best(tbest.view(1, -1, 3), width)[0]
    return out
