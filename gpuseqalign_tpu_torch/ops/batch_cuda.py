"""Wrappers of the batch engine's two CUDA fills.

``mlsp_fill_batch`` is the batched fill (``strip_fill_batch`` of
``ops/csrc/strip_fill.cu``, host side ``ops/strip_cuda.py``; plain version
``batch_plain.mlsp_fill_batch_plain``): one launch per group of pairs of a
bucket, every strip of every pair of the group in flight at once. The
engine's cost-only call fills each pair's live cells alone; with
``headers=True`` it fills the padded grid and returns the tile headers.
``tiny_scores`` is the cost-only fill of small pairs
(``ops/csrc/mlsp_tiny.cu``; plain version ``batch_plain.scores_batch_plain``):
one launch per group, one thread block per pair.

On a CUDA tensor each launches its kernel on the current stream or raises;
it uses the plain version only for tensors that lie on the CPU. Both take
a stacked bucket: ``ys`` (B, 1+rows_p), ``xs`` (B, 1+cols_p), ``adjrs`` and
``adjcs`` (B,), all int32 on one device. The kernels leave the NW cost of
a pair with ``adjr < 2`` or ``adjc < 2`` (an empty sequence: the cost lies
on the edge) to the caller; the plain versions compute it.

``FILL_LAUNCHES`` and ``TINY_LAUNCHES`` count kernel launches, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import mlsp_cuda, strip_cuda
from .batch_plain import mlsp_fill_batch_plain, scores_batch_plain

FILL_LAUNCHES = 0
TINY_LAUNCHES = 0

# Device words of tile headers and carry rows (and of tiny-fill scratch
# rows) one group of pairs may hold; a larger bucket runs as several groups.
HEADER_CAP_WORDS = 1 << 28
# Threads of one tiny-fill block (a multiple of 32, at most 256). Large
# blocks shorten each pair's serial chain and win while the bucket's blocks
# fill at most half of the card's resident threads; past that, small blocks
# idle fewer steps in each row group's ramp and win (PERF.md, the
# block-size sweep of chip_smoke.py: on an H100 the crossover lies between
# 4 and 8 pairs per SM).
TINY_THREADS_MANY, TINY_THREADS_FEW = 128, 256

_tiny_lib = None


def _load_tiny() -> ctypes.CDLL:
    global _tiny_lib
    if _tiny_lib is None:
        from .build import load

        lib = load("mlsp_tiny")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mlsp_tiny_scratch_words.argtypes = [i, i, i, i, i]
        lib.mlsp_tiny_scratch_words.restype = ctypes.c_longlong
        lib.mlsp_tiny.argtypes = [
            i, i, p, i, p, p,          # sw, affine, subst, S, ys, xs
            i, i, p, p,                # gapo, gape, adjrs, adjcs
            i, i, i, i,                # rows_p, cols_p, npairs, threads
            p, p, p, p,                # cost, best, scratch, stream
        ]
        lib.mlsp_tiny.restype = ctypes.c_int
        _tiny_lib = lib
    return _tiny_lib


def _check(subst: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           adjrs: torch.Tensor, adjcs: torch.Tensor) -> None:
    for name, t in (("subst", subst), ("ys", ys), ("xs", xs),
                    ("adjrs", adjrs), ("adjcs", adjcs)):
        if t.device != ys.device:
            raise ValueError(f"{name} is on {t.device}, ys on {ys.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if subst.dim() != 2 or subst.shape[0] != subst.shape[1]:
        raise ValueError(f"subst must be square, got {tuple(subst.shape)}")
    n = ys.shape[0] if ys.dim() == 2 else -1
    if (ys.dim() != 2 or xs.dim() != 2 or xs.shape[0] != n or n < 1
            or ys.shape[1] < 2 or xs.shape[1] < 2):
        raise ValueError(f"ys {tuple(ys.shape)} and xs {tuple(xs.shape)} "
                         "must be (B, 1+rows_p) and (B, 1+cols_p), B >= 1")
    if adjrs.shape != (n,) or adjcs.shape != (n,):
        raise ValueError(f"adjrs and adjcs must be ({n},)")
    if ys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {ys.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def mlsp_fill_batch(subst: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    gapo: int, gape: int, adjrs: torch.Tensor,
                    adjcs: torch.Tensor, *, tile_h: int, tile_w: int,
                    kind: str, gap: str, headers: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Batched sparse fill: ``cost`` (B,) and for SW ``best`` (B, 3).
    ``headers=True`` also returns the tile headers in
    ``mlsp_fill_plain``'s layout (on a leading pair axis): all the outputs
    of ``mlsp_fill_batch_plain``. Without ``headers`` the kernel fills each
    pair's live cells alone and writes no header; the card holds one
    group of pairs' carry rows (or headers) at a time."""
    global FILL_LAUNCHES
    _check(subst, ys, xs, adjrs, adjcs)
    rows_p, cols_p = ys.shape[1] - 1, xs.shape[1] - 1
    if tile_h < 1 or tile_w < 1 or rows_p % tile_h or cols_p % tile_w:
        raise ValueError(f"padded sizes {rows_p}x{cols_p} must be multiples "
                         f"of the tile {tile_h}x{tile_w}")
    kw = dict(tile_h=tile_h, tile_w=tile_w, kind=kind, gap=gap)
    if ys.device.type == "cpu":
        out = mlsp_fill_batch_plain(subst, ys, xs, gapo, gape, adjrs, adjcs,
                                    **kw)
        keep = ("cost", "best") if not headers else tuple(out)
        return {k: v for k, v in out.items() if k in keep}

    lib = strip_cuda.load_lib()
    dev = ys.device
    n = ys.shape[0]
    is_sw = kind == "sw"
    affine = gap == "affine"
    trows, tcols = rows_p // tile_h, cols_p // tile_w
    width = cols_p + 1
    i32 = dict(dtype=torch.int32, device=dev)
    sched = strip_cuda.schedule(tile_h, tile_w)
    ns = strip_cuda.n_strips(rows_p, sched.rows)
    carry = not (headers and sched.carry_in_headers)
    per_pair = (sum(strip_cuda.scratch_words(1, ns, cols_p, carry, affine))
                + 3 * ns)
    if headers:
        per_pair += (trows * width + rows_p * tcols) * (2 if affine else 1)
    group = max(1, HEADER_CAP_WORDS // per_pair)

    cost = torch.zeros(n, **i32)
    parts = []
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for g0 in range(0, n, group):
            g = min(group, n - g0)
            out = {}
            if headers:
                out = mlsp_cuda.alloc_headers((g,), rows_p, cols_p, tile_h,
                                              tile_w, gapo, gape, kind, gap,
                                              dev)
            prog, rows = strip_cuda.alloc_scratch(g, ns, cols_p, carry,
                                                  affine, dev)
            tbest = torch.zeros((g, ns, 3), **i32) if is_sw else None
            rc = lib.strip_fill_batch(
                int(is_sw), int(affine), sched.lane_rows, int(headers),
                _ptr(subst), subst.shape[0],
                _ptr(ys[g0:]), _ptr(xs[g0:]), gapo, gape,
                _ptr(adjrs[g0:]), _ptr(adjcs[g0:]),
                tile_h, tile_w, trows, tcols, g,
                _ptr(out.get("hrows")), _ptr(out.get("hcols")),
                _ptr(out.get("frows")), _ptr(out.get("ecols")),
                _ptr(tbest), _ptr(cost[g0:]), _ptr(rows), _ptr(prog), stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"mlsp_fill_batch launch failed: cudaError {rc}")
            FILL_LAUNCHES += 1
            if is_sw:
                out["best"] = mlsp_cuda.tile_best(tbest, width)
            parts.append(out)

    res = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    res["cost"] = res["best"][:, 0].contiguous() if is_sw else cost
    return res


def tiny_scores(subst: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                gapo: int, gape: int, adjrs: torch.Tensor,
                adjcs: torch.Tensor, *, kind: str, gap: str,
                _threads: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cost-only fill of a stacked bucket of small pairs; the outputs of
    ``scores_batch_plain``: (costs, best_i, best_j), each (B,) int32.
    The block size follows from the pair count; ``_threads`` overrides it
    (a hook for the checks and the block-size sweep)."""
    global TINY_LAUNCHES
    _check(subst, ys, xs, adjrs, adjcs)
    if ys.device.type == "cpu":
        return scores_batch_plain(subst, ys, xs, adjrs, adjcs, gapo, gape,
                                  kind=kind, gap=gap)

    lib = _load_tiny()
    dev = ys.device
    n = ys.shape[0]
    rows_p, cols_p = ys.shape[1] - 1, xs.shape[1] - 1
    is_sw = kind == "sw"
    affine = gap == "affine"
    threads = _threads
    if threads is None:
        props = torch.cuda.get_device_properties(dev)
        resident = (props.multi_processor_count
                    * props.max_threads_per_multi_processor)
        threads = (TINY_THREADS_FEW if 2 * n * TINY_THREADS_FEW <= resident
                   else TINY_THREADS_MANY)
    nt = min(threads, 32 * -(-rows_p // 32))
    i32 = dict(dtype=torch.int32, device=dev)
    S = subst.shape[0]
    n_scratch = lib.mlsp_tiny_scratch_words(S, nt, cols_p, int(is_sw),
                                            int(affine))
    group = n
    if n_scratch:
        group = max(1, min(n, HEADER_CAP_WORDS // n_scratch))
    cost = torch.zeros(n, **i32)
    best = torch.zeros((n, 3), **i32)
    scratch = (torch.empty(group * n_scratch, **i32) if n_scratch else None)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for g0 in range(0, n, group):
            g = min(group, n - g0)
            rc = lib.mlsp_tiny(
                int(is_sw), int(affine), _ptr(subst), S,
                _ptr(ys[g0:]), _ptr(xs[g0:]), gapo, gape,
                _ptr(adjrs[g0:]), _ptr(adjcs[g0:]), rows_p, cols_p, g, nt,
                _ptr(cost[g0:]), _ptr(best[g0:]), _ptr(scratch), stream,
            )
            if rc != 0:
                raise RuntimeError(f"mlsp_tiny launch failed: cudaError {rc}")
            TINY_LAUNCHES += 1
    return cost, best[:, 1], best[:, 2]
