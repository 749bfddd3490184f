"""Batched pair-alignment engine: many pairs, one card or a mesh.

Port of gpuseqalign_tpu's ``parallel/batch.py``. Pairs are bucketed by
padded shape, each bucket is stacked and copied to the card once, and
every bucket goes through a kernel, chosen by its padded height:

  rows_p >= 1024  the batched fill (``ops/batch_cuda.mlsp_fill_batch``,
                  ``ops/csrc/strip_fill.cu``), tile gcd(rows_p, 128) x
                  gcd(cols_p, 512): each pair's live cells in row strips,
                  one launch a group of pairs
  rows_p <  1024  the tiny-pair fill (``ops/batch_cuda.tiny_scores``,
                  ``ops/csrc/mlsp_tiny.cu``), one thread block per pair

Pairs with an empty sequence (adjr < 2 or adjc < 2) never reach a kernel:
their cost is the analytic edge, decided on the host. On the CPU the same
routes run the kernels' plain versions. With a mesh (``parallel/mesh.py``)
each bucket's pairs are split into one contiguous share per mesh entry,
each share runs the same kernel on its device, and the results are
gathered: bit-identical to one device, since no pair's result depends on
the others of its bucket. Unlike the JAX engine, no dummy pairs pad a
bucket to a multiple of the mesh size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..core.types import AlignKind, AlignSpec, GapKind
from ..ops import batch_cuda
from ..utils.device import resolve_device
from .mesh import Mesh

# Buckets at least this tall take the batched tile fill, shorter ones the
# tiny-pair fill.
TILE_FILL_MIN_ROWS = 1024


def _degenerate_cost(spec: AlignSpec, adjr: int, adjc: int, gapo: int,
                     gape: int) -> int:
    """Analytic align_cost of a pair with an empty sequence (adjr < 2 or
    adjc < 2): the whole alignment is one gap run along the header
    row/col, which the in-kernel bottom-right capture never visits."""
    if spec.kind == AlignKind.SW:
        return 0
    n_gap = int(adjr + adjc) - 2
    if spec.gap == GapKind.AFFINE:
        return 0 if n_gap == 0 else gapo + n_gap * gape
    return n_gap * gapo


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class BatchResult:
    """Per-pair outputs in input order."""

    costs: np.ndarray  # (N,) int32 align costs
    best_i: np.ndarray  # (N,) SW argmax row (0 for NW)
    best_j: np.ndarray  # (N,) SW argmax col (0 for NW)
    n_buckets: int = 0


def _pad_pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def bucket_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    quantum: "int | str" = 256,
) -> Dict[Tuple[int, int], List[int]]:
    """Group pair indices by padded (rows_p, cols_p) so each bucket compiles
    once. An int quantum pads linearly (like the reference's tile padding);
    quantum="pow2" pads each dim to the next power of two (floor 256) —
    at most 2x padded cells, but heterogeneous workloads collapse into
    O(log n) buckets instead of one per distinct shape."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx, (y, x) in enumerate(pairs):
        if quantum == "pow2":
            key = (
                _pad_pow2(max(len(y) - 1, 1), 256),
                _pad_pow2(max(len(x) - 1, 1), 256),
            )
        else:
            key = (
                _pad_to(max(len(y) - 1, 1), quantum),
                _pad_to(max(len(x) - 1, 1), quantum),
            )
        buckets.setdefault(key, []).append(idx)
    return buckets


def _pad_rows(flat: torch.Tensor, lens: torch.Tensor, width: int
              ) -> torch.Tensor:
    """Ragged rows (concatenated in ``flat``, lengths ``lens``) zero-padded
    to (len(lens), width), on flat's device."""
    dev = flat.device
    n, total = lens.numel(), flat.numel()
    lens = lens.long()
    rows = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                   output_size=total)
    starts = torch.cumsum(lens, 0) - lens
    dest = torch.arange(total, device=dev) + rows * width - starts[rows]
    out = torch.zeros((n, width), dtype=torch.int32, device=dev)
    out.view(-1)[dest] = flat
    return out


def stack_bucket(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                 idxs: Sequence[int], rows_p: int, cols_p: int,
                 device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The pairs ``idxs`` zero-padded to one shape, on ``device``: ys
    (b, 1+rows_p), xs (b, 1+cols_p), adjrs and adjcs (b,), int32. The
    lengths and the concatenated sequences go in one host buffer (pinned
    for a card) and one copy; the padding is done on the device."""
    b = len(idxs)
    ylist = [pairs[k][0] for k in idxs]
    xlist = [pairs[k][1] for k in idxs]
    lens = np.array([list(map(len, ylist)), list(map(len, xlist))],
                    np.int32)
    ny, nx = int(lens[0].sum()), int(lens[1].sum())
    host = torch.empty(2 * b + ny + nx, dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    buf[:2 * b] = lens.reshape(-1)
    np.concatenate(ylist, out=buf[2 * b:2 * b + ny])
    np.concatenate(xlist, out=buf[2 * b + ny:])
    dev = host.to(device, non_blocking=True)
    adjrs, adjcs = dev[:b], dev[b:2 * b]
    ys = _pad_rows(dev[2 * b:2 * b + ny], adjrs, 1 + rows_p)
    xs = _pad_rows(dev[2 * b + ny:], adjcs, 1 + cols_p)
    return ys, xs, adjrs, adjcs


def bucket_scores(spec: AlignSpec, subst: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor, adjrs: torch.Tensor, adjcs: torch.Tensor,
                  gapo: int, gape: int) -> torch.Tensor:
    """(3, b) int32 [costs, best_i, best_j] of one stacked bucket of pairs
    with adjr, adjc >= 2, through the kernel of its height."""
    rows_p, cols_p = ys.shape[1] - 1, xs.shape[1] - 1
    kw = dict(kind=spec.kind.value, gap=spec.gap.value)
    if rows_p >= TILE_FILL_MIN_ROWS:
        out = batch_cuda.mlsp_fill_batch(
            subst, ys, xs, gapo, gape, adjrs, adjcs,
            tile_h=math.gcd(rows_p, 128), tile_w=math.gcd(cols_p, 512),
            **kw)
        if "best" in out:
            return torch.cat([out["cost"].view(1, -1),
                              out["best"][:, 1:].t()])
        return torch.stack([out["cost"], torch.zeros_like(out["cost"]),
                            torch.zeros_like(out["cost"])])
    return torch.stack(batch_cuda.tiny_scores(
        subst, ys, xs, gapo, gape, adjrs, adjcs, **kw))


def align_pairs_batched(
    spec: AlignSpec,
    subst: np.ndarray,
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    gapo: int,
    gape: int = 0,
    quantum: "int | str" = 256,
    device: Optional[Union[str, torch.device]] = None,
    mesh: Optional[Mesh] = None,
) -> BatchResult:
    """Align many pairs (each with header element) on one device, or on
    every entry of ``mesh``.

    ``device`` None means the CUDA card (RuntimeError without one); with a
    mesh it must be None. Each bucket share is copied to its device once
    and its (cost, best) copied back once; the host waits for the devices
    only after the last bucket. The host steps are torch.profiler spans
    named ``batch.*``.
    """
    if spec.gap == GapKind.AFFINE and (gapo > 0 or gape > 0):
        # Same domain guard as align_pallas_mlsp / the oracle: the
        # vectorized Gotoh construction requires non-positive gap costs.
        raise ValueError(
            "affine specs require gapo <= 0 and gape <= 0 "
            f"(got gapo={gapo}, gape={gape})"
        )
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    devs = mesh.devices if mesh is not None else (resolve_device(device),)
    n = len(pairs)
    out = np.zeros((3, n), np.int32)  # costs, best_i, best_j
    with record_function("batch.bucket_pairs"):
        buckets = bucket_pairs(pairs, quantum)
        lens = np.array([(len(y), len(x)) for y, x in pairs],
                        np.int64).reshape(n, 2)
    subst_h = torch.from_numpy(np.ascontiguousarray(subst, np.int32))
    subst_d = {dev: subst_h.to(dev) for dev in dict.fromkeys(devs)}

    pending = []
    for (rows_p, cols_p), idxs in buckets.items():
        idxs = np.asarray(idxs)
        degenerate = (lens[idxs] < 2).any(1)
        for k in idxs[degenerate]:
            out[0, k] = _degenerate_cost(spec, lens[k, 0], lens[k, 1],
                                         gapo, gape)
        shares = np.array_split(idxs[~degenerate], len(devs))
        for dev, live in zip(devs, shares):
            if not live.size:
                continue
            with record_function("batch.stack_bucket"):
                stacked = stack_bucket(pairs, live, rows_p, cols_p, dev)
            with record_function("batch.bucket_scores"):
                res = bucket_scores(spec, subst_d[dev], *stacked, gapo, gape)
                if dev.type == "cuda":
                    host = torch.empty(res.shape, dtype=torch.int32,
                                       pin_memory=True)
                    res = host.copy_(res, non_blocking=True)
            pending.append((live, res))
    with record_function("batch.gather"):
        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        for live, res in pending:
            out[:, live] = res.numpy()
    return BatchResult(out[0], out[1], out[2], n_buckets=len(buckets))
