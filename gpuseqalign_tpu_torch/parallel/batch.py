"""Batched pair-alignment engine: many pairs, one card or a mesh.

Port of gpuseqalign_tpu's ``parallel/batch.py``. Pairs are bucketed by
padded shape, each bucket is stacked and copied to the card once, and
every bucket goes through a kernel, chosen by its padded height and, on
a card, its pairs per SM (``fill_route``):

  rows_p >= 1024, or fewer than TINY_MIN_PAIRS_PER_SM pairs per SM
                  the batched fill (``ops/batch_cuda.mlsp_fill_batch``,
                  ``ops/csrc/strip_fill.cu``), tile gcd(rows_p, 128) x
                  gcd(cols_p, 512): each pair's live cells in row strips,
                  every strip in flight at once, one launch a group of
                  pairs
  otherwise       the tiny-pair fill (``ops/batch_cuda.tiny_scores``,
                  ``ops/csrc/mlsp_tiny.cu``), one warp per pair sweeping
                  its row strips in turn

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
from ..utils.spans import span
from .mesh import Mesh

# Buckets at least this tall take the batched tile fill, shorter ones the
# tiny-pair fill.
TILE_FILL_MIN_ROWS = 1024
# ... unless a shorter bucket holds fewer pairs than this per SM of its
# card: the tiny-pair fill runs a pair's strips in turn on one warp, the
# batched fill runs them all at once. On an H100 (chip_smoke.py's schedule
# sweep, four runs, PERF.md) the batched fill took 6-16% less time at 1
# pair per SM of 512 x 512 in three runs and 32-33% less on one 512 x
# 16384 pair; at 2 pairs per SM the faster of the two changed between
# runs; from 4 on the tiny-pair fill took 15-39% less.
TINY_MIN_PAIRS_PER_SM = 2


def fill_route(rows_p: int, npairs: int, sms: Optional[int]) -> str:
    """"fill" (the batched fill) or "tiny" (the tiny-pair fill) for a
    bucket of ``npairs`` pairs of ``rows_p`` padded rows on a card of
    ``sms`` SMs; ``sms`` None (the CPU, where both routes give the same
    outputs) decides by height alone."""
    if rows_p >= TILE_FILL_MIN_ROWS:
        return "fill"
    if sms is not None and npairs < TINY_MIN_PAIRS_PER_SM * sms:
        return "fill"
    return "tiny"


def _degenerate_cost(spec: AlignSpec, adjr, adjc, gapo: int,
                     gape: int) -> np.ndarray:
    """Analytic align_cost of a pair with an empty sequence (adjr < 2 or
    adjc < 2): the whole alignment is one gap run along the header
    row/col, which the in-kernel bottom-right capture never visits.
    Elementwise over numpy arrays of lengths too (int64)."""
    n_gap = np.asarray(adjr, np.int64) + np.asarray(adjc, np.int64) - 2
    if spec.kind == AlignKind.SW:
        return np.zeros_like(n_gap)
    if spec.gap == GapKind.AFFINE:
        return np.where(n_gap == 0, 0, gapo + n_gap * gape)
    return n_gap * gapo


def check_gaps(spec: AlignSpec, gapo: int, gape: int) -> None:
    """Raise for an affine spec with a gap cost above 0: the same domain
    guard as align_pallas_mlsp and the oracle, since the vectorized Gotoh
    construction requires non-positive gap costs."""
    if spec.gap == GapKind.AFFINE and (gapo > 0 or gape > 0):
        raise ValueError(
            "affine specs require gapo <= 0 and gape <= 0 "
            f"(got gapo={gapo}, gape={gape})"
        )


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


def padded(n: int, quantum: "int | str") -> int:
    """A sequence of ``n`` residues (no header) padded as ``bucket_pairs``
    pads each dimension: to a multiple of ``quantum``, or with
    quantum="pow2" to the next power of two (floor 256); at least 1."""
    n = max(n, 1)
    if quantum == "pow2":
        return _pad_pow2(n, 256)
    return _pad_to(n, quantum)


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
        key = (padded(len(y) - 1, quantum), padded(len(x) - 1, quantum))
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
    with span("batch.pad_rows"):
        ys = _pad_rows(dev[2 * b:2 * b + ny], adjrs, 1 + rows_p)
        xs = _pad_rows(dev[2 * b + ny:], adjcs, 1 + cols_p)
    return ys, xs, adjrs, adjcs


def bucket_scores(spec: AlignSpec, subst: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor, adjrs: torch.Tensor, adjcs: torch.Tensor,
                  gapo: int, gape: int, flow: str = "batch") -> torch.Tensor:
    """(3, b) int32 [costs, best_i, best_j] of one stacked bucket of b
    pairs with adjr, adjc >= 2 (``ys`` and ``adjrs`` a row a pair, or one
    query for all, as the wrappers take them), through the kernel
    ``fill_route`` picks; the kernel's wrapper call is the span
    ``<flow>.<route>``."""
    rows_p, cols_p = ys.shape[1] - 1, xs.shape[1] - 1
    kw = dict(kind=spec.kind.value, gap=spec.gap.value)
    sms = None
    if ys.device.type == "cuda":
        sms = torch.cuda.get_device_properties(ys.device).multi_processor_count
    if fill_route(rows_p, xs.shape[0], sms) == "fill":
        with span(f"{flow}.fill"):
            out = batch_cuda.mlsp_fill_batch(
                subst, ys, xs, gapo, gape, adjrs, adjcs,
                tile_h=math.gcd(rows_p, 128), tile_w=math.gcd(cols_p, 512),
                **kw)
        if "best" in out:
            return torch.cat([out["cost"].view(1, -1),
                              out["best"][:, 1:].t()])
        return torch.stack([out["cost"], torch.zeros_like(out["cost"]),
                            torch.zeros_like(out["cost"])])
    with span(f"{flow}.tiny"):
        out = batch_cuda.tiny_scores(subst, ys, xs, gapo, gape, adjrs,
                                     adjcs, **kw)
    return torch.stack(out)


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
    only after the last bucket.

    Every host step is a torch.profiler span; a child lies inside its
    parent, and the loop's own bookkeeping alone runs outside them. The
    four steps (``bucket_pairs``, ``stack_bucket``, ``bucket_scores``,
    ``gather``) are ``record_function`` spans always, which a caller can
    time by wrapping ``record_function`` with no profiler running; the
    rest are ``utils.spans.span``, open only while a profiler records:

      batch.bucket_pairs       the buckets and the pairs' lengths
      batch.subst              the substitution matrix to each device
      per bucket share:
        batch.stack_bucket     the pinned host buffer and its one copy
          batch.pad_rows       the padding on the device
        batch.bucket_scores    the route and the answers' assembly
          batch.fill | batch.tiny   the wrapper of the route taken
          batch.copy_back      the answers into a pinned host buffer (a
                               card; empty elsewhere)
      batch.gather             the wait for the devices, the answers out
    """
    check_gaps(spec, gapo, gape)
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if mesh is not None:
        mesh.check_one_process("the batch engine (across processes: "
                               "align_pairs_multihost)")
    devs = mesh.devices if mesh is not None else (resolve_device(device),)
    n = len(pairs)
    out = np.zeros((3, n), np.int32)  # costs, best_i, best_j
    with record_function("batch.bucket_pairs"):
        buckets = bucket_pairs(pairs, quantum)
        lens = np.array([(len(y), len(x)) for y, x in pairs],
                        np.int64).reshape(n, 2)
    with span("batch.subst"):
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
                with span("batch.copy_back"):
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
