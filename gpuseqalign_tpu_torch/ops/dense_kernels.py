"""Dense single-pair alignment: host flow around the dense fills.

Port of gpuseqalign_tpu's ``ops/xla_kernels.py`` (``_pad_inputs``,
``_finish_dense_from_device``, ``_align_xla``), of
``ops/pallas_kernels.py::align_pallas_dense`` and of the host half of
``ops/pallas_wavefront2.py::align_dense_v2``. Three registry entries, all
writing the full H window to ``nw.score`` for the plain trace and hash:

  align_xla_rowscan  tpu2_xla_rowscan: ``dense_plain.rowscan_dense``
  align_xla_diag     tpu1_xla_diag: ``dense_plain.diag_dense``
  align_dense        tpu3_pallas_dense: ``dense_cuda.dense_fill``, the CUDA
                     kernel on the card, its plain version (the row scan)
                     on the CPU

Each runs on ``nw.device``. The TPU-only parts of ``align_dense_v2`` have
no counterpart: the K-chain choice and its compile-resource retry, the
power-of-two column buckets that share TPU compiles, and the VMEM and
register accounting. Every tuning key of the reference's parameter files
(threadsPerBlock, threadsPerBlockA, tileAx, tileAy, tileBx, tileBy,
kChains) is accepted and ignored.
"""

from __future__ import annotations

import functools

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
from ..utils.device import resolve_device, synchronize
from . import dense_cuda, dense_plain

# Padding of the sequences (the JAX package's lane width, kept so that
# both packages fill the same padded matrix).
LANES = 128


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad_inputs(nw: AlgInput):
    rows_p = pad_to(max(nw.adjrows - 1, 1), LANES)
    cols_p = pad_to(max(nw.adjcols - 1, 1), LANES)
    y = np.zeros(1 + rows_p, np.int32)
    x = np.zeros(1 + cols_p, np.int32)
    y[: nw.adjrows] = nw.seqY
    x[: nw.adjcols] = nw.seqX
    return y, x


def _finish_dense_from_device(nw: AlgInput, res: AlgResult,
                              H_dev: torch.Tensor) -> Status:
    sw = res.sw_align
    H = np.ascontiguousarray(H_dev[: nw.adjrows, : nw.adjcols].cpu().numpy())
    sw.lap("align.cpy_host")
    nw.score = H
    if nw.spec.kind == AlignKind.SW:
        # The first maximum in row-major order: the JAX package's tie rule.
        flat = int(np.argmax(H))
        nw.best_i, nw.best_j = divmod(flat, nw.adjcols)
        res.align_cost = int(H[nw.best_i, nw.best_j])
    else:
        res.align_cost = int(H[-1, -1])
    res.update_peak_mem(nw)
    nw.note_device_alloc(H_dev.numel() * 4)
    return Status.success


def _align(nw: AlgInput, res: AlgResult, fill) -> Status:
    """The dense host flow around ``fill(subst, y, x, gapo, gape, kind=,
    gap=)``, which returns at least the (adjrows, adjcols) window of H."""
    sw = res.sw_align
    sw.start()
    # Guarded affine domain (the same contract as align_mlsp and the
    # oracle): the cummax E-chain assumes extending a gap never loses to
    # re-opening one, which needs gapo <= 0 and gape <= 0. Outside it the
    # fill would silently return non-Gotoh values.
    if nw.spec.gap == GapKind.AFFINE and (
            nw.gapo_cost > 0 or nw.gape_cost > 0):
        return Status.errorInvalidValue
    dev = resolve_device(nw.device)
    y, x = _pad_inputs(nw)
    sw.lap("align.alloc")

    subst_d = torch.from_numpy(np.ascontiguousarray(nw.subst)).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    x_d = torch.from_numpy(x).to(dev)
    synchronize(dev)
    sw.lap("align.cpy_dev")

    H_dev = fill(subst_d, y_d, x_d, nw.gapo_cost, nw.gape_cost,
                 kind=nw.spec.kind.value, gap=nw.spec.gap.value)
    synchronize(dev)
    sw.lap("align.calc")
    return _finish_dense_from_device(nw, res, H_dev)


def align_xla_rowscan(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
    """tpu2_xla_rowscan: the row-scan fill, as torch ops on nw.device."""
    return _align(nw, res, dense_plain.rowscan_dense)


def align_xla_diag(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
    """tpu1_xla_diag: the anti-diagonal fill, as torch ops on nw.device."""
    return _align(nw, res, dense_plain.diag_dense)


def align_dense(pr: AlgParams, nw: AlgInput, res: AlgResult) -> Status:
    """tpu3_pallas_dense (and the Gpu3-6 aliases): the dense-fill kernel on
    the card, any spec; on the CPU its plain version, the row scan."""
    fill = functools.partial(dense_cuda.dense_fill, adjr=nw.adjrows,
                             adjc=nw.adjcols)
    return _align(nw, res, fill)
