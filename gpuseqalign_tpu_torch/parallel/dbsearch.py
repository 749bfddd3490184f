"""Database search: one query at a time against subjects kept on the card.

A protein database search (SWIPE, CUDASW++) aligns a query against every
sequence of a database and returns every subject's score and best cell.
``load_db`` puts the database on one device once:

  * each subject goes into a bucket by its padded column length
    (``batch.padded``, the batch engine's rule) and, inside its bucket,
    is sorted by length, longest first, so that the warps of a block and
    the last blocks of a launch hold subjects of like length;
  * every bucket's lengths and residues, and the permutation back to
    input order, go through one pinned host buffer and one copy, and
    each bucket is padded on the device.

``search_db`` then aligns one query against every subject: the query and
its length go to the device in one copy, each bucket goes through the
kernel ``batch.fill_route`` picks for the query's padded rows (the tiny-
pair fill K6 or the batched fill K5), both reading the one query row at
a row stride of 0, the answers are put back into input order on the
device (one gather) and come back in one pinned copy after one wait for
the device. Nothing of the database is restacked, padded or
copied again, nor is the substitution matrix after a search's first use
of it. The answers are ``align_pairs_batched``'s over ``[(query, s) for
s in subjects]``, bit for bit, in the subjects' order; subjects with an
empty sequence, and an empty query, take the analytic cost on the host.

Spans: ``db.load`` (``utils.spans.span``); ``db.search``, a
``record_function`` always, like the batch engine's four steps, holding
the ``span``s ``db.query`` (the query and its length to the device, and
the matrix on its first use), one ``db.fill`` or ``db.tiny`` a bucket
(the route's wrapper), ``db.copy_back`` (the answers gathered into one
pinned buffer) and ``db.gather`` (the wait, the answers out in input
order). Counters: ``DB_LOADS``, ``SEARCHES`` and ``SEARCH_H2D_BYTES``
(the bytes the searches copied to their device).

One device and one process: a mesh, or a process group of more than one
process, is refused.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..core.types import AlignSpec
from ..utils.device import resolve_device
from ..utils.spans import span
from .batch import (BatchResult, _degenerate_cost, _pad_rows, bucket_scores,
                    check_gaps, padded)
from .mesh import Mesh

DB_LOADS = 0
SEARCHES = 0
SEARCH_H2D_BYTES = 0


@dataclasses.dataclass
class SubjectDB:
    """A database of subjects on one device (``load_db``)."""

    device: torch.device
    lens: np.ndarray  # (n,) int64, each subject's length with its header
    # Per bucket: xs (b, 1 + cols_p) and adjcs (b,), int32 on the device.
    buckets: List[Tuple[torch.Tensor, torch.Tensor]]
    # (n,) int32 on the device: each subject's place in bucket order (0
    # for a subject with no residue, whose answer the host writes).
    inv: torch.Tensor
    empty: np.ndarray  # input indices of the subjects with no residue
    # The matrix of the last search, on the host and the device.
    subst: Optional[Tuple[np.ndarray, torch.Tensor]] = None

    def __len__(self) -> int:
        return len(self.lens)


def _one_process(device) -> None:
    if isinstance(device, Mesh):
        raise ValueError("a database is kept on one device, not on a mesh")
    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise ValueError("a database search runs in one process, not over "
                         f"{torch.distributed.get_world_size()} processes")


def load_db(subjects: Sequence[np.ndarray],
            device: Optional[Union[str, torch.device]] = None) -> SubjectDB:
    """The subjects (header-prefixed int32 arrays, as the batch engine
    takes them) bucketed, sorted and stacked on ``device`` (None: the
    CUDA card) once; padded as ``bucket_pairs(..., "pow2")`` pads
    columns."""
    global DB_LOADS
    _one_process(device)
    dev = resolve_device(device)
    with span("db.load"):
        lens = np.fromiter(map(len, subjects), np.int64, len(subjects))
        live = np.flatnonzero(lens >= 2)
        sizes = np.unique(lens[live])
        cols = np.array([padded(int(v) - 1, "pow2") for v in sizes],
                        np.int64)[np.searchsorted(sizes, lens[live])]
        # By padded width, then longest first.
        by = np.lexsort((-lens[live], cols))
        order, cols = live[by], cols[by]
        words = lens[order]
        n, m = len(lens), len(order)
        host = torch.zeros(n + m + int(words.sum()), dtype=torch.int32,
                           pin_memory=dev.type == "cuda")
        buf = host.numpy()
        buf[order] = np.arange(m)
        buf[n:n + m] = words
        if m:
            np.concatenate([subjects[k] for k in order], out=buf[n + m:])
        flat = host.to(dev, non_blocking=True)
        inv, adjcs, seqs = flat[:n], flat[n:n + m], flat[n + m:]
        offs = np.concatenate([[0], np.cumsum(words)])
        starts = np.flatnonzero(np.diff(cols, prepend=-1))
        buckets = [(_pad_rows(seqs[offs[lo]:offs[hi]], adjcs[lo:hi],
                              1 + int(cols[lo])), adjcs[lo:hi])
                   for lo, hi in zip(starts, np.append(starts[1:],
                                                       len(cols)))]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    DB_LOADS += 1
    return SubjectDB(dev, lens, buckets, inv, np.flatnonzero(lens < 2))


def _matrix(db: SubjectDB, subst: np.ndarray) -> Tuple[torch.Tensor, int]:
    """The matrix on the database's device, and the bytes copied for it:
    none where the last search used the same one."""
    host = np.ascontiguousarray(subst, np.int32)
    if db.subst is not None and np.array_equal(db.subst[0], host):
        return db.subst[1], 0
    db.subst = (host.copy(), torch.from_numpy(host).to(db.device))
    return db.subst[1], host.nbytes


def search_db(spec: AlignSpec, subst: np.ndarray, query: np.ndarray,
              db: SubjectDB, gapo: int, gape: int = 0) -> BatchResult:
    """Align ``query`` (header-prefixed int32) against every subject of
    ``db``: each subject's cost and, for SW, best cell, in input order.
    The result's three arrays are the rows of one (3, N) int32 array of
    the search's own (``costs.base``), so that a caller who wants the
    answers as one block takes it without a copy."""
    global SEARCHES, SEARCH_H2D_BYTES
    check_gaps(spec, gapo, gape)
    cuda = db.device.type == "cuda"
    adjr = len(query)
    with record_function("db.search"):
        if adjr < 2 or not db.buckets:
            out = np.zeros((3, len(db)), np.int32)
        else:
            rows_p = padded(adjr - 1, "pow2")
            with span("db.query"):
                host = torch.zeros(2 + rows_p, dtype=torch.int32,
                                   pin_memory=cuda)
                buf = host.numpy()
                buf[0] = adjr
                buf[1:1 + adjr] = query
                dev = host.to(db.device, non_blocking=True)
                subst_d, sent = _matrix(db, subst)
                SEARCH_H2D_BYTES += host.nbytes + sent
            ys, adjrs = dev[1:].view(1, 1 + rows_p), dev[:1]
            res = [bucket_scores(spec, subst_d, ys, xs, adjrs, adjcs, gapo,
                                 gape, flow="db")
                   for xs, adjcs in db.buckets]
            with span("db.copy_back"):
                res = torch.cat(res, 1).index_select(1, db.inv)
                if cuda:
                    res = torch.empty(res.shape, dtype=torch.int32,
                                      pin_memory=True).copy_(
                                          res, non_blocking=True)
            with span("db.gather"):
                if cuda:
                    torch.cuda.synchronize(db.device)
                # costs, best_i, best_j; copied, so that the pinned block
                # goes back to torch's cache however long the caller
                # keeps the answers.
                out = res.numpy().copy()
        dead = np.arange(len(db)) if adjr < 2 else db.empty
        if dead.size:
            out[:, dead] = 0
            out[0, dead] = _degenerate_cost(spec, adjr, db.lens[dead], gapo,
                                            gape)
    SEARCHES += 1
    return BatchResult(out[0], out[1], out[2], n_buckets=len(db.buckets))
