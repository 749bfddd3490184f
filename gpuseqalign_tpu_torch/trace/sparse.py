"""Sparse (mlsp) result ops: tile-recompute traceback, rolling-row hash.

Re-design of the reference's sparse result ops (ref: src/nwtrace2_sparse.cpp).
The score matrix is represented ONLY by per-tile header rows/columns
(tileHrowMat / tileHcolMat, layouts identical to
ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352); the traceback recomputes one
tile interior at a time from its stored headers, stepping to the up/left
neighbour tile when it crosses into the header row/column
(ref: src/nwtrace2_sparse.cpp:186-205). The score hash recomputes the full
matrix with rolling rows so the byte stream — and therefore the hash — is
identical to the dense hash (ref: src/nwtrace2_sparse.cpp:263-340).

Spec coverage: NW linear-gap follows the reference walk bit-exactly (the
parity surface). NW/SW affine and SW linear are capability extensions the
reference never implemented (ref: README.md:26): affine tiles additionally
depend on (F top-row, E left-col) headers (AlgInput.tileFrowMat /
tileEcolMat), and their traceback is the attainment walk defined by the
oracle (models/oracle.py) so sparse and dense transcripts agree exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, TextIO, Tuple

import numpy as np

from ..core.hashing import djb2_array, djb2_init, djb2_ints, djb2_str
from ..core.transcript import rle_from_edits
from ..core.types import (
    AlgInput,
    AlgResult,
    AlignKind,
    GapKind,
    NEG_INF_I32,
    Status,
)
from ..models.oracle import _row_chain_max, attain_walk as _attain_walk


@dataclasses.dataclass
class TileCo:
    i_tile: int = 0
    j_tile: int = 0
    i_elem: int = 0
    j_elem: int = 0


def get_tile_and_elem_ij(nw: AlgInput, i: int, j: int) -> TileCo:
    """(ref: src/nwtrace2_sparse.cpp:8-38) Tiles are extended with their
    header row/column and exclude their last row/column (which is the next
    tile's header). Saturates at the last tile row/column."""
    co = TileCo()
    th = nw.tile_hcol_len - 1  # tile height (rows per tile, sans header)
    tw = nw.tile_hrow_len - 1  # tile width
    co.i_tile, co.i_elem = divmod(i, th)
    co.j_tile, co.j_elem = divmod(j, tw)
    if co.i_tile == nw.tile_hdr_mat_rows:
        co.i_tile -= 1
        co.i_elem += th
    if co.j_tile == nw.tile_hdr_mat_cols:
        co.j_tile -= 1
        co.j_elem += tw
    return co


def align_tile(tile: np.ndarray, nw: AlgInput, co: TileCo) -> None:
    """Recompute one tile's H interior from its stored headers — NW
    linear-gap (ref: src/nwtrace2_sparse.cpp:40-96). Rows are computed with
    the max-plus prefix scan; cells past adjrows/adjcols are zero-filled."""
    hrow_len = nw.tile_hrow_len
    hcol_len = nw.tile_hcol_len
    k = nw.tile_hdr_mat_cols * co.i_tile + co.j_tile

    tile[0, :] = nw.tileHrowMat[k]
    tile[:, 0] = nw.tileHcolMat[k]

    ibeg = co.i_tile * (hcol_len - 1)
    jbeg = co.j_tile * (hrow_len - 1)
    iend = min(hcol_len, co.i_elem + 1)
    jend = min(hrow_len, co.j_elem + 1)
    if iend <= 1 or jend <= 1:
        return

    g = np.int32(nw.gapo_cost)
    jj = jbeg + np.arange(1, jend)
    j_in = np.minimum(jj, nw.adjcols - 1)  # clamp for x-letter lookup
    xs = nw.seqX[j_in]
    valid_j = jj < nw.adjcols

    for i in range(1, iend):
        gi = ibeg + i
        if gi >= nw.adjrows:
            tile[i, 1:jend] = 0
            continue
        prev = tile[i - 1, :jend]
        srow = nw.subst[nw.seqY[gi], xs]
        cand = np.maximum(prev[:-1] + srow, prev[1:] + g).astype(np.int32)
        row = _row_chain_max(cand, int(tile[i, 0]), nw.gapo_cost)
        row[1:][~valid_j] = 0
        tile[i, 1:jend] = row[1:]


def align_tile_full(nw: AlgInput, co: TileCo) -> Dict[str, np.ndarray]:
    """Recompute the FULL interior of one tile for any spec.

    Returns {'H'} for linear gap, {'H','E','F'} for affine. Header row 0 /
    col 0 come from the stored sparse matrices; cells past adjrows/adjcols
    are left at the spec's neutral value (never visited by tracebacks)."""
    hrow_len = nw.tile_hrow_len
    hcol_len = nw.tile_hcol_len
    k = nw.tile_hdr_mat_cols * co.i_tile + co.j_tile
    is_sw = nw.spec.kind == AlignKind.SW
    affine = nw.spec.gap == GapKind.AFFINE
    go = np.int32(nw.gapo_cost)
    ge = np.int32(nw.gape_cost)
    ninf = np.int32(NEG_INF_I32)

    H = np.zeros((hcol_len, hrow_len), np.int32)
    H[0, :] = nw.tileHrowMat[k]
    H[:, 0] = nw.tileHcolMat[k]
    out = {"H": H}
    if affine:
        F = np.full((hcol_len, hrow_len), ninf, np.int32)
        E = np.full((hcol_len, hrow_len), ninf, np.int32)
        F[0, :] = nw.tileFrowMat[k]
        E[:, 0] = nw.tileEcolMat[k]
        out["E"] = E
        out["F"] = F

    ibeg = co.i_tile * (hcol_len - 1)
    jbeg = co.j_tile * (hrow_len - 1)
    jj = jbeg + np.arange(1, hrow_len)
    j_in = np.minimum(jj, nw.adjcols - 1)
    xs = nw.seqX[j_in]
    offs = (np.arange(hrow_len, dtype=np.int64) * int(ge)).astype(np.int32)

    for i in range(1, hcol_len):
        gi = ibeg + i
        if gi >= nw.adjrows:
            break
        srow = nw.subst[nw.seqY[gi], xs]
        hprev = H[i - 1]
        if not affine:
            cand = np.maximum(hprev[:-1] + srow, hprev[1:] + go).astype(
                np.int32
            )
            if is_sw:
                np.maximum(cand, np.int32(0), out=cand)
                row = _row_chain_max(cand, int(H[i, 0]), nw.gapo_cost)
                np.maximum(row, np.int32(0), out=row)
            else:
                row = _row_chain_max(cand, int(H[i, 0]), nw.gapo_cost)
            H[i, 1:] = row[1:]
        else:
            frow = (np.maximum(F[i - 1], hprev + go) + ge).astype(np.int32)
            frow[0] = F[i, 0]
            F[i] = frow
            v = np.maximum(hprev[:-1] + srow, frow[1:]).astype(np.int32)
            if is_sw:
                np.maximum(v, np.int32(0), out=v)
            # E[i,j] = max(E[i,j-1], H[i,j-1]+go) + ge with stored seed
            # E[i,0]: fold the seed into the chain-max over
            # m[j] = max(E_seed - ge + ..., H[i,j]+go) - j*ge.
            vfull = np.empty(hrow_len, np.int32)
            vfull[0] = H[i, 0]
            vfull[1:] = v
            m = (vfull + go - offs).astype(np.int32)
            # Stored E[i,0] seed: contributes E[i,0] + j*ge at column j.
            m[0] = max(int(m[0]), int(E[i, 0]))
            np.maximum.accumulate(m, out=m)
            erow = np.empty(hrow_len, np.int32)
            erow[0] = E[i, 0]
            erow[1:] = (m[:-1] + offs[1:]).astype(np.int32)
            E[i] = erow
            hrow = np.maximum(v, erow[1:])
            if is_sw:
                np.maximum(hrow, np.int32(0), out=hrow)
            H[i, 1:] = hrow
    return out


def _sparse_ref_parity(nw: AlgInput) -> bool:
    return nw.spec.kind == AlignKind.NW and nw.spec.gap == GapKind.LINEAR


class _TileCache:
    """Recompute-on-demand tile access for the general traceback (keeps the
    last few tiles so edge-crossing steps don't recompute per read)."""

    def __init__(self, nw: AlgInput, cap: int = 4):
        self.nw = nw
        self.cap = cap
        self.tiles: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}

    def at(self, co: TileCo) -> Dict[str, np.ndarray]:
        key = (co.i_tile, co.j_tile)
        mats = self.tiles.get(key)
        if mats is None:
            mats = align_tile_full(self.nw, co)
            if len(self.tiles) >= self.cap:
                self.tiles.pop(next(iter(self.tiles)))
        else:
            # LRU, not FIFO: the walk re-reads the current tile between
            # neighbor (E/F-owner) reads — keep hot tiles resident.
            del self.tiles[key]
        self.tiles[key] = mats
        return mats


def trace_sparse(nw: AlgInput, res: AlgResult, calc_debug_trace: bool) -> Status:
    """(ref: src/nwtrace2_sparse.cpp:102-257 for NW_LG; oracle-defined
    attainment walk for the affine/SW extensions)."""
    if nw.tileHrowMat is None:
        return Status.errorInvalidValue
    if not _sparse_ref_parity(nw):
        return _trace_sparse_general(nw, res, calc_debug_trace)

    sw = res.sw_trace
    sw.start()
    tile = np.zeros((nw.tile_hcol_len, nw.tile_hrow_len), dtype=np.int32)
    sw.lap("trace.alloc")

    i = nw.adjrows - 1
    j = nw.adjcols - 1
    co = get_tile_and_elem_ij(nw, i, j)
    # Normalize a start that lands exactly on a tile header row/column
    # (elem == 0 with a neighbor tile): the same cell is the neighbor's
    # last row/column, where the interior recompute can proceed. Without
    # this the walk would see an empty (headers-only) tile and dead-end
    # up the border. (The saturation in get_tile_and_elem_ij already does
    # this for the LAST tile; this is the general-tile analog, matching
    # the reference's mid-walk rebase, ref: src/nwtrace2_sparse.cpp:186-205.)
    if co.i_elem == 0 and co.i_tile > 0:
        co.i_tile -= 1
        co.i_elem = nw.tile_hcol_len - 1
    if co.j_elem == 0 and co.j_tile > 0:
        co.j_tile -= 1
        co.j_elem = nw.tile_hrow_len - 1
    align_tile(tile, nw, co)

    edits = []  # walk order (bottom-right to top-left)
    cells = []
    while True:
        if calc_debug_trace:
            cells.append(int(tile[co.i_elem, co.j_elem]))

        mx = None
        di = dj = 0
        edit = None
        if co.i_elem > 0 and co.j_elem > 0:
            mx = int(tile[co.i_elem - 1, co.j_elem - 1])
            di = dj = -1
            edit = "=" if nw.seqX[j] == nw.seqY[i] else "X"
        if co.i_elem > 0 and (mx is None or mx < int(tile[co.i_elem - 1, co.j_elem])):
            mx = int(tile[co.i_elem - 1, co.j_elem])
            di, dj = -1, 0
            edit = "I"
        if co.j_elem > 0 and (mx is None or mx < int(tile[co.i_elem, co.j_elem - 1])):
            mx = int(tile[co.i_elem, co.j_elem - 1])
            di, dj = 0, -1
            edit = "D"
        i += di
        j += dj
        co.i_elem += di
        co.j_elem += dj

        di_tile = -1 if (co.i_elem == 0 and co.i_tile > 0) else 0
        dj_tile = -1 if (co.j_elem == 0 and co.j_tile > 0) else 0
        if di_tile != 0 or dj_tile != 0:
            co.i_tile += di_tile
            co.j_tile += dj_tile
            # Rebase only the axis whose tile moved: a diagonal step onto
            # row 0 at a tile-column boundary moves the column tile alone,
            # and the walk stays on the header row (and the mirror case on
            # the header column).
            if di_tile != 0:
                co.i_elem = nw.tile_hcol_len - 1
            if dj_tile != 0:
                co.j_elem = nw.tile_hrow_len - 1
            align_tile(tile, nw, co)

        if edit is not None:
            edits.append(edit)
        if di == 0 and dj == 0:
            break

    edits.reverse()
    cells.reverse()
    res.edit_trace = rle_from_edits(edits)
    sw.lap("trace.calc")

    if calc_debug_trace:
        nw.trace = cells
    h = djb2_str(res.edit_trace, djb2_init())
    if calc_debug_trace:
        h = djb2_ints(cells, h)
    res.trace_hash = h
    return Status.success


def _trace_sparse_general(
    nw: AlgInput, res: AlgResult, calc_debug_trace: bool
) -> Status:
    """Attainment walk over recomputed tiles for affine / SW specs —
    transcript-identical to the dense oracle walk (oracle._trace_attain)."""
    sw = res.sw_trace
    sw.start()
    cache = _TileCache(nw)
    sw.lap("trace.alloc")

    is_sw = nw.spec.kind == AlignKind.SW
    affine = nw.spec.gap == GapKind.AFFINE
    gapo = nw.gapo_cost
    gape = nw.gape_cost

    if is_sw:
        i, j = nw.best_i, nw.best_j
    else:
        i, j = nw.adjrows - 1, nw.adjcols - 1

    th = nw.tile_hcol_len - 1
    tw = nw.tile_hrow_len - 1

    def val(name, ii, jj):
        co2 = get_tile_and_elem_ij(nw, ii, jj)
        # E is not stored along tile header ROWS (only F is), and F is not
        # stored along tile header COLUMNS (only E is) — read those from
        # the neighboring tile that computed them as its last row/column.
        if name == "E" and co2.i_elem == 0 and co2.i_tile > 0:
            co2.i_tile -= 1
            co2.i_elem = th
        if name == "F" and co2.j_elem == 0 and co2.j_tile > 0:
            co2.j_tile -= 1
            co2.j_elem = tw
        m2 = cache.at(co2)
        return int(m2[name][co2.i_elem, co2.j_elem])

    # The walk itself is THE shared attainment walk (oracle.attain_walk)
    # over the tile-recompute accessor, so dense and sparse transcripts
    # cannot drift.
    edits, cells = _attain_walk(
        val, nw.seqY, nw.seqX, nw.subst, gapo, gape, i, j,
        is_sw=is_sw, affine=affine, debug=calc_debug_trace,
    )

    edits.reverse()
    cells.reverse()
    res.edit_trace = rle_from_edits(edits)
    sw.lap("trace.calc")

    if calc_debug_trace:
        nw.trace = cells
    h = djb2_str(res.edit_trace, djb2_init())
    if calc_debug_trace:
        h = djb2_ints(cells, h)
    res.trace_hash = h
    return Status.success


def _stored_header_overlay(nw: AlgInput):
    """Returns overlay(i, row) that replaces a recomputed row's cells
    with the KERNEL-STORED tile-header values where they exist — tile
    header rows wholesale, tile header-column cells otherwise — or None
    when the sparse mats are absent.

    This is what makes the sparse score hash a real kernel check: the
    reference intends the same (ref: src/nwtrace2_sparse.cpp:295-309
    loads tileHrowMat/tileHcolMat elements into the hash stream; its
    GetTileAndElemIJ quirk mostly disables the loads — we implement the
    intent). For a CORRECT kernel, stored == recomputed, so the hash
    value (and score print) is bit-identical to the dense byte stream;
    a kernel store-indexing bug now surfaces as errstep 5 instead of
    vanishing into a from-scratch recompute. Overlaid rows feed the
    rolling recurrence, so a bad stored value also propagates downward,
    like the reference's prevRow."""
    if (nw.tileHrowMat is None or nw.tileHcolMat is None
            or nw.tile_hrow_len < 2 or nw.tile_hcol_len < 2
            or nw.tile_hdr_mat_rows < 1 or nw.tile_hdr_mat_cols < 1):
        return None
    th = nw.tile_hcol_len - 1
    tw = nw.tile_hrow_len - 1
    C = nw.tile_hdr_mat_cols
    Rt = nw.tile_hdr_mat_rows
    adjc = nw.adjcols
    hrow = np.asarray(nw.tileHrowMat).reshape(Rt * C, nw.tile_hrow_len)
    hcol = np.asarray(nw.tileHcolMat).reshape(Rt * C, nw.tile_hcol_len)
    jts = np.arange(C, dtype=np.int64) * tw
    jmask = (jts < adjc) & (jts != adjc - 1)
    jsel = jts[jmask]

    def overlay(i: int, row: np.ndarray) -> None:
        it, ie = divmod(i, th)
        if it == Rt:  # saturated last row (get_tile_and_elem_ij)
            it -= 1
            ie += th
        if ie == 0 and i != nw.adjrows - 1 and it < Rt:
            # Full stored header row: each tile's first tw entries plus
            # the last tile's final (boundary) entry.
            mat = hrow[it * C: (it + 1) * C]
            stored = np.concatenate([mat[:, :tw].ravel(), mat[-1, tw:]])
            n = min(adjc, stored.size)
            row[:n] = stored[:n]
        else:
            # Stored header-column cells of this row (the last header
            # column isn't stored — reference skips it too).
            row[jsel] = hcol[it * C: (it + 1) * C, ie][jmask]

    return overlay


def _recompute_rows(nw: AlgInput):
    """Yield every row of the full logical score matrix, recomputed with
    rolling rows, with kernel-stored tile-header values substituted where
    stored (observable behavior of ref: src/nwtrace2_sparse.cpp:263-340
    for NW_LG; same construction for the extension specs)."""
    is_sw = nw.spec.kind == AlignKind.SW
    affine = nw.spec.gap == GapKind.AFFINE
    go = np.int32(nw.gapo_cost)
    ge = np.int32(nw.gape_cost)
    ninf = np.int32(NEG_INF_I32)
    adjcols = nw.adjcols
    xs = nw.seqX[1:]
    offs_g = (np.arange(adjcols, dtype=np.int64) * int(go)).astype(np.int32)
    offs_e = (np.arange(adjcols, dtype=np.int64) * int(ge)).astype(np.int32)

    overlay = _stored_header_overlay(nw)

    if is_sw:
        row = np.zeros(adjcols, np.int32)
    elif affine:
        row = (go + offs_e).astype(np.int32)
        row[0] = 0
    else:
        row = offs_g.copy()
    if overlay is not None:
        overlay(0, row)
    yield row
    prev = row
    fprev = np.full(adjcols, ninf, np.int32)
    for i in range(1, nw.adjrows):
        srow = nw.subst[nw.seqY[i], xs]
        if not affine:
            cand = np.maximum(prev[:-1] + srow, prev[1:] + go).astype(np.int32)
            if is_sw:
                np.maximum(cand, np.int32(0), out=cand)
                prev = _row_chain_max(cand, 0, nw.gapo_cost)
                np.maximum(prev, np.int32(0), out=prev)
            else:
                prev = _row_chain_max(
                    cand, int(np.int32(i) * go), nw.gapo_cost
                )
        else:
            frow = (np.maximum(fprev, prev + go) + ge).astype(np.int32)
            frow[0] = ninf
            v = np.maximum(prev[:-1] + srow, frow[1:]).astype(np.int32)
            if is_sw:
                h0 = np.int32(0)
                np.maximum(v, np.int32(0), out=v)
            else:
                h0 = np.int32(int(go) + i * int(ge))
            vfull = np.empty(adjcols, np.int32)
            vfull[0] = 0 if is_sw else h0
            vfull[1:] = v
            m = (vfull + go - offs_e).astype(np.int32)
            np.maximum.accumulate(m, out=m)
            erow1 = (m[:-1] + offs_e[1:]).astype(np.int32)
            nxt = np.empty(adjcols, np.int32)
            nxt[0] = 0 if is_sw else h0
            nxt[1:] = np.maximum(v, erow1)
            if is_sw:
                np.maximum(nxt, np.int32(0), out=nxt)
            fprev = frow
            prev = nxt
        if overlay is not None:
            overlay(i, prev)
        yield prev


def hash_sparse(nw: AlgInput, res: AlgResult) -> Status:
    sw = res.sw_hash
    sw.start()
    h = _hash_sparse_value(nw)
    res.score_hash = h
    sw.lap("hash.calc")
    return Status.success


def _hash_sparse_value(nw: AlgInput) -> int:
    """Native C++ fast path (~15x on big pairs) with the Python rolling
    recompute as the reference implementation and fallback; both read the
    kernel-stored tile headers (see _stored_header_overlay)."""
    try:
        from .. import native

        if native.available():
            has_mats = (
                nw.tileHrowMat is not None and nw.tileHcolMat is not None
                and nw.tile_hrow_len >= 2 and nw.tile_hcol_len >= 2
                and nw.tile_hdr_mat_rows >= 1 and nw.tile_hdr_mat_cols >= 1
            )
            return native.hash_sparse_native(
                nw.subst, nw.seqY, nw.seqX, nw.gapo_cost, nw.gape_cost,
                nw.spec.kind.value, nw.spec.gap.value,
                nw.tileHrowMat if has_mats else None,
                nw.tileHcolMat if has_mats else None,
                nw.tile_hcol_len - 1, nw.tile_hrow_len - 1,
                nw.tile_hdr_mat_rows, nw.tile_hdr_mat_cols,
                seed=djb2_init(),
            )
    except Exception:
        pass
    h = djb2_init()
    for row in _recompute_rows(nw):
        h = djb2_array(row, h)
    return h


def print_score_sparse(os: TextIO, nw: AlgInput, res: AlgResult) -> Status:
    """(ref: src/nwtrace2_sparse.cpp:346-419)"""
    for row in _recompute_rows(nw):
        os.write("".join(f"{int(v):4d}," for v in row))
        os.write("\n")
    return Status.success
