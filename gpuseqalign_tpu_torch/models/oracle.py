"""CPU oracle: the source of truth every device kernel is verified against.

For NW + linear gap this reproduces the reference oracle bit-exactly
(ref: src/nwalign_cpu1_st_row.cpp:4-67, src/nwtrace1_plain.cpp). For the
capability extensions (NW affine, SW linear/affine) — which the reference
advertises but does not implement (ref: README.md:26) — this module DEFINES
the semantics; see core.types.AlignSpec for the recurrences.

Implementation note: rows are computed with a max-plus
prefix scan instead of a sequential j loop —
    curr[j] = max(cand[j], curr[j-1] + g)
          == max_{k<=j} (cand[k] + (j-k)*g)
          == accumulate-max(cand[k] - k*g) + j*g
which is exactly the formulation of the plain PyTorch fill
(ops/mlsp_plain.py). All arithmetic is int32 (wrapping, like the C++ int).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.hashing import djb2_array, djb2_ints, djb2_str, djb2_init
from ..core.transcript import rle_from_edits
from ..core.types import AlignKind, AlignSpec, GapKind, NEG_INF_I32


def _check_affine_costs(gapo: int, gape: int) -> None:
    # The vectorized affine sweep relies on gap-open cost <= 0 (reopening a
    # gap never beats extending it); scores use negative penalties.
    if gapo > 0 or gape > 0:
        raise ValueError("affine oracle requires gapo <= 0 and gape <= 0")


def _row_chain_max(cand: np.ndarray, first: int, g: int) -> np.ndarray:
    """Solve curr[0]=first; curr[j]=max(cand[j], curr[j-1]+g) vectorized.

    cand has length cols (entries for j=1..cols); returns length cols+1.
    """
    adjcols = cand.shape[0] + 1
    offs = (np.arange(adjcols, dtype=np.int32) * np.int32(g)).astype(np.int32)
    a = np.empty(adjcols, dtype=np.int32)
    a[0] = first
    a[1:] = cand
    m = a - offs
    np.maximum.accumulate(m, out=m)
    return (m + offs).astype(np.int32)


def oracle_align_dense(
    spec: AlignSpec,
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int = 0,
) -> Dict[str, np.ndarray]:
    """Fill the dense DP matrices.

    seqY/seqX include the header 0 element; returns dict with:
      'H' (adjrows, adjcols) int32; for affine also 'E', 'F';
      'best' = (i, j) argmax cell for SW (row-major first occurrence).
    """
    seqY = np.asarray(seqY, dtype=np.int32)
    seqX = np.asarray(seqX, dtype=np.int32)
    adjrows, adjcols = len(seqY), len(seqX)
    g = np.int32(gapo)
    is_sw = spec.kind == AlignKind.SW

    if spec.gap == GapKind.LINEAR:
        H = np.empty((adjrows, adjcols), dtype=np.int32)
        if is_sw:
            H[0, :] = 0
            H[:, 0] = 0
        else:
            H[0, :] = np.arange(adjcols, dtype=np.int32) * g
            H[:, 0] = np.arange(adjrows, dtype=np.int32) * g

        xs = seqX[1:]
        for i in range(1, adjrows):
            prev = H[i - 1]
            srow = subst[seqY[i], xs]
            cand = np.maximum(prev[:-1] + srow, prev[1:] + g).astype(np.int32)
            if is_sw:
                np.maximum(cand, np.int32(0), out=cand)
                H[i] = np.maximum(_row_chain_max(cand, 0, gapo), np.int32(0))
            else:
                H[i] = _row_chain_max(cand, int(np.int32(i) * g), gapo)

        out: Dict[str, np.ndarray] = {"H": H}
        if is_sw:
            flat = int(np.argmax(H))
            out["best"] = np.array(divmod(flat, adjcols), dtype=np.int64)
        return out

    # Affine (Gotoh).
    _check_affine_costs(gapo, gape)
    go = np.int32(gapo)
    ge = np.int32(gape)
    ninf = np.int32(NEG_INF_I32)

    H = np.empty((adjrows, adjcols), dtype=np.int32)
    E = np.full((adjrows, adjcols), ninf, dtype=np.int32)
    F = np.full((adjrows, adjcols), ninf, dtype=np.int32)

    if is_sw:
        H[0, :] = 0
        H[:, 0] = 0
    else:
        H[0, 0] = 0
        j_idx = np.arange(1, adjcols, dtype=np.int32)
        H[0, 1:] = go + j_idx * ge
        i_idx = np.arange(1, adjrows, dtype=np.int32)
        H[1:, 0] = go + i_idx * ge

    xs = seqX[1:]
    offs = np.arange(adjcols, dtype=np.int32) * ge
    for i in range(1, adjrows):
        hprev = H[i - 1]
        fprev = F[i - 1]
        frow = (np.maximum(fprev, hprev + go) + ge).astype(np.int32)
        frow[0] = ninf
        F[i] = frow

        srow = subst[seqY[i], xs]
        v = np.maximum(hprev[:-1] + srow, frow[1:]).astype(np.int32)  # j=1..cols

        # E[j] = max_{0<=k<j} (Vfull[k] + gapo + (j-k)*gape)
        vfull = np.empty(adjcols, dtype=np.int32)
        vfull[0] = H[i, 0] if not is_sw else np.int32(0)
        vfull[1:] = np.maximum(v, np.int32(0)) if is_sw else v
        m = vfull + go - offs
        np.maximum.accumulate(m, out=m)
        erow = np.empty(adjcols, dtype=np.int32)
        erow[0] = ninf
        erow[1:] = m[:-1] + offs[1:]
        E[i] = erow

        hrow = np.empty(adjcols, dtype=np.int32)
        hrow[0] = H[i, 0]
        hrow[1:] = np.maximum(v, erow[1:])
        if is_sw:
            hrow[1:] = np.maximum(hrow[1:], np.int32(0))
        H[i] = hrow

    out = {"H": H, "E": E, "F": F}
    if is_sw:
        flat = int(np.argmax(H))
        out["best"] = np.array(divmod(flat, adjcols), dtype=np.int64)
    return out


def oracle_align_slow(
    spec: AlignSpec,
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int = 0,
) -> Dict[str, np.ndarray]:
    """Per-cell loop oracle — obviously-correct, for validating the
    vectorized oracle on small inputs (tests only)."""
    seqY = np.asarray(seqY, dtype=np.int64)
    seqX = np.asarray(seqX, dtype=np.int64)
    adjrows, adjcols = len(seqY), len(seqX)
    is_sw = spec.kind == AlignKind.SW

    if spec.gap == GapKind.LINEAR:
        H = np.zeros((adjrows, adjcols), dtype=np.int64)
        if not is_sw:
            H[0, :] = np.arange(adjcols) * gapo
            H[:, 0] = np.arange(adjrows) * gapo
        for i in range(1, adjrows):
            for j in range(1, adjcols):
                p1 = H[i - 1, j - 1] + subst[seqY[i], seqX[j]]
                p2 = H[i - 1, j] + gapo
                p3 = H[i, j - 1] + gapo
                v = max(p1, p2, p3)
                H[i, j] = max(v, 0) if is_sw else v
        out = {"H": H.astype(np.int32)}
        if is_sw:
            flat = int(np.argmax(H))
            out["best"] = np.array(divmod(flat, adjcols), dtype=np.int64)
        return out

    ninf = NEG_INF_I32
    H = np.zeros((adjrows, adjcols), dtype=np.int64)
    E = np.full((adjrows, adjcols), ninf, dtype=np.int64)
    F = np.full((adjrows, adjcols), ninf, dtype=np.int64)
    if not is_sw:
        for j in range(1, adjcols):
            H[0, j] = gapo + j * gape
        for i in range(1, adjrows):
            H[i, 0] = gapo + i * gape
    for i in range(1, adjrows):
        for j in range(1, adjcols):
            E[i, j] = max(E[i, j - 1], H[i, j - 1] + gapo) + gape
            F[i, j] = max(F[i - 1, j], H[i - 1, j] + gapo) + gape
            v = max(H[i - 1, j - 1] + subst[seqY[i], seqX[j]], E[i, j], F[i, j])
            H[i, j] = max(v, 0) if is_sw else v
    out = {
        "H": H.astype(np.int32),
        "E": np.clip(E, NEG_INF_I32, None).astype(np.int32),
        "F": np.clip(F, NEG_INF_I32, None).astype(np.int32),
    }
    if is_sw:
        flat = int(np.argmax(H))
        out["best"] = np.array(divmod(flat, adjcols), dtype=np.int64)
    return out


def _trace_linear_nw(
    H: np.ndarray, seqY: np.ndarray, seqX: np.ndarray, debug: bool
) -> Tuple[List[str], List[int]]:
    """The reference traceback walk, verbatim semantics
    (ref: src/nwtrace1_plain.cpp:29-100): strict value comparisons with
    preference diagonal > up('I') > left('D')."""
    i = H.shape[0] - 1
    j = H.shape[1] - 1
    edits: List[str] = []  # in walk (reverse-path) order
    cells: List[int] = []
    while True:
        if debug:
            cells.append(int(H[i, j]))
        mx = None
        di = dj = 0
        edit = None
        if i > 0 and j > 0:
            mx = int(H[i - 1, j - 1])
            di = dj = -1
            edit = "=" if seqX[j] == seqY[i] else "X"
        if i > 0 and (mx is None or mx < int(H[i - 1, j])):
            mx = int(H[i - 1, j])
            di, dj = -1, 0
            edit = "I"
        if j > 0 and (mx is None or mx < int(H[i, j - 1])):
            mx = int(H[i, j - 1])
            di, dj = 0, -1
            edit = "D"
        i += di
        j += dj
        if edit is not None:
            edits.append(edit)
        if di == 0 and dj == 0:
            break
    return edits, cells


def attain_walk(
    val,
    seqY: np.ndarray,
    seqX: np.ndarray,
    subst: np.ndarray,
    gapo: int,
    gape: int,
    i: int,
    j: int,
    *,
    is_sw: bool,
    affine: bool,
    debug: bool,
) -> Tuple[List[str], List[int]]:
    """THE attainment traceback for SW and affine-gap specs, shared by
    the dense walk (_trace_attain) and the sparse tile-recompute walk
    (trace/sparse.py _trace_sparse_general) so the two can never drift
    edit-for-edit — trace-hash verification depends on them being
    identical.

    ``val(name, i, j) -> int`` reads matrix ``name`` in {"H", "E", "F"}
    (dense arrays / lazy views / tile-recompute — caller's choice).
    Move preference mirrors the reference order: diagonal, then up
    ('I'), then left ('D'). In a gap run, the gap is closed as early as
    possible (prefer exiting to H while walking backwards). Returns
    (edits, debug cells) in reverse path order.
    """
    edits: List[str] = []
    cells: List[int] = []
    state = "H"
    while True:
        if state == "H":
            h_ij = val("H", i, j)
            if debug:
                cells.append(h_ij)
            if is_sw and h_ij == 0:
                break
            if i == 0 and j == 0:
                break
            moved = False
            if i > 0 and j > 0 and h_ij == val("H", i - 1, j - 1) + int(
                subst[seqY[i], seqX[j]]
            ):
                edits.append("=" if seqX[j] == seqY[i] else "X")
                i -= 1
                j -= 1
                moved = True
            elif affine and i > 0 and h_ij == val("F", i, j):
                state = "F"
                moved = True
            elif affine and j > 0 and h_ij == val("E", i, j):
                state = "E"
                moved = True
            elif not affine and i > 0 and h_ij == val("H", i - 1, j) + gapo:
                edits.append("I")
                i -= 1
                moved = True
            elif not affine and j > 0 and h_ij == val("H", i, j - 1) + gapo:
                edits.append("D")
                j -= 1
                moved = True
            if not moved:
                # Header row/column of NW (or numeric dead end): walk the border.
                if i > 0:
                    edits.append("I")
                    i -= 1
                elif j > 0:
                    edits.append("D")
                    j -= 1
                else:
                    break
        elif state == "F":
            if debug:
                cells.append(val("H", i, j))
            edits.append("I")
            closes = val("F", i, j) == val("H", i - 1, j) + gapo + gape
            i -= 1
            if closes:
                state = "H"
                # Walk continues; the H cell is pushed on the next iteration.
            # else stay in F (gap extends upward).
        else:  # state == "E"
            if debug:
                cells.append(val("H", i, j))
            edits.append("D")
            closes = val("E", i, j) == val("H", i, j - 1) + gapo + gape
            j -= 1
            if closes:
                state = "H"
    return edits, cells


def _trace_attain(
    spec: AlignSpec,
    mats: Dict[str, np.ndarray],
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int,
    debug: bool,
) -> Tuple[List[str], List[int]]:
    """Dense-matrix adapter over attain_walk (mats may hold lazy E/F
    views — anything indexable by (i, j))."""
    H = mats["H"]
    is_sw = spec.kind == AlignKind.SW

    def val(name: str, ii: int, jj: int) -> int:
        return int(mats[name][ii, jj])

    if is_sw:
        i, j = (int(v) for v in mats["best"])
    else:
        i, j = H.shape[0] - 1, H.shape[1] - 1
    return attain_walk(
        val, seqY, seqX, subst, gapo, gape, i, j,
        is_sw=is_sw, affine=spec.gap == GapKind.AFFINE, debug=debug,
    )


def oracle_trace_dense(
    spec: AlignSpec,
    mats: Dict[str, np.ndarray],
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int = 0,
    debug: bool = False,
) -> Tuple[str, int, List[int]]:
    """Traceback on dense matrices.

    Returns (edit_trace, trace_hash, visited_cells_in_path_order).
    The trace hash covers transcript chars then (debug only) cell values
    (ref: src/nwtrace1_plain.cpp:113-128).
    """
    if spec.kind == AlignKind.NW and spec.gap == GapKind.LINEAR:
        edits, cells = _trace_linear_nw(mats["H"], seqY, seqX, debug)
    else:
        edits, cells = _trace_attain(
            spec, mats, subst, seqY, seqX, gapo, gape, debug
        )

    edits.reverse()
    cells.reverse()
    transcript = rle_from_edits(edits)

    h = djb2_str(transcript, djb2_init())
    if debug:
        h = djb2_ints(cells, h)
    return transcript, h, cells


def oracle_hash_dense(H: np.ndarray) -> int:
    """Score hash: djb2 over all adjrows x adjcols cells row-major,
    header included (ref: src/nwtrace1_plain.cpp:133-154)."""
    return djb2_array(H)


def align_cost_of(spec: AlignSpec, mats: Dict[str, np.ndarray]) -> int:
    if spec.kind == AlignKind.SW:
        i, j = (int(v) for v in mats["best"])
        return int(mats["H"][i, j])
    return int(mats["H"][-1, -1])
