"""Core run types.

PyTorch/CUDA port of the reference's run_types (ref: src/run_types.hpp:12-151).
All DP arithmetic is int32 end-to-end so results are bit-exact and
deterministic across the CPU oracle, the plain PyTorch fill and the
CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.spans import span
from ..utils.stopwatch import Stopwatch


class Status(enum.IntEnum):
    """Run status codes (ref: src/run_types.hpp:12-24, same order/values)."""

    success = 0
    helpMenuRequested = 1
    errorDeviceGeneral = 2  # ref: errorCudaGeneral
    errorMemoryAllocation = 3
    errorMemoryTransfer = 4
    errorKernelFailure = 5
    errorIoStream = 6
    errorInvalidFormat = 7
    errorInvalidValue = 8
    errorInvalidResult = 9


@dataclasses.dataclass
class Range:
    """Half-open subsequence range [l, r) (ref: src/run_types.hpp:26-35).

    Equality compares only l/r, not the not-default flags
    (ref: src/run_types.cpp:5-14).
    """

    l: int = 0
    r: int = 0
    l_not_default: bool = False
    r_not_default: bool = False

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Range):
            return NotImplemented
        return self.l == other.l and self.r == other.r

    def __hash__(self) -> int:
        return hash((self.l, self.r))

    def id_suffix(self) -> str:
        """Render the ``[l:r]`` suffix like the TSV writer does
        (ref: src/file_formats.cpp:433-453): only when not default."""
        if not (self.l_not_default or self.r_not_default):
            return ""
        ls = str(self.l) if self.l_not_default else ""
        rs = str(self.r) if self.r_not_default else ""
        return f"[{ls}:{rs}]"


def default_range(seq_len_no_header: int) -> Range:
    return Range(l=0, r=seq_len_no_header, l_not_default=False, r_not_default=False)


@dataclasses.dataclass
class SeqPair:
    """One alignment job: Y (rows) vs X (cols) with optional subranges
    (ref: src/file_formats.hpp pair types)."""

    seqY_id: str = ""
    seqX_id: str = ""
    seqY_range: Range = dataclasses.field(default_factory=Range)
    seqX_range: Range = dataclasses.field(default_factory=Range)


class AlignKind(enum.Enum):
    NW = "nw"  # global (Needleman-Wunsch)
    SW = "sw"  # local (Smith-Waterman)


class GapKind(enum.Enum):
    LINEAR = "linear"
    AFFINE = "affine"


@dataclasses.dataclass(frozen=True)
class AlignSpec:
    """Which alignment problem to solve.

    The reference implements only NW + linear gap (ref: README.md:7-26,
    src/cmd_parser.cpp:143 documents --gapeCost as unused). NW_AG / SW_LG /
    SW_AG are capability extensions verified against our own oracle
    (SURVEY.md intro).

    Linear-gap recurrence (bit-parity surface, ref: src/nwalign_cpu1_st_row.cpp:4-10):
        H[i,j] = max(H[i-1,j-1] + subst[Y[i],X[j]], H[i-1,j] + gapo, H[i,j-1] + gapo)
        H[i,0] = i*gapo ; H[0,j] = j*gapo

    Affine-gap (Gotoh) recurrence (our definition; gapo = open, gape = extend,
    both <= 0; a gap of length k costs gapo + k*gape):
        E[i,j] = max(E[i,j-1], H[i,j-1] + gapo) + gape        (gap in Y, move right)
        F[i,j] = max(F[i-1,j], H[i-1,j] + gapo) + gape        (gap in X, move down)
        H[i,j] = max(H[i-1,j-1] + subst[Y[i],X[j]], E[i,j], F[i,j])
        H[i,0] = gapo + i*gape ; H[0,j] = gapo + j*gape ; H[0,0] = 0
        E[i,0] = F[0,j] = -inf/2

    SW variants clamp H at 0, use zero headers, score = max cell, and the
    traceback starts at the max cell (smallest i, then j on ties) and stops
    at the first 0 cell.
    """

    kind: AlignKind = AlignKind.NW
    gap: GapKind = GapKind.LINEAR

    @property
    def name(self) -> str:
        return f"{self.kind.value}_{'lg' if self.gap == GapKind.LINEAR else 'ag'}"

    @staticmethod
    def from_name(name: str) -> "AlignSpec":
        kind, gap = name.lower().split("_")
        return AlignSpec(
            kind=AlignKind(kind),
            gap=GapKind.LINEAR if gap == "lg" else GapKind.AFFINE,
        )


# Sentinel for -inf in int32 DP lanes: low enough to never win a max, high
# enough that adding gap costs cannot underflow int32.
NEG_INF_I32 = -(2**30)


class AlgParams:
    """Cartesian-product parameter odometer (ref: src/run_types.cpp:69-83).

    Each parameter is a list of ints; ``next()`` increments the LAST
    parameter first, carrying leftwards; iteration ends after the full
    product. Dict insertion order (= JSON file order) is preserved.
    """

    def __init__(self, params: Optional[Dict[str, List[int]]] = None):
        self._values: Dict[str, List[int]] = dict(params or {})
        for name, vals in self._values.items():
            if not vals:
                # An empty list has no current combination; at() would
                # IndexError mid-benchmark. io/params.py rejects this at
                # parse time; guard programmatic construction too.
                raise ValueError(f'empty parameter value list: "{name}"')
        self._idx: Dict[str, int] = {k: 0 for k in self._values}
        self._is_end = False

    def at(self, name: str) -> int:
        return self._values[name][self._idx[name]]

    def get(self, name: str, default: Optional[int] = None) -> Optional[int]:
        if name not in self._values:
            return default
        return self.at(name)

    def has_curr(self) -> bool:
        return not self._is_end

    def next(self) -> None:
        for name in reversed(list(self._values.keys())):
            self._idx[name] += 1
            if self._idx[name] < len(self._values[name]):
                return
            self._idx[name] = 0
        self._is_end = True

    def reset(self) -> None:
        for name in self._values:
            self._idx[name] = 0
        self._is_end = False

    def copy_current(self) -> Dict[str, int]:
        """Snapshot of the current combination (ref: NwAlgParams::copy)."""
        return {k: self._values[k][self._idx[k]] for k in self._values}


@dataclasses.dataclass
class AlgInput:
    """Mutable per-run inputs and scratch (ref: src/run_types.hpp:70-110).

    ``seqX``/``seqY`` are int32 numpy arrays INCLUDING the prepended header
    element 0 (ref: src/file_formats.cpp:43-47), so ``adjrows == len(seqY)``
    and ``adjcols == len(seqX)`` already count the DP header row/column.
    """

    subst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.int32)
    )
    seqX: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    seqY: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))

    # Dense representation: full (adjrows, adjcols) score matrix.
    score: Optional[np.ndarray] = None

    # Sparse (mlsp) representation: per-tile header row / column matrices,
    # laid out exactly like the reference (ref: src/nwalign_gpu7_mlsp_diagdiag.cu:348-352):
    # tileHrowMat: (tile_hdr_mat_rows*tile_hdr_mat_cols, tileHrowLen) row-major
    # tileHcolMat: (tile_hdr_mat_rows*tile_hdr_mat_cols, tileHcolLen) row-major
    tileHrowMat: Optional[np.ndarray] = None
    tileHcolMat: Optional[np.ndarray] = None
    tile_hdr_mat_rows: int = 0
    tile_hdr_mat_cols: int = 0
    tile_hrow_len: int = 0
    tile_hcol_len: int = 0
    # Affine-gap extension of the sparse layout (no reference analog — the
    # reference never implemented affine, ref: README.md:26): a tile's
    # incoming dependencies under Gotoh are (H, F) along its top row and
    # (H, E) along its left column, so two more header matrices with the
    # same layouts carry the F-row / E-col values.
    tileFrowMat: Optional[np.ndarray] = None
    tileEcolMat: Optional[np.ndarray] = None

    # Debug trace of visited cell values (ref: NwAlgInput::trace).
    trace: Optional[List[int]] = None

    substsz: int = 0
    adjrows: int = 0
    adjcols: int = 0
    gapo_cost: int = 0
    gape_cost: int = 0
    spec: AlignSpec = dataclasses.field(default_factory=AlignSpec)

    # Device the fills run on ("cuda" or "cpu"), and its caps
    # (ref: sm_count/warpsz/maxThreadsPerBlock).
    device: str = "cuda"
    core_count: int = 0

    # For SW: position of the maximum cell (traceback start).
    best_i: int = 0
    best_j: int = 0

    # Peak memory accounting (bytes).
    host_peak_bytes: int = 0
    device_peak_bytes: int = 0

    def note_host_alloc(self) -> None:
        total = 0
        for arr in (self.subst, self.seqX, self.seqY, self.score,
                    self.tileHrowMat, self.tileHcolMat,
                    self.tileFrowMat, self.tileEcolMat):
            if arr is not None:
                total += arr.nbytes
        self.host_peak_bytes = max(self.host_peak_bytes, total)

    def note_device_alloc(self, nbytes: int) -> None:
        self.device_peak_bytes = max(self.device_peak_bytes, nbytes)

    def reset_cycle(self) -> None:
        """Per-(pair,param,repeat) reset (ref: resetAllocsBenchmarkCycle);
        the freeing of the headers' host copies is the span
        ``align.reset``."""
        with span("align.reset"):
            self.score = None
            self.tileHrowMat = None
            self.tileHcolMat = None
            self.tileFrowMat = None
            self.tileEcolMat = None
            self.trace = None
        # Peaks are PER-CYCLE (the reference recomputes allocation totals
        # after each cycle reset): without this, a small pair benchmarked
        # after a large one reports the large pair's footprint in its
        # ram/glmem TSV columns. The input sequences survive the reset,
        # so re-note the current baseline.
        self.host_peak_bytes = 0
        self.device_peak_bytes = 0
        self.note_host_alloc()


def make_alg_input(subst: np.ndarray, seqY: np.ndarray, seqX: np.ndarray,
                   gapo: int, gape: int, spec_name: str,
                   device: str = "cuda") -> AlgInput:
    """Build an AlgInput from numpy data as gpuseqalign_tpu's AlgInput
    holds it: ``subst`` (S, S) and header-prefixed ``seqY``/``seqX``, all
    int32. Lets the same problem be handed to both packages."""
    nw = AlgInput()
    nw.subst = np.ascontiguousarray(subst, dtype=np.int32)
    nw.substsz = nw.subst.shape[0]
    nw.seqY = np.ascontiguousarray(seqY, dtype=np.int32)
    nw.seqX = np.ascontiguousarray(seqX, dtype=np.int32)
    nw.adjrows = len(nw.seqY)
    nw.adjcols = len(nw.seqX)
    nw.gapo_cost = int(gapo)
    nw.gape_cost = int(gape)
    nw.spec = AlignSpec.from_name(spec_name)
    nw.device = device
    return nw


@dataclasses.dataclass
class AlgResult:
    """Per-run result record (ref: src/run_types.hpp:112-151)."""

    alg_name: str = ""
    alg_params: Dict[str, int] = dataclasses.field(default_factory=dict)
    seqY_idx: int = 0
    seqX_idx: int = 0
    seqY_id: str = ""
    seqX_id: str = ""
    seqY_range: Range = dataclasses.field(default_factory=Range)
    seqX_range: Range = dataclasses.field(default_factory=Range)

    errstep: int = 0  # 0 ok; 1 params; 2 align; 3 hash; 4 trace; 5 verify
    stat: Status = Status.success
    device_stat: int = 0  # ref: cudaStat
    # Exception class + message when an align/hash/trace raised (extension
    # column; the reference only records the raw cudaError_t code).
    error_msg: str = ""

    seqY_len: int = 0
    seqX_len: int = 0
    subst_name: str = ""
    gapo_cost: int = 0
    gape_cost: int = 0
    align_kind: str = "nw_lg"  # AlignSpec name (extension column)
    warmup_runs: int = 0
    sample_runs: int = 0
    last_run_idx: int = 0

    align_cost: int = 0
    score_hash: int = 0
    trace_hash: int = 0

    core_count: int = 0
    ram_peak_allocs: int = 0
    glmem_peak_allocs: int = 0  # HBM
    shmem_peak_allocs: int = 0  # VMEM
    locmem_peak_allocs: int = 0
    regmem_peak_allocs: int = 0

    sw_align: Stopwatch = dataclasses.field(default_factory=Stopwatch)
    sw_hash: Stopwatch = dataclasses.field(default_factory=Stopwatch)
    sw_trace: Stopwatch = dataclasses.field(default_factory=Stopwatch)

    edit_trace: str = ""

    def update_peak_mem(self, nw: AlgInput) -> None:
        nw.note_host_alloc()
        self.ram_peak_allocs = max(self.ram_peak_allocs, nw.host_peak_bytes)
        self.glmem_peak_allocs = max(self.glmem_peak_allocs, nw.device_peak_bytes)
