"""The yardstick: the least time an NVIDIA H100 could take for a request.

Frozen here, so that no change to the program moves it. The bound of a
request is the larger of

- its operations: live DP cells x int32 instructions a cell of the spec,
  over the card's issue rate, and
- its bytes: each pair's two sequences and the matrix read once (int32),
  and one [cost, best_i, best_j] written a pair, over the HBM bandwidth.

It counts the work the answers need, not what a kernel does: every live
cell (rows x cols a pair), no padding, no header or carry traffic.

Issue rate: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz, one warp
instruction a clock a scheduler (half the data sheet's 67 TFLOP/s FP32).
Instructions a cell on sm_90a, where each add that feeds a max fuses into
one DPX VIADDMNMX: NW linear 3 (VIMNMX, VIADD, VIADDMNMX), SW linear 4
(the same with .RELU, one ISETP for the best cell), NW affine 6 (3
VIADDMNMX, 2 VIADD, VIMNMX), SW affine 7. HBM: 3.35 TB/s (NVIDIA's data
sheet, H100 SXM). These are copied from the port's
``bench/vpu_probe.py`` (``ISSUE_INSNS_PER_S``, ``INSNS_PER_CELL``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

ISSUE_INSNS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
INSNS_PER_CELL = {"nw_lg": 3, "sw_lg": 4, "nw_ag": 6, "sw_ag": 7}
WORD = 4
ANSWER_WORDS = 3

Pairs = Sequence[Tuple[np.ndarray, np.ndarray]]


def live_cells(pairs: Pairs) -> int:
    """DP cells the answers need: rows x cols of every pair."""
    return sum((len(y) - 1) * (len(x) - 1) for y, x in pairs)


def bytes_needed(pairs: Pairs, letters: int) -> int:
    """Inputs read once and answers written once."""
    residues = sum(len(y) - 1 + len(x) - 1 for y, x in pairs)
    return WORD * (residues + letters * letters + ANSWER_WORDS * len(pairs))


def bound_s(algorithm: str, pairs: Pairs, letters: int) -> float:
    """The least seconds the card could take for these pairs."""
    ops = live_cells(pairs) * INSNS_PER_CELL[algorithm] / ISSUE_INSNS_PER_S
    return max(ops, bytes_needed(pairs, letters) / HBM_BYTES_PER_S)
