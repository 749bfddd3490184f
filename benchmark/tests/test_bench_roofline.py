"""The yardstick's arithmetic against counts made by hand."""

import numpy as np
import pytest

from benchmark import generate, roofline
from benchmark.harness import Cell
from conftest import ROOT

ISSUE = 132 * 128 * 1.98e9  # 33.45408e12 warp-lane instructions a second


def test_constants():
    assert roofline.ISSUE_INSNS_PER_S == pytest.approx(33.45408e12)
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INSNS_PER_CELL == {"nw_lg": 3, "sw_lg": 4, "nw_ag": 6,
                                       "sw_ag": 7}


@pytest.mark.parametrize("cell, cells, algorithm, bound_us", [
    # 421 587 456 cells x 3 / 33.45408e12 = 37.806 us
    ("upstream_nw_lg.pg1", 421_587_456, "nw_lg", 37.8059),
    # 948 571 287 cells x 7 / 33.45408e12 = 198.481 us
    ("blastp_sw_ag.allvsall20", 948_571_287, "sw_ag", 198.4810),
    # 23728^2 = 563 017 984 cells x 3 / 33.45408e12 = 50.489 us
    ("upstream_nw_lg.release", 563_017_984, "nw_lg", 50.4891),
])
def test_cells_and_bound_of_each_request(cell, cells, algorithm, bound_us):
    c = Cell(cell, ROOT)
    assert c.config["algorithm"] == algorithm
    pool = generate.make_pool(dict(c.traffic, pool=1), c.config, 1)
    assert roofline.live_cells(pool[0]) == cells
    assert roofline.bound_s(algorithm, pool[0], 25) * 1e6 == pytest.approx(
        bound_us, rel=1e-5)
    # The bytes are far below: every residue and the matrix read once.
    assert roofline.bytes_needed(pool[0], 25) / roofline.HBM_BYTES_PER_S \
        < 0.01 * bound_us * 1e-6


def _pair(r, c):
    return (np.zeros(1 + r, np.int32), np.zeros(1 + c, np.int32))


def test_bytes_by_hand():
    # 3 + 4 residues, 25 x 25 matrix, one answer of 3 words: 4 bytes each.
    assert roofline.bytes_needed([_pair(3, 4)], 25) == 4 * (7 + 625 + 3)
    assert roofline.bytes_needed([_pair(3, 4), _pair(1, 1)], 2) == \
        4 * (9 + 4 + 6)


def test_the_larger_bound_wins():
    # One row against a million columns: 1e6 cells x 3 instructions is
    # 0.0897 us of issue; 4 MB of residues is 1.194 us of HBM.
    pairs = [_pair(1, 1_000_000)]
    assert roofline.live_cells(pairs) == 1_000_000
    ops = 3e6 / ISSUE
    byts = 4 * (1_000_001 + 625 + 3) / 3.35e12
    assert byts > ops
    assert roofline.bound_s("nw_lg", pairs, 25) == pytest.approx(byts)
    square = [_pair(1000, 1000)]
    assert roofline.bound_s("sw_ag", square, 25) == pytest.approx(
        7e6 / ISSUE)
