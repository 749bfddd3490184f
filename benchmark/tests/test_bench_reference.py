"""The plain reference against a cell-by-cell loop written here and against
the port's CPU route (the batch engine on the CPU and the port's oracle),
on small pairs of every spec, SW best cells and their ties among them."""

import json
import os

import numpy as np
import pytest

from benchmark.reference import dp
from conftest import ROOT

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPS = {"nw_lg": (-11, 0), "sw_lg": (-11, 0), "nw_ag": (-11, -1),
        "sw_ag": (-11, -1)}
NEG = -(2 ** 40)


def _config(name="upstream_nw_lg"):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


SUBST = dp.matrix(_config())
LETTERS = _config()["letters"]


def _seq(text):
    return np.array([0] + [LETTERS.index(c) for c in text], np.int32)


def _loop(y, x, algorithm, go, ge):
    """Every cell in turn, in Python integers: [cost, best_i, best_j]."""
    sw, affine = algorithm.startswith("sw"), algorithm.endswith("ag")
    R, C = len(y) - 1, len(x) - 1
    H = [[0] * (C + 1) for _ in range(R + 1)]
    E = [[NEG] * (C + 1) for _ in range(R + 1)]
    F = [[NEG] * (C + 1) for _ in range(R + 1)]
    if not sw:
        for j in range(1, C + 1):
            H[0][j] = go + j * ge if affine else j * go
        for i in range(1, R + 1):
            H[i][0] = go + i * ge if affine else i * go
    best = (0, 0, 0)
    for i in range(1, R + 1):
        for j in range(1, C + 1):
            diag = H[i - 1][j - 1] + int(SUBST[y[i], x[j]])
            if affine:
                E[i][j] = max(E[i][j - 1], H[i][j - 1] + go) + ge
                F[i][j] = max(F[i - 1][j], H[i - 1][j] + go) + ge
                h = max(diag, E[i][j], F[i][j])
            else:
                h = max(diag, H[i - 1][j] + go, H[i][j - 1] + go)
            H[i][j] = max(h, 0) if sw else h
            if sw and H[i][j] > best[0]:
                best = (H[i][j], i, j)
    return list(best) if sw else [H[R][C], 0, 0]


def _pairs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r, c = rng.integers(lo, hi, 2)
        out.append((np.concatenate([[0], rng.integers(0, 20, r)]).astype(
            np.int32), np.concatenate([[0], rng.integers(0, 20, c)]).astype(
            np.int32)))
    return out


TIES = [("W", "WAW"), ("WAW", "W"), ("W", "C"), ("CWC", "CWC"),
        ("WW", "WW"), ("HWAHW", "WHW"), ("A", "A"), ("KKK", "K")]


@pytest.mark.parametrize("algorithm", SPECS)
def test_reference_equals_the_cell_loop(algorithm):
    go, ge = GAPS[algorithm]
    pairs = _pairs(7, 12, 1, 40) + [(_seq(a), _seq(b)) for a, b in TIES]
    got = dp.align(pairs, SUBST, algorithm=algorithm, gapo=go, gape=ge)
    want = [_loop(y, x, algorithm, go, ge) for y, x in pairs]
    assert got.tolist() == want


@pytest.mark.parametrize("algorithm", ["sw_lg", "sw_ag"])
def test_sw_ties_take_the_first_cell_in_row_major_order(algorithm):
    go, ge = GAPS[algorithm]
    pairs = [(_seq(a), _seq(b)) for a, b in TIES]
    got = dp.align(pairs, SUBST, algorithm=algorithm, gapo=go, gape=ge)
    w = int(SUBST[LETTERS.index("W"), LETTERS.index("W")])
    assert got[0].tolist() == [w, 1, 1]  # W against W_W: the left one
    assert got[1].tolist() == [w, 1, 1]  # the upper one
    assert got[2].tolist() == [0, 0, 0]  # no cell above 0


@pytest.mark.parametrize("algorithm", SPECS)
def test_reference_equals_the_port_s_cpu_route(algorithm):
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.models.oracle import (align_cost_of,
                                                     oracle_align_dense)
    from gpuseqalign_tpu_torch.parallel import align_pairs_batched

    go, ge = GAPS[algorithm]
    spec = AlignSpec.from_name(algorithm)
    pairs = (_pairs(11, 10, 1, 300)
             + [(_seq(a), _seq(b)) for a, b in TIES])
    got = dp.align(pairs, SUBST, algorithm=algorithm, gapo=go, gape=ge)
    out = align_pairs_batched(spec, SUBST, pairs, go, ge, quantum="pow2",
                              device="cpu")
    cols = 3 if algorithm.startswith("sw") else 1
    port = np.stack([out.costs, out.best_i, out.best_j], 1)[:, :cols]
    assert (got[:, :cols] == port).all()
    for (y, x), row in zip(pairs, got):
        mats = oracle_align_dense(spec, SUBST, y, x, go, ge)
        assert row[0] == align_cost_of(spec, mats)
        if "best" in mats and row[0] > 0:
            assert tuple(row[1:]) == tuple(mats["best"])


@pytest.mark.parametrize("algorithm", SPECS)
def test_sixteen_bits_read_the_same_while_the_values_fit(algorithm):
    go, ge = GAPS[algorithm]
    pairs = _pairs(3, 6, 20, 200)
    full = dp.align(pairs, SUBST, algorithm=algorithm, gapo=go, gape=ge)
    narrow = dp.align(pairs, SUBST, algorithm=algorithm, gapo=go, gape=ge,
                      bits=16)
    assert (full == narrow).all()


def test_narrow_controls_saturate():
    # 40 rows against 3100 columns: the NW cost is below -32768.
    wide = _pairs(5, 1, 40, 41)[0][0], _pairs(6, 1, 3100, 3101)[0][1]
    full = dp.align([wide], SUBST, algorithm="nw_lg", gapo=-11, gape=0)
    narrow = dp.align([wide], SUBST, algorithm="nw_lg", gapo=-11, gape=0,
                      bits=16)
    assert full[0, 0] < -(2 ** 15) and narrow[0, 0] == -(2 ** 15)
    # A protein against itself: an SW score far above 127.
    y = _pairs(8, 1, 60, 61)[0][0]
    full = dp.align([(y, y)], SUBST, algorithm="sw_ag", gapo=-11, gape=-1)
    narrow = dp.align([(y, y)], SUBST, algorithm="sw_ag", gapo=-11, gape=-1,
                      bits=8)
    assert full[0, 0] > 127 and narrow[0, 0] == 127


def test_matrix_is_blosum62_in_both_configurations():
    a, b = _config("upstream_nw_lg"), _config("blastp_sw_ag")
    assert (dp.matrix(a) == dp.matrix(b)).all()
    m = dp.matrix(a)
    assert (m == m.T).all()
    # Spot checks against NCBI's BLOSUM62: W/W 11, C/C 9, A/A 4, W/C -2.
    idx = {c: k for k, c in enumerate(a["letters"])}
    assert m[idx["W"], idx["W"]] == 11 and m[idx["C"], idx["C"]] == 9
    assert m[idx["A"], idx["A"]] == 4 and m[idx["W"], idx["C"]] == -2


@pytest.mark.parametrize("bits", [32, 16, 8])
@pytest.mark.parametrize("algorithm", SPECS)
def test_chunked_reference_equals_one_call(monkeypatch, algorithm, bits):
    """``harness.reference_answers`` in chunks (a budget that forces many)
    gives what one ``dp.align`` over the whole pool gives, in input order."""
    from benchmark import harness

    go, ge = GAPS[algorithm]
    cfg = dict(_config(), algorithm=algorithm, gapo=go, gape=ge)
    cell = type("Cell", (), {"config": cfg})()
    # Three requests of mixed widths and heights, one pair wider than the
    # budget.
    wide = (_pairs(25, 1, 3, 4)[0][0], _pairs(26, 1, 700, 701)[0][1])
    pool = [_pairs(21, 17, 1, 90),
            _pairs(22, 16, 1, 30) + _pairs(24, 1, 5, 6) + [wide],
            _pairs(23, 9, 40, 160)]
    flat = [p for pairs in pool for p in pairs]
    assert len(flat) >= 40
    budget = 600
    n_chunks = len(harness.chunks(flat, budget))
    assert n_chunks >= 5
    calls = []
    align = dp.align
    monkeypatch.setattr(dp, "align", lambda pairs, *a, **k: calls.append(
        len(pairs)) or align(pairs, *a, **k))
    monkeypatch.setattr(harness, "REFERENCE_ELEMENTS", budget)
    got = harness.reference_answers(cell, pool, SUBST, "cpu", bits=bits)
    assert len(calls) == n_chunks and sum(calls) == len(flat)
    want = align(flat, SUBST, algorithm=algorithm, gapo=go, gape=ge,
                 bits=bits)
    assert [len(a) for a in got] == [len(p) for p in pool]
    assert (np.concatenate(got) == want).all()


def test_chunks_cover_every_pair_once_within_the_budget():
    from benchmark import harness

    pairs = _pairs(31, 60, 1, 200)
    budget = 2000
    parts = harness.chunks(pairs, budget)
    idx = np.concatenate(parts)
    assert sorted(idx.tolist()) == list(range(len(pairs)))
    for part in parts:
        widest = max(max(len(pairs[b][0]), len(pairs[b][1])) - 1
                     for b in part)
        assert len(part) == 1 or len(part) * (widest + 1) <= budget


@pytest.mark.parametrize("cell", ["upstream_nw_lg.pg1",
                                  "blastp_sw_ag.allvsall20",
                                  "upstream_nw_lg.release"])
def test_the_first_cells_reference_is_one_call(cell):
    """At their real sizes the first three cells' pools fit one chunk: the
    reference makes the one ``dp.align`` call it made before chunks."""
    from benchmark import generate, harness

    c = harness.Cell(cell, ROOT)
    pool = generate.make_pool(c.traffic, c.config, 1)
    flat = [p for pairs in pool for p in pairs]
    assert len(harness.chunks(flat, harness.REFERENCE_ELEMENTS)) == 1
