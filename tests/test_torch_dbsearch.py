"""The database search (``parallel/dbsearch.py``) on the CPU, bit for bit.

A database of seeded random subjects over three column buckets, with an
empty and a one-residue subject, is loaded once; each query's search must
equal the batch engine over the same pairs and the benchmark's plain
reference (``benchmark/reference/dp.py``, which imports nothing of the
port), in input order, for all four specs. On the CPU a query under 1024
rows takes the tiny-pair fill's route (K6's plain version), one of 1024
rows the batched fill's (K5's). The plain fills are also held, at a row
stride of 0 (one query for every pair), against their stacked-row
outputs. No tolerance: every output is int32. This file imports no JAX.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.io.subst import parse_subst_file
from gpuseqalign_tpu_torch.ops import batch_cuda
from gpuseqalign_tpu_torch.ops.batch_plain import (mlsp_fill_batch_plain,
                                                   scores_batch_plain)
from gpuseqalign_tpu_torch.parallel import (SubjectDB, align_pairs_batched,
                                            dbsearch, load_db, make_mesh,
                                            search_db)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO = -11
# Residues of each subject: an empty one and a one-residue one among
# three pow2 column buckets (256, 512, 1024).
SUBJECTS = [40, 0, 300, 5, 600, 1, 257, 30, 3, 260, 9]


def _dp():
    """The benchmark's plain reference, loaded from its file."""
    path = os.path.join(REPO, "benchmark", "reference", "dp.py")
    spec = importlib.util.spec_from_file_location("bench_reference_dp",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def subst():
    return parse_subst_file(
        os.path.join(REPO, "resrc", "subst.json")).subst_map["blosum62"]


def _seq(rng, n):
    return np.concatenate([[0], rng.integers(0, 20, n)]).astype(np.int32)


def _gape(spec):
    return -2 if spec.endswith("ag") else 0


def _answers(res):
    return np.stack([res.costs, res.best_i, res.best_j], 1)


@pytest.mark.parametrize("spec", SPECS)
def test_search_matches_the_batch_engine_and_the_reference(subst, spec):
    rng = np.random.default_rng(19)
    subjects = [_seq(rng, n) for n in SUBJECTS]
    db = load_db(subjects, device="cpu")
    assert isinstance(db, SubjectDB) and len(db) == len(subjects)
    assert len(db.buckets) == 3
    dp = _dp()
    # An empty query, one residue, the tiny-pair route, the batched route.
    for n in (0, 1, 37, 1024):
        query = _seq(rng, n)
        pairs = [(query, s) for s in subjects]
        got = _answers(search_db(AlignSpec.from_name(spec), subst, query,
                                 db, GAPO, _gape(spec)))
        batch = _answers(align_pairs_batched(
            AlignSpec.from_name(spec), subst, pairs, GAPO, _gape(spec),
            quantum="pow2", device="cpu"))
        ref = dp.align(pairs, subst, algorithm=spec, gapo=GAPO,
                       gape=_gape(spec))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, batch, err_msg=f"{spec} {n}")
        np.testing.assert_array_equal(got, ref, err_msg=f"{spec} {n}")


def _homologs(rng, query):
    """The query itself among copies of it with 10% and 30% of its
    residues replaced, a block deleted and a block inserted, as a real
    database holds a query's own entry and its homologs."""
    out = [query.copy()]
    for share in (0.1, 0.3):
        copy = query.copy()
        hit = np.flatnonzero(rng.random(len(query) - 1) < share) + 1
        copy[hit] = rng.integers(0, 20, len(hit))
        out.append(copy)
    cut = len(query) // 3
    out.append(np.concatenate([query[:cut], query[cut + 25:]]))
    out.append(np.concatenate([query[:cut], _seq(rng, 40)[1:],
                               query[cut:]]).astype(np.int32))
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_search_scores_homologs_past_eight_bits(subst, spec):
    """Subjects that share the query's residues score in the thousands,
    past what 8 bits (and, for SW, 16 bits' sign) would saturate at:
    the search must still equal the batch engine and the reference,
    through both routes."""
    rng = np.random.default_rng(53)
    dp = _dp()
    for n in (300, 1100):  # the tiny-pair route, the batched route
        query = _seq(rng, n)
        subjects = [_seq(rng, k) for k in (200, 700)] + _homologs(rng,
                                                                  query)
        db = load_db(subjects, device="cpu")
        pairs = [(query, s) for s in subjects]
        got = _answers(search_db(AlignSpec.from_name(spec), subst, query,
                                 db, GAPO, _gape(spec)))
        batch = _answers(align_pairs_batched(
            AlignSpec.from_name(spec), subst, pairs, GAPO, _gape(spec),
            quantum="pow2", device="cpu"))
        ref = dp.align(pairs, subst, algorithm=spec, gapo=GAPO,
                       gape=_gape(spec))
        np.testing.assert_array_equal(got, batch, err_msg=f"{spec} {n}")
        np.testing.assert_array_equal(got, ref, err_msg=f"{spec} {n}")
        if spec.startswith("sw"):
            # Subject 2 is the query itself: its best cell is the last.
            assert got[2, 0] > 4 * n and tuple(got[2, 1:]) == (n, n)
            assert (got[2:, 0] > 255).all()  # every homolog


def test_searches_copy_only_the_query(subst):
    rng = np.random.default_rng(23)
    loads = dbsearch.DB_LOADS
    db = load_db([_seq(rng, n) for n in SUBJECTS], device="cpu")
    held = [(xs.data_ptr(), adjcs.data_ptr()) for xs, adjcs in db.buckets]
    assert dbsearch.DB_LOADS == loads + 1
    spec = AlignSpec.from_name("sw_ag")
    # A query of 37 residues goes over as its length and 1 + 256 letters.
    query_bytes = 4 * (1 + 1 + 256)
    sent, searches = dbsearch.SEARCH_H2D_BYTES, dbsearch.SEARCHES
    search_db(spec, subst, _seq(rng, 37), db, GAPO, -1)
    # The first search also takes the matrix over, once.
    assert dbsearch.SEARCH_H2D_BYTES - sent == query_bytes + subst.nbytes
    for n in (37, 200):
        sent = dbsearch.SEARCH_H2D_BYTES
        search_db(spec, subst, _seq(rng, n), db, GAPO, -1)
        assert dbsearch.SEARCH_H2D_BYTES - sent == query_bytes
    assert dbsearch.SEARCHES == searches + 3
    assert dbsearch.DB_LOADS == loads + 1
    assert [(xs.data_ptr(), adjcs.data_ptr())
            for xs, adjcs in db.buckets] == held
    # Another matrix is taken over again.
    sent = dbsearch.SEARCH_H2D_BYTES
    search_db(spec, subst + 1, _seq(rng, 37), db, GAPO, -1)
    assert dbsearch.SEARCH_H2D_BYTES - sent == query_bytes + subst.nbytes


def test_buckets_are_sorted_longest_first(subst):
    rng = np.random.default_rng(29)
    subjects = [_seq(rng, n) for n in SUBJECTS]
    db = load_db(subjects, device="cpu")
    widths = [xs.shape[1] - 1 for xs, _ in db.buckets]
    assert widths == [256, 512, 1024]
    lens = np.concatenate([adjcs.numpy() for _, adjcs in db.buckets])
    # Each bucketed subject's input index, in bucket order, from the
    # permutation the search puts the answers back with.
    live = np.setdiff1d(np.arange(len(subjects)), db.empty)
    order = live[np.argsort(db.inv.numpy()[live])]
    np.testing.assert_array_equal(np.sort(db.inv.numpy()[live]),
                                  np.arange(len(live)))
    np.testing.assert_array_equal(lens, db.lens[order])
    assert db.empty.tolist() == [SUBJECTS.index(0)]
    start = 0
    for xs, adjcs in db.buckets:
        k = adjcs.numpy()
        assert (np.diff(k) <= 0).all()
        for row, s in zip(xs.numpy(), order[start:start + len(k)]):
            np.testing.assert_array_equal(row[:len(subjects[s])],
                                          subjects[s])
            assert not row[len(subjects[s]):].any()
        start += len(k)


def _stacked_and_one(rng, n, rows, cols_p, rows_p):
    """A query (1, 1+rows_p) with its length, the same query stacked for
    n pairs, and n subjects (n, 1+cols_p) with theirs."""
    query = np.zeros((1, 1 + rows_p), np.int32)
    query[0, :1 + rows] = _seq(rng, rows)
    xs = np.zeros((n, 1 + cols_p), np.int32)
    adjcs = rng.integers(2, cols_p + 2, n).astype(np.int32)
    for b, c in enumerate(adjcs):
        xs[b, :c] = _seq(rng, c - 1)
    one = torch.from_numpy(query), torch.tensor([1 + rows], dtype=torch.int32)
    stacked = (one[0].expand(n, -1).contiguous(), one[1].expand(n).clone())
    return one, stacked, torch.from_numpy(xs), torch.from_numpy(adjcs)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_fills_take_one_query_for_every_pair(subst, spec):
    rng = np.random.default_rng(31)
    kind, gap = spec.split("_")
    kw = dict(kind=kind, gap="affine" if gap == "ag" else "linear")
    s = torch.from_numpy(subst)
    one, stacked, xs, adjcs = _stacked_and_one(rng, 5, 70, 128, 128)
    args = (GAPO, _gape(spec))
    for got, want in (
            (scores_batch_plain(s, one[0], xs, one[1], adjcs, *args, **kw),
             scores_batch_plain(s, stacked[0], xs, stacked[1], adjcs, *args,
                                **kw)),
            (batch_cuda.tiny_scores(s, one[0], xs, *args, one[1], adjcs,
                                    **kw),
             batch_cuda.tiny_scores(s, stacked[0], xs, *args, stacked[1],
                                    adjcs, **kw))):
        for a, b in zip(got, want):
            assert a.shape == (5,)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    tiles = dict(tile_h=32, tile_w=64, **kw)
    got = mlsp_fill_batch_plain(s, one[0], xs, *args, one[1], adjcs, **tiles)
    want = mlsp_fill_batch_plain(s, stacked[0], xs, *args, stacked[1], adjcs,
                                 **tiles)
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    got = batch_cuda.mlsp_fill_batch(s, one[0], xs, *args, one[1], adjcs,
                                     **tiles)
    torch.testing.assert_close(got["cost"], want["cost"], rtol=0, atol=0)


def test_wrappers_check_the_query_shape(subst):
    rng = np.random.default_rng(37)
    s = torch.from_numpy(subst)
    one, stacked, xs, adjcs = _stacked_and_one(rng, 3, 20, 64, 64)
    kw = dict(kind="sw", gap="affine")
    bad = (
        (stacked[0][:2], xs, stacked[1][:2], adjcs),  # 2 rows for 3 pairs
        (one[0], xs, stacked[1], adjcs),  # one query, three lengths
        (stacked[0], xs, one[1], adjcs),  # three rows, one length
    )
    for ys, x, adjrs, c in bad:
        with pytest.raises(ValueError):
            batch_cuda.tiny_scores(s, ys, x, GAPO, -1, adjrs, c, **kw)
        with pytest.raises(ValueError):
            batch_cuda.mlsp_fill_batch(s, ys, x, GAPO, -1, adjrs, c,
                                       tile_h=32, tile_w=64, **kw)


def test_spans_under_a_profiler(subst):
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(41)
    spec = AlignSpec.from_name("sw_ag")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db = load_db([_seq(rng, n) for n in (3, 0)], device="cpu")
        for n in (20, 1024):  # the tiny-pair route, the batched route
            search_db(spec, subst, _seq(rng, n), db, GAPO, -1)
    names = [e.name for e in prof.events()]
    for name in ("db.load", "db.query", "db.tiny", "db.fill",
                 "db.copy_back", "db.gather"):
        assert name in names, name
    assert names.count("db.search") == 2
    assert names.count("db.tiny") == names.count("db.fill") == 1


def test_refusals(subst):
    rng = np.random.default_rng(43)
    subjects = [_seq(rng, n) for n in (3, 9)]
    with pytest.raises(ValueError, match="mesh"):
        load_db(subjects, device=make_mesh(devices=["cpu", "cpu"]))
    db = load_db(subjects, device="cpu")
    with pytest.raises(ValueError, match="gapo"):
        search_db(AlignSpec.from_name("nw_ag"), subst, _seq(rng, 5), db, 1,
                  -1)
    empty = load_db([], device="cpu")
    res = search_db(AlignSpec.from_name("sw_ag"), subst, _seq(rng, 5),
                    empty, GAPO, -1)
    assert res.costs.shape == (0,) and res.n_buckets == 0


def test_the_answers_are_one_block(subst):
    """The result's arrays are the rows of one (3, N) block of the
    search's own, fresh for every search (the benchmark's entry takes it
    without a copy)."""
    rng = np.random.default_rng(47)
    db = load_db([_seq(rng, n) for n in (3, 300, 0)], device="cpu")
    spec = AlignSpec.from_name("nw_ag")
    blocks = []
    for n in (20, 0):
        res = search_db(spec, subst, _seq(rng, n), db, GAPO, -1)
        block = res.costs.base
        assert block.shape == (3, 3) and block.dtype == np.int32
        np.testing.assert_array_equal(block.T, _answers(res))
        blocks.append(block)
    assert not np.shares_memory(*blocks)
