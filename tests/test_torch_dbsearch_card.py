"""The database search and the two fills' query stride, on the card.

- ``search_db`` against ``align_pairs_batched`` on the card, bit for bit,
  on the benchmark's ``swissprot_search.dbsearch`` traffic: its first
  request (one query against the 65 536 subjects) at seed 1.
- K6 (``tiny_scores``) and K5 (``mlsp_fill_batch``) at a row stride of 0,
  one query for every pair, against their plain version on the card.
- Both at the stacked stride the batch engine passes, against the plain
  version, on a few pairs of every bucket of the first requests of
  ``blastp_sw_ag.allvsall20`` and ``upstream_nw_lg.pg1``.
- ``search_db`` on homologs (each query's own copy and copies with
  residues replaced, among random subjects), whose scores pass 8 bits
  through K6 and 16 bits through K5, against ``align_pairs_batched``
  and the plain version: the cell's random subjects never score that
  high.

The tests skip where there is no CUDA card. This file imports no JAX; on
a machine with a card, run it without the suite's conftest, which loads
JAX:

    python -m pytest --noconftest -q tests/test_torch_dbsearch_card.py
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.ops import batch_cuda
from gpuseqalign_tpu_torch.ops.batch_plain import scores_batch_plain
from gpuseqalign_tpu_torch.parallel import (align_pairs_batched,
                                            bucket_pairs, load_db, search_db)
from gpuseqalign_tpu_torch.parallel.batch import stack_bucket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def _load(name):
    """A module of the benchmark (``generate``, ``reference/dp``), from its
    file."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace("/", "_"), os.path.join(BENCH, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(config, traffic, seed=1):
    """(configuration, matrix, the first request's pairs) of a cell's
    traffic at ``seed``."""
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    pool = _load("generate").make_pool(tr, cfg, seed)
    return cfg, _load("reference/dp").matrix(cfg), pool[0]


def _kw(algorithm):
    kind, gap = algorithm.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


def _both_fills(subst, ys, xs, adjrs, adjcs, cfg, tile_h, tile_w):
    """K6's and K5's (costs, best_i, best_j) and the plain version's, all
    computed on the card."""
    kw = _kw(cfg["algorithm"])
    gaps = (cfg["gapo"], cfg["gape"])
    tiny = batch_cuda.tiny_scores(subst, ys, xs, *gaps, adjrs, adjcs, **kw)
    out = batch_cuda.mlsp_fill_batch(subst, ys, xs, *gaps, adjrs, adjcs,
                                     tile_h=tile_h, tile_w=tile_w, **kw)
    if "best" in out:
        fill = (out["cost"], out["best"][:, 1], out["best"][:, 2])
    else:
        fill = (out["cost"], torch.zeros_like(out["cost"]),
                torch.zeros_like(out["cost"]))
    plain = scores_batch_plain(subst, ys, xs, adjrs, adjcs, *gaps, **kw)
    torch.cuda.synchronize()
    return [torch.stack(t).cpu() for t in (tiny, fill, plain)]


def test_search_matches_the_batch_engine_on_the_cell(card):
    cfg, subst, pairs = _cell("swissprot_search", "dbsearch")
    spec = AlignSpec.from_name(cfg["algorithm"])
    gaps = (cfg["gapo"], cfg["gape"])
    db = load_db([x for _, x in pairs], device="cuda")
    got = search_db(spec, subst, pairs[0][0], db, *gaps)
    want = align_pairs_batched(spec, subst, pairs, *gaps, quantum="pow2",
                               device="cuda")
    assert len(got.costs) == 65536 and got.n_buckets == 6
    for a, b in ((got.costs, want.costs), (got.best_i, want.best_i),
                 (got.best_j, want.best_j)):
        np.testing.assert_array_equal(a, b)
    assert (got.costs > 0).all()


@pytest.mark.parametrize("cols_p,n", [(512, 300), (4096, 6)])
def test_fills_at_stride_zero_match_the_plain_version(card, cols_p, n):
    cfg, subst, pairs = _cell("swissprot_search", "dbsearch")
    query = pairs[4][0]  # 464 residues: 512 padded rows
    picked = [x for _, x in pairs if cols_p // 2 < len(x) - 1 <= cols_p][:n]
    dev = torch.device("cuda")
    ys = torch.zeros((1, 513), dtype=torch.int32)
    ys[0, :len(query)] = torch.from_numpy(query)
    adjrs = torch.tensor([len(query)], dtype=torch.int32)
    xs, adjcs = stack_bucket([(query, x) for x in picked],
                             range(len(picked)), 512, cols_p, dev)[1::2]
    s = torch.from_numpy(subst).to(dev)
    tiny, fill, plain = _both_fills(s, ys.to(dev), xs, adjrs.to(dev), adjcs,
                                    cfg, 128, 512)
    assert plain.shape == (3, len(picked)) and (plain[0] > 0).all()
    torch.testing.assert_close(tiny, plain, rtol=0, atol=0)
    torch.testing.assert_close(fill, plain, rtol=0, atol=0)


@pytest.mark.parametrize("config,traffic", [
    ("blastp_sw_ag", "allvsall20"), ("upstream_nw_lg", "pg1")])
def test_fills_at_the_stacked_stride_match_the_plain_version(card, config,
                                                             traffic):
    cfg, subst, pairs = _cell(config, traffic)
    dev = torch.device("cuda")
    s = torch.from_numpy(subst).to(dev)
    buckets = bucket_pairs(pairs, "pow2")
    for (rows_p, cols_p), idxs in buckets.items():
        ys, xs, adjrs, adjcs = stack_bucket(pairs, idxs[:2], rows_p, cols_p,
                                            dev)
        tiny, fill, plain = _both_fills(s, ys, xs, adjrs, adjcs, cfg,
                                        min(rows_p, 128), min(cols_p, 512))
        torch.testing.assert_close(tiny, plain, rtol=0, atol=0,
                                   msg=f"K6 {rows_p}x{cols_p}")
        torch.testing.assert_close(fill, plain, rtol=0, atol=0,
                                   msg=f"K5 {rows_p}x{cols_p}")
    assert len(buckets) >= 10


def test_search_scores_homologs_past_sixteen_bits(card):
    cfg, subst, pairs = _cell("swissprot_search", "dbsearch")
    spec = AlignSpec.from_name(cfg["algorithm"])
    gaps = (cfg["gapo"], cfg["gape"])
    rng = np.random.default_rng(59)
    subjects = [x for _, x in pairs[:200]]
    # 464 residues: the tiny-pair route; 7000: the batched route, whose
    # self score passes 32 767.
    queries = [np.concatenate([[0], rng.integers(0, 20, n)]).astype(np.int32)
               for n in (464, 7000)]
    for q in queries:
        for share in (0.0, 0.1, 0.3):
            copy = q.copy()
            hit = np.flatnonzero(rng.random(len(q) - 1) < share) + 1
            copy[hit] = rng.integers(0, 20, len(hit))
            subjects.append(copy)
    db = load_db(subjects, device="cuda")
    for k, q in enumerate(queries):
        got = search_db(spec, subst, q, db, *gaps)
        want = align_pairs_batched(spec, subst, [(q, s) for s in subjects],
                                   *gaps, quantum="pow2", device="cuda")
        for a, b in ((got.costs, want.costs), (got.best_i, want.best_i),
                     (got.best_j, want.best_j)):
            np.testing.assert_array_equal(a, b)
        own = 200 + 3 * k
        assert got.costs[own] > (32767 if k else 255)
        assert (got.best_i[own], got.best_j[own]) == (len(q) - 1,
                                                      len(q) - 1)
        dev = torch.device("cuda")
        ys = torch.zeros((1, 1 + (512, 8192)[k]), dtype=torch.int32)
        ys[0, :len(q)] = torch.from_numpy(q)
        adjrs = torch.tensor([len(q)], dtype=torch.int32, device=dev)
        homs = subjects[own:own + 3]
        xs, adjcs = stack_bucket([(q, x) for x in homs], range(3),
                                 ys.shape[1] - 1, (512, 8192)[k], dev)[1::2]
        tiny, fill, plain = _both_fills(torch.from_numpy(subst).to(dev),
                                        ys.to(dev), xs, adjrs, adjcs, cfg,
                                        128, 512)
        np.testing.assert_array_equal(plain[0].numpy(), got.costs[own:own + 3])
        torch.testing.assert_close(tiny, plain, rtol=0, atol=0)
        torch.testing.assert_close(fill, plain, rtol=0, atol=0)
