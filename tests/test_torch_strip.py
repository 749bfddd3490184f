"""The row-strip fill's host side and the facts its design rests on.

The strip kernel (``ops/csrc/strip_fill.cu``, K5 and K7) runs only on the
card. What the CPU can check: the schedule its wrappers compute on the
host (``ops/strip_cuda.py``), that the cost-only call may fill each pair's
live region alone (the plain fill of the padded bucket equals the plain
fill, and the JAX package's fill, of each pair unpadded), and that the
per-strip SW bests reduce to the same best cell as per-tile bests. Inputs
are made with numpy from a seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core.types import AlignSpec as JaxSpec
from gpuseqalign_tpu.models.oracle import align_cost_of, oracle_align_dense
from gpuseqalign_tpu.parallel import batch as jax_batch

from gpuseqalign_tpu_torch.ops import banded_cuda, batch_cuda, strip_cuda
from gpuseqalign_tpu_torch.ops.batch_plain import mlsp_fill_batch_plain
from gpuseqalign_tpu_torch.ops.mlsp_cuda import tile_best

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2


def _kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


def _stack(pairs, rows_p, cols_p):
    b = len(pairs)
    ys = np.zeros((b, 1 + rows_p), np.int32)
    xs = np.zeros((b, 1 + cols_p), np.int32)
    for k, (y, x) in enumerate(pairs):
        ys[k, :len(y)], xs[k, :len(x)] = y, x
    adjrs = np.array([len(y) for y, _ in pairs], np.int32)
    adjcs = np.array([len(x) for _, x in pairs], np.int32)
    return ys, xs, adjrs, adjcs


def _tie_pairs():
    """Pairs over a 4-letter matrix where the SW maximum repeats, in the
    same row and across rows 32 apart (a strip boundary)."""
    subst = np.full((4, 4), -5, np.int32)
    subst[1, 1] = 3
    motif = np.array([2, 1, 2, 2, 1, 2, 1], np.int32)
    y = np.concatenate([[0], motif, np.full(25, 3, np.int32), motif,
                        np.full(9, 3, np.int32)]).astype(np.int32)
    x = np.concatenate([[0], np.array([1, 2, 2, 1, 2, 2, 1, 2], np.int32),
                        np.full(7, 3, np.int32),
                        np.array([1, 2, 2, 1], np.int32)]).astype(np.int32)
    return subst, [(y, x), (x, y), (y[:34], x)]


@pytest.mark.parametrize("spec", SPECS)
def test_padded_bucket_equals_each_live_region(blosum62, spec):
    """The cost-only call fills only each pair's live cells: the padded
    bucket's plain cost and best equal the plain fill of each pair alone
    (unpadded, tile 1 x 1), the JAX package's fill of the bucket and the
    oracle. Pairs of one row and one column included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(71)
    sizes = [(64, 96), (1, 90), (60, 1), (1, 1), (37, 95), (64, 2)]
    pairs = [(np.concatenate([[0], rng.integers(0, 24, r)]).astype(np.int32),
              np.concatenate([[0], rng.integers(0, 24, c)]).astype(np.int32))
             for r, c in sizes]
    ys, xs, adjrs, adjcs = _stack(pairs, 64, 96)
    kw = _kind_gap(spec)
    subst = torch.from_numpy(blosum62)
    out = mlsp_fill_batch_plain(subst, *map(torch.from_numpy,
                                            (ys, xs)), GAPO, GAPE,
                                *map(torch.from_numpy, (adjrs, adjcs)),
                                tile_h=32, tile_w=32, **kw)
    ref = jax_batch.scores_batch(
        jnp.asarray(blosum62), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(adjrs), jnp.asarray(adjcs), jnp.int32(GAPO),
        jnp.int32(GAPE), **kw)
    jspec = JaxSpec.from_name(spec)
    for k, (y, x) in enumerate(pairs):
        alone = mlsp_fill_batch_plain(
            subst, torch.from_numpy(y[None]), torch.from_numpy(x[None]),
            GAPO, GAPE, torch.tensor([len(y)], dtype=torch.int32),
            torch.tensor([len(x)], dtype=torch.int32), tile_h=1, tile_w=1,
            **kw)
        assert int(out["cost"][k]) == int(alone["cost"][0])
        assert int(out["cost"][k]) == int(np.asarray(ref[0])[k])
        mats = oracle_align_dense(jspec, blosum62, y, x, GAPO, GAPE)
        assert int(out["cost"][k]) == align_cost_of(jspec, mats)
        if kw["kind"] == "sw":
            assert out["best"][k].tolist() == alone["best"][0].tolist()
            assert out["best"][k, 1:].tolist() == [
                int(np.asarray(ref[1])[k]), int(np.asarray(ref[2])[k])]


@pytest.mark.parametrize("spec", ["sw_lg", "sw_ag"])
def test_sw_ties_across_strips_in_live_regions(spec):
    """Ties of the SW maximum, within a row and 32 rows apart (on both
    sides of a strip boundary): the padded bucket and each pair alone give
    the oracle's row-major first cell."""
    subst, pairs = _tie_pairs()
    jspec = JaxSpec.from_name(spec)
    rows_p = max(len(y) for y, _ in pairs) - 1
    cols_p = max(len(x) for _, x in pairs) - 1
    ys, xs, adjrs, adjcs = _stack(pairs, rows_p, cols_p)
    out = mlsp_fill_batch_plain(
        torch.from_numpy(subst), torch.from_numpy(ys), torch.from_numpy(xs),
        GAPO, GAPE, torch.from_numpy(adjrs), torch.from_numpy(adjcs),
        tile_h=1, tile_w=1, **_kind_gap(spec))
    for k, (y, x) in enumerate(pairs):
        mats = oracle_align_dense(jspec, subst, y, x, GAPO, GAPE)
        assert (mats["H"] == mats["H"].max()).sum() > 1
        want = [int(mats["H"].max()), *(int(v) for v in mats["best"])]
        assert out["best"][k].tolist() == want


@pytest.mark.parametrize("tile_h,rows,carry", [
    (1, 32, True), (16, 32, True), (128, 128, True), (256, 256, True),
    (32, 32, True), (64, 64, True), (512, 256, False), (48, 128, False),
    (3, 32, False), (100, 128, False),
])
def test_strip_height_from_tile_height(tile_h, rows, carry):
    """A multiple of tile_h where one of 32..256 is (the carry then lives
    in the tile headers), else a divisor, else 32 or 128; always tile_h
    >= K rows a lane, so a lane holds at most one tile-row boundary."""
    assert strip_cuda.strip_rows(tile_h) == rows
    sched = strip_cuda.schedule(tile_h, 128)
    assert (sched.rows, sched.lane_rows) == (rows, rows // 32)
    assert sched.carry_in_headers is carry
    assert tile_h >= sched.lane_rows


def test_every_tile_height_keeps_one_boundary_a_lane():
    for tile_h in range(1, 600):
        sched = strip_cuda.schedule(tile_h, 1)
        assert sched.rows in strip_cuda.STRIP_HEIGHTS
        assert tile_h >= sched.lane_rows
        assert sched.carry_in_headers == (sched.rows % tile_h == 0)


@pytest.mark.parametrize("nmat,ns,cols,affine,words", [
    (1, 1, 0, False, 1), (1, 1, 0, True, 2),
    (2, 5, 40, False, 2 * 5 * 41), (2, 5, 40, True, 2 * 2 * 5 * 41),
    (15, 38, 1200, False, 15 * 38 * 1201),
    (15, 38, 1200, True, 2 * 15 * 38 * 1201),
])
def test_carry_holds_f_only_for_affine_gaps(nmat, ns, cols, affine, words):
    """The carry scratch holds H of each strip's bottom row, and F beside
    it for affine gaps only; rows are cols + 1 wide."""
    assert strip_cuda.scratch_words(nmat, ns, cols, True, affine) == (
        1 + nmat * ns, words)
    assert strip_cuda.scratch_words(nmat, ns, cols, False, affine) == (
        1 + nmat * ns, 0)
    prog, carry = strip_cuda.alloc_scratch(nmat, ns, cols, True, affine,
                                           torch.device("cpu"))
    assert prog.tolist() == [0] * (1 + nmat * ns)
    assert carry.dtype == torch.int32 and carry.numel() == words


@pytest.mark.parametrize("nmat,ns", [(1, 1), (1, 7), (3, 1), (5, 4),
                                     (15, 74)])
def test_ticket_order_puts_each_strip_after_the_one_above(nmat, ns):
    order = strip_cuda.ticket_order(nmat, ns)
    assert sorted(order) == [(m, s) for m in range(nmat) for s in range(ns)]
    where = {item: t for t, item in enumerate(order)}
    for m in range(nmat):
        for s in range(1, ns):
            assert where[(m, s - 1)] < where[(m, s)]


def test_scratch_and_counter_sizing():
    assert strip_cuda.n_strips(1, 32) == 1
    assert strip_cuda.n_strips(1200, 32) == 38
    assert strip_cuda.n_strips(100352, 128) == 784
    # The ticket and a counter a strip; H and F rows of 1 + cols a strip.
    assert strip_cuda.scratch_words(1, 784, 100096, False, True) == (785, 0)
    assert strip_cuda.scratch_words(3, 10, 99, True, True) == (
        31, 2 * 30 * 100)
    prog, carry = strip_cuda.alloc_scratch(2, 5, 40, True, True,
                                           torch.device("cpu"))
    assert prog.dtype == torch.int32 and prog.tolist() == [0] * 11
    assert carry.numel() == 2 * 2 * 5 * 41
    prog, carry = strip_cuda.alloc_scratch(1, 3, 40, False, False,
                                           torch.device("cpu"))
    assert prog.numel() == 4 and carry is None


def _first_max(vals, i0, j0):
    """Row-major first maximum of a block as (v, i, j); (0, 0, 0) if no
    value is > 0 (the kernel's rule for one strip or one tile)."""
    v = int(vals.max())
    if v <= 0:
        return [0, 0, 0]
    i, j = np.argwhere(vals == v)[0]
    return [v, i0 + int(i), j0 + int(j)]


@pytest.mark.parametrize("seed", range(6))
def test_strip_bests_reduce_like_tile_bests(seed):
    """tile_best over per-strip bests equals tile_best over per-tile bests
    and the global row-major first maximum, on random grids with many
    ties (values 0..4)."""
    rng = np.random.default_rng(seed)
    rows, cols, th, tw, sh = 96, 80, 16, 20, 32
    grid = rng.integers(0, 5, (rows, cols)).astype(np.int32)
    width = cols + 1
    tiles = [_first_max(grid[r:r + th, c:c + tw], r + 1, c + 1)
             for r in range(0, rows, th) for c in range(0, cols, tw)]
    strips = [_first_max(grid[r:r + sh], r + 1, 1)
              for r in range(0, rows, sh)]
    by_tile = tile_best(torch.tensor([tiles], dtype=torch.int32), width)
    by_strip = tile_best(torch.tensor([strips], dtype=torch.int32), width)
    assert by_tile.tolist() == by_strip.tolist()
    assert by_strip[0].tolist() == _first_max(grid, 1, 1)


def test_strip_schedule_rejects_bad_tiles():
    for bad in (0, -3):
        with pytest.raises(ValueError):
            strip_cuda.strip_rows(bad)
    with pytest.raises(ValueError):
        strip_cuda.schedule(128, 0)


def test_cpu_wrappers_launch_nothing(blosum62):
    """On the CPU both wrappers of the strip kernel run their plain
    versions and count no launch."""
    rng = np.random.default_rng(3)
    subst = torch.from_numpy(blosum62)
    before = (batch_cuda.FILL_LAUNCHES, banded_cuda.LAUNCHES)
    ys = torch.from_numpy(rng.integers(0, 24, (2, 33)).astype(np.int32))
    xs = torch.from_numpy(rng.integers(0, 24, (2, 41)).astype(np.int32))
    lens = torch.tensor([33, 20], dtype=torch.int32)
    out = batch_cuda.mlsp_fill_batch(subst, ys, xs, GAPO, GAPE, lens,
                                     torch.tensor([41, 41], dtype=torch.int32),
                                     tile_h=16, tile_w=8, kind="sw",
                                     gap="affine")
    assert set(out) == {"cost", "best"}
    y, x = ys[0].contiguous(), xs[0].contiguous()
    edge = torch.zeros(41, dtype=torch.int32)
    halo = torch.zeros(33, dtype=torch.int32)
    got = banded_cuda.banded_pass(subst, y, x, GAPO, 0, edge, None, halo,
                                  None, 33, 41, tile_h=16, tile_w=8,
                                  kind="sw", gap="linear")
    assert got["hrows"].shape == (3, 41)
    assert (batch_cuda.FILL_LAUNCHES, banded_cuda.LAUNCHES) == before
