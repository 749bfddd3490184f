"""The tiny-pair fill's host side and a model of its order of work.

The kernel of K6 (``ops/csrc/mlsp_tiny.cu``) runs only on the card;
``chip_smoke.py`` phase 2 holds it there against ``scores_batch_plain``,
bit for bit. What the CPU checks: the helpers its wrapper uses on the host
(``ops/tiny_cuda.py``: strips and rows a lane of a pair, shared memory,
carry scratch, warps a block; ``parallel/batch.py::fill_route``), that the
constants the host mirrors match the kernel's source, and that the
kernel's order of work gives the outputs of the plain fill. That order is
restated here in plain numpy, ``strip_model``: one warp's 32 lanes as one
vector, a pair's strips in turn, each swept over the steps the kernel
takes (chunks of 32, the last strip's steps cut to its live lanes, the
chunks without selects asserted to keep every lane inside its columns),
the carry row read 32 columns at a chunk's start and overwritten in place
by lane 31, and the lanes' SW bests reduced by the kernel's tie rule. The
model restates the kernel, it does not run it: a change to the kernel's
order shows here only when the model is changed with it. Inputs are made
with numpy from a seed; every comparison is exact. No Pallas kernel runs.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core.types import AlignSpec as JaxSpec
from gpuseqalign_tpu.models.oracle import align_cost_of, oracle_align_dense
from gpuseqalign_tpu.parallel import batch as jax_batch

from gpuseqalign_tpu_torch.core.types import NEG_INF_I32, AlignSpec
from gpuseqalign_tpu_torch.ops import batch_cuda, tiny_cuda
from gpuseqalign_tpu_torch.ops.batch_plain import scores_batch_plain
from gpuseqalign_tpu_torch.parallel import batch as port_batch

from chip_smoke import tie_pair

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO = -11
SRC = os.path.join(os.path.dirname(tiny_cuda.__file__), "csrc",
                   "mlsp_tiny.cu")
LANES = 32


def _gape(spec):
    return -2 if spec.endswith("ag") else 0


def _kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


def _edge(k, sw, affine, gapo, gape):
    """H[k, 0] == H[0, k] (the kernel's ``edge``)."""
    k = np.asarray(k, np.int64)
    if sw:
        return np.zeros_like(k)
    val = gapo + k * gape if affine else k * gapo
    return np.where(k == 0, 0, val)


def strip_model(subst, y, x, R, C, gapo, gape, spec):
    """One warp's fill of a pair of R x C live cells, step by step as the
    kernel orders it; returns (cost, best_i, best_j)."""
    sw, affine = spec.startswith("sw"), spec.endswith("ag")
    ns, K = tiny_cuda.pair_strips(R)
    lane = np.arange(LANES)
    carry_h = np.full(C + 1, 777_777_777, np.int64)  # poison: never read
    carry_f = np.full(C + 1, 777_777_777, np.int64)  # before written
    lbest = np.zeros((LANES, 3), np.int64)  # each lane's (v, i, j)
    cost = None
    ninf = NEG_INF_I32
    for s in range(ns):
        r0 = s * LANES * K
        nr = min(LANES * K, R - r0)
        L = -(-nr // K)
        produce = s + 1 < ns
        rows = r0 + lane[:, None] * K + np.arange(K)[None, :] + 1  # (32, K)
        live = rows - r0 - 1 < nr
        letters = np.where(live, y[np.minimum(rows, len(y) - 1)], 0)
        h = _edge(rows, sw, affine, gapo, gape)
        e = np.full((LANES, K), ninf, np.int64)
        f = np.full((LANES, K), ninf, np.int64)
        bv = np.zeros((LANES, K), np.int64)
        bj = np.zeros((LANES, K), np.int64)
        c0 = -lane.copy()
        up_h = np.roll(h[:, K - 1], 1)
        up_f = np.roll(f[:, K - 1], 1)
        dtop = np.zeros(LANES, np.int64)
        T = C + L
        for t0 in range(0, T, 32):
            # Row r0 at columns t0 .. t0+31, read at the chunk's start.
            cc = t0 + lane
            if s == 0:
                ch = _edge(cc, sw, affine, gapo, gape)
                chf = np.full(LANES, ninf, np.int64)
            else:
                ok = (cc >= 1) & (cc <= C)
                ch = np.where(ok, carry_h[np.clip(cc, 0, C)], 0)
                ch[cc == 0] = _edge(r0, sw, affine, gapo, gape)
                chf = np.where(ok, carry_f[np.clip(cc, 0, C)], ninf)
            steady = t0 >= 32 and t0 + 31 <= C
            for j in range(32 if steady else min(32, T - t0)):
                v = (c0 >= 1) & (c0 <= C)
                if steady:
                    assert v.all()
                u0 = np.where(lane == 0, ch[j], up_h)
                uf0 = np.where(lane == 0, chf[j], up_f)
                xc = x[np.clip(c0, 0, C)]
                d, u = dtop, u0
                dtop = u0
                for k in range(K):
                    sc = subst[letters[:, k], xc]
                    if affine:
                        fn = np.maximum((f[:, k - 1] if k else uf0) + gape,
                                        u + gapo + gape)
                        en = np.maximum(e[:, k] + gape, h[:, k] + gapo + gape)
                        hn = np.maximum(np.maximum(d + sc, en), fn)
                    else:
                        hn = np.maximum(np.maximum(d + sc, h[:, k] + gapo),
                                        u + gapo)
                    if sw:
                        hn = np.maximum(hn, 0)
                    d, u = h[:, k].copy(), hn
                    if sw:
                        better = v & live[:, k] & (hn > bv[:, k])
                        bv[:, k] = np.where(better, hn, bv[:, k])
                        bj[:, k] = np.where(better, c0, bj[:, k])
                    h[:, k] = np.where(v, hn, h[:, k])
                    if affine:
                        e[:, k] = np.where(v, en, e[:, k])
                        f[:, k] = fn
                up_h = np.roll(h[:, K - 1], 1)
                up_f = np.roll(f[:, K - 1], 1)
                if produce and v[31]:  # lane 31 overwrites in place
                    carry_h[c0[31]] = h[31, K - 1]
                    carry_f[c0[31]] = f[31, K - 1]
                c0 = c0 + 1
        if produce:
            assert (carry_h[1:] != 777_777_777).all()
        for ln in range(LANES):  # each lane: strict >, rows in order
            for k in range(K):
                if bv[ln, k] > lbest[ln, 0]:
                    lbest[ln] = (bv[ln, k], rows[ln, k], bj[ln, k])
        if s + 1 == ns:
            lk = R - 1 - r0
            cost = int(h[lk // K, lk % K])
    if sw:
        # The warp's shuffle reduction: at each offset lane l takes lane
        # l + off's best if it is larger, or equal (> 0) at a smaller
        # row, then a smaller column.
        vals = [tuple(int(a) for a in b) for b in lbest]
        for off in (16, 8, 4, 2, 1):
            new = list(vals)
            for ln in range(LANES - off):
                a, b = vals[ln], vals[ln + off]
                if b[0] > a[0] or (b[0] == a[0] and b[0] > 0
                                   and (b[1], b[2]) < (a[1], a[2])):
                    new[ln] = b
            vals = new
        return vals[0]
    return cost, 0, 0


def _pairs(subst):
    """Ragged pairs of 1-130 rows, rows a multiple of no strip height, and
    tie pairs (chip_smoke.py's): runs every 16 rows from row 16 across
    lane boundaries, and in a pair of 260 rows (two strips of 160) from row
    160, the first strip's last row, into the second strip."""
    rng = np.random.default_rng(40)
    sizes = [(1, 1), (1, 37), (37, 1), (2, 2), (33, 40), (97, 61),
             (130, 70)]
    pairs = [(np.concatenate([[0], rng.integers(0, 25, r)]).astype(np.int32),
              np.concatenate([[0], rng.integers(0, 25, c)]).astype(np.int32))
             for r, c in sizes]
    pairs.append(tie_pair(subst, 130, 60, 16, 30))
    pairs.append(tie_pair(subst, 260, 40, 160, 20))
    return pairs


def _stack(pairs):
    rows_p = max(len(y) for y, _ in pairs) - 1
    cols_p = max(len(x) for _, x in pairs) - 1
    ys = np.zeros((len(pairs), 1 + rows_p), np.int32)
    xs = np.zeros((len(pairs), 1 + cols_p), np.int32)
    for k, (y, x) in enumerate(pairs):
        ys[k, :len(y)], xs[k, :len(x)] = y, x
    adjrs = np.array([len(y) for y, _ in pairs], np.int32)
    adjcs = np.array([len(x) for _, x in pairs], np.int32)
    return ys, xs, adjrs, adjcs


@pytest.mark.parametrize("spec", SPECS)
def test_strip_model_matches_plain_jax_and_oracle(blosum62, spec):
    """The kernel's order of work, for pairs the kernel takes (adjr, adjc
    >= 2), equals scores_batch_plain, the JAX package's XLA scores_batch
    and the oracle."""
    pairs = _pairs(blosum62)
    ys, xs, adjrs, adjcs = _stack(pairs)
    gape = _gape(spec)
    plain = scores_batch_plain(
        *(torch.from_numpy(a) for a in (blosum62, ys, xs, adjrs, adjcs)),
        GAPO, gape, **_kind_gap(spec))
    ref = jax_batch.scores_batch(
        jnp.asarray(blosum62), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(adjrs), jnp.asarray(adjcs), jnp.int32(GAPO),
        jnp.int32(gape), **_kind_gap(spec))
    jspec = JaxSpec.from_name(spec)
    subst = blosum62.astype(np.int64)
    for k, (y, x) in enumerate(pairs):
        want = tuple(int(t[k]) for t in plain)
        assert want == tuple(int(np.asarray(t)[k]) for t in ref)
        mats = oracle_align_dense(jspec, blosum62, y, x, GAPO, gape)
        assert want[0] == align_cost_of(jspec, mats)
        if spec.startswith("sw"):
            assert want[1:] == tuple(int(v) for v in mats["best"])
        got = strip_model(subst, y.astype(np.int64), x.astype(np.int64),
                          len(y) - 1, len(x) - 1, GAPO, gape, spec)
        assert got == want, (k, got, want)


@pytest.mark.parametrize("spec", ["sw_lg", "sw_ag"])
def test_tie_pairs_tie_where_they_should(blosum62, spec):
    """The tie pairs do tie: the best value is reached at the end row of
    every run, and the row-major first is the first run's."""
    jspec = JaxSpec.from_name(spec)
    y, x = tie_pair(blosum62, 130, 60, 16, 30)
    H = oracle_align_dense(jspec, blosum62, y, x, GAPO, _gape(spec))["H"]
    at = np.argwhere(H == H.max())
    assert H.max() == 12 * blosum62.diagonal().max()
    assert [tuple(a) for a in at] == [(r, 30) for r in range(16, 131, 16)]


def test_pair_strips_cover_rows_with_few_dead():
    for R in range(1, 1100):
        ns, K = tiny_cuda.pair_strips(R)
        assert 1 <= K <= tiny_cuda.LANE_ROWS
        assert ns == -(-R // (32 * tiny_cuda.LANE_ROWS))
        assert ns * 32 * K >= R > ns * 32 * (K - 1)
        assert ns * 32 * K - R < 32 * ns
    assert tiny_cuda.pair_strips(400) == (2, 7)
    assert tiny_cuda.pair_strips(257) == (2, 5)
    assert tiny_cuda.pair_strips(260) == (2, 5)
    assert tiny_cuda.pair_strips(130) == (1, 5)
    with pytest.raises(ValueError):
        tiny_cuda.pair_strips(0)


def test_shared_memory_and_scratch_sizes():
    S = 25
    for warps in range(1, tiny_cuda.MAX_WARPS + 1):
        base = 4 * (S * S + warps * tiny_cuda.RING)
        assert tiny_cuda.smem_bytes(S, warps, 512, True, False) == base
        assert tiny_cuda.smem_bytes(S, warps, 512, True, True) == (
            base + 4 * warps * 2 * 513)
        assert tiny_cuda.smem_bytes(S, warps, 512, False, True) == (
            base + 4 * warps * 513)
        # synth_16384's 512 columns: the carry rows in shared memory.
        assert tiny_cuda.scratch_words(S, warps, 512, True) == 0
        # The 1000 x 20000 check: a carry row of global scratch a pair.
        assert tiny_cuda.scratch_words(S, warps, 20000, True) == 2 * 20001
        assert tiny_cuda.scratch_words(S, warps, 20000, False) == 20001
    # The largest width whose rows still fit beside one warp's ring.
    room = tiny_cuda.SMEM_LIMIT // 4 - S * S - tiny_cuda.RING
    widest = room // 2 - 1
    assert tiny_cuda.scratch_words(S, 1, widest, True) == 0
    assert tiny_cuda.scratch_words(S, 1, widest + 1, True) > 0


@pytest.mark.parametrize("warps,S", [(0, 25), (5, 25), (1, 120)])
def test_check_warps_rejects(warps, S):
    with pytest.raises(ValueError):
        tiny_cuda.check_warps(warps, S)


def test_host_constants_match_the_kernel_source():
    """The constants tiny_cuda.py mirrors are the kernel's own, and the
    only block barrier is the one after the matrix is loaded (none in the
    step loop)."""
    with open(SRC) as f:
        src = f.read()
    code = re.sub(r"//[^\n]*", "", src)
    assert f"constexpr int kMaxWarps = {tiny_cuda.MAX_WARPS};" in code
    assert f"constexpr int kLaneRows = {tiny_cuda.LANE_ROWS};" in code
    assert f"constexpr int kRing = {tiny_cuda.RING};" in code
    assert (f"constexpr size_t kSmemLimit = {tiny_cuda.SMEM_LIMIT // 1024}"
            " * 1024;") in code
    assert code.count("__syncthreads") == 1
    loop = code[code.index("void sweep("):code.index("void fill_pair(")]
    assert "__syncthreads" not in loop and "atomic" not in code
    assert 1 <= tiny_cuda.WARPS <= tiny_cuda.MAX_WARPS


def test_fill_route_picks_by_height_and_pairs_per_sm():
    route = port_batch.fill_route
    need = port_batch.TINY_MIN_PAIRS_PER_SM * 132
    assert need >= 1
    assert route(1024, 10 ** 6, 132) == "fill"
    assert route(port_batch.TILE_FILL_MIN_ROWS - 1, 10 ** 6, 132) == "tiny"
    assert route(512, int(need), 132) == "tiny"
    assert route(512, int(need) - 1, 132) == "fill"
    assert route(512, 1, None) == "tiny"
    assert route(2048, 1, None) == "fill"


@pytest.mark.parametrize("spec", SPECS)
def test_cpu_wrapper_and_engine_launch_nothing(blosum62, spec):
    """On CPU tensors tiny_scores is the plain version at every block size
    and counts no launch; bucket_scores takes it by height."""
    rng = np.random.default_rng(5)
    pairs = [(np.concatenate([[0], rng.integers(0, 25, r)]).astype(np.int32),
              np.concatenate([[0], rng.integers(0, 25, c)]).astype(np.int32))
             for r, c in ((20, 30), (7, 3), (31, 31))]
    args = [torch.from_numpy(a) for a in (blosum62, *_stack(pairs))]
    gape = _gape(spec)
    want = scores_batch_plain(*args, GAPO, gape, **_kind_gap(spec))
    before = (batch_cuda.FILL_LAUNCHES, batch_cuda.TINY_LAUNCHES)
    for warps in (None, 1, 4):
        got = batch_cuda.tiny_scores(*args[:3], GAPO, gape, *args[3:],
                                     _warps=warps, **_kind_gap(spec))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    res = port_batch.bucket_scores(AlignSpec.from_name(spec), *args[:3],
                                   *args[3:], GAPO, gape)
    assert torch.equal(res, torch.stack(want))
    assert (batch_cuda.FILL_LAUNCHES, batch_cuda.TINY_LAUNCHES) == before
    with pytest.raises(ValueError):
        batch_cuda.tiny_scores(*args[:3], GAPO, gape, *args[3:],
                               _warps=5, **_kind_gap(spec))
