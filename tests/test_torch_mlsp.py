"""The port's sparse (mlsp) path against gpuseqalign_tpu, bit for bit.

Inputs are made with numpy from a seed and handed to both packages: the
port through ``make_alg_input`` on the CPU (the plain PyTorch fill), the
JAX package through its own AlgInput and its CPU route of
``tpu7_pallas_mlsp`` (the XLA row-scan; no Pallas kernel). The wider shape
matrix is held against the numpy oracle. No tolerance: every field is
int32 and must be identical.
"""

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core import registry as jax_registry
from gpuseqalign_tpu.core import types as jax_types
from gpuseqalign_tpu.models.oracle import (
    align_cost_of,
    oracle_align_dense,
    oracle_hash_dense,
    oracle_trace_dense,
)

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    NEG_INF_I32,
    AlgParams,
    AlgResult,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.ops import mlsp_cuda
from gpuseqalign_tpu_torch.ops.mlsp_kernels import tile_headers
from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2
MATS = ("tileHrowMat", "tileHcolMat", "tileFrowMat", "tileEcolMat")


def _seqs(seed, rows, cols, letters=25):
    rng = np.random.default_rng(seed)
    y = np.concatenate([[0], rng.integers(0, letters, rows)]).astype(np.int32)
    x = np.concatenate([[0], rng.integers(0, letters, cols)]).astype(np.int32)
    return y, x


def _tiles(th, tw):
    return {"tileBy": [th], "tileBx": [tw]}


def run_port(subst, y, x, spec, params, gapo=GAPO, gape=GAPE):
    """align -> score hash -> trace through the port's registry."""
    alg = get_algorithm_map()["tpu7_pallas_mlsp"]
    nw = make_alg_input(subst, y, x, gapo, gape, spec, device="cpu")
    res = AlgResult()
    stats = [alg.align(AlgParams(params), nw, res)]
    if stats[0] == Status.success:
        stats.append(alg.hash(nw, res))
        stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


def run_jax(subst, y, x, spec, params, gapo=GAPO, gape=GAPE):
    """The same through gpuseqalign_tpu's registry on its CPU route."""
    alg = jax_registry.get_algorithm_map()["tpu7_pallas_mlsp"]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = subst, subst.shape[0]
    nw.seqY, nw.seqX = y, x
    nw.adjrows, nw.adjcols = len(y), len(x)
    nw.gapo_cost, nw.gape_cost = gapo, gape
    nw.spec = jax_types.AlignSpec.from_name(spec)
    res = jax_types.AlgResult()
    stats = [alg.align(jax_types.AlgParams(params), nw, res)]
    if stats[0] == jax_types.Status.success:
        stats.append(alg.hash(nw, res))
        stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


def assert_same(port, ref):
    (ps, pnw, pres), (rs, rnw, rres) = port, ref
    assert ps == rs
    for name in MATS:
        a, b = getattr(pnw, name), getattr(rnw, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype == np.int32, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("best_i", "best_j", "tile_hdr_mat_rows", "tile_hdr_mat_cols"):
        assert getattr(pnw, name) == getattr(rnw, name), name
    for name in ("align_cost", "score_hash", "trace_hash", "edit_trace"):
        assert getattr(pres, name) == getattr(rres, name), name


# A few shapes per spec through the JAX package itself (each compiles
# one XLA row-scan on the CPU): tiles 128x512, 64x76, taller than wide,
# and 1x1; none of the sizes is a tile multiple.
JAX_CASES = [
    (300, 700, 128, 512),
    (77, 205, 64, 76),
    (130, 50, 96, 40),
    (9, 14, 1, 1),
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols,th,tw", JAX_CASES)
def test_port_matches_jax(blosum62, spec, rows, cols, th, tw):
    y, x = _seqs(rows * 7 + cols, rows, cols)
    args = (blosum62, y, x, spec, _tiles(th, tw))
    port = run_port(*args)
    assert port[0] == [0, 0, 0]
    assert_same(port, run_jax(*args))


# The wider matrix against the numpy oracle: degenerate pairs (1x1,
# adjc == 2, adjr == 2), tile multiples and not, every tile shape.
ORACLE_CASES = [
    (1, 1, 128, 512),
    (50, 1, 128, 512),
    (1, 50, 64, 76),
    (513, 513, 128, 512),
    (64, 1000, 64, 76),
    (200, 90, 96, 40),
    (20, 30, 1, 1),
    (40, 3, 7, 2),
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols,th,tw", ORACLE_CASES)
def test_port_matches_oracle(blosum62, spec, rows, cols, th, tw):
    y, x = _seqs(rows + 3 * cols, rows, cols)
    stats, nw, res = run_port(blosum62, y, x, spec, _tiles(th, tw))
    assert stats == [0, 0, 0]
    aspec = jax_types.AlignSpec.from_name(spec)
    mats = oracle_align_dense(aspec, blosum62, y, x, GAPO, GAPE)
    assert res.align_cost == align_cost_of(aspec, mats)
    if spec.startswith("sw"):
        assert (nw.best_i, nw.best_j) == tuple(int(v) for v in mats["best"])
    transcript, thash, _ = oracle_trace_dense(
        aspec, mats, blosum62, y, x, GAPO, GAPE
    )
    assert res.edit_trace == transcript
    assert res.trace_hash == thash
    assert res.score_hash == oracle_hash_dense(mats["H"])


def _numpy_tiles(out, th, tw, trows, tcols):
    """The tile-major layout as the store once built it with numpy on the
    host, from the fill's padded headers."""
    n_tiles = trows * tcols

    def tile_rows(rows):
        win = np.lib.stride_tricks.sliding_window_view(
            rows[:trows, :tcols * tw + 1], tw + 1, axis=1)
        mat = np.empty((trows, tcols, tw + 1), dtype=np.int32)
        mat[...] = win[:, ::tw]
        return mat.reshape(n_tiles, tw + 1)

    def tile_cols(first, cols):
        mat = np.empty((n_tiles, 1 + th), dtype=np.int32)
        mat[:, 0] = first
        mat[:, 1:] = np.swapaxes(cols[:trows, :, :tcols], 1, 2).reshape(
            n_tiles, th)
        return mat

    h = {k: v.numpy() for k, v in out.items()}
    want = {"tileHrowMat": tile_rows(h["hrows"])}
    want["tileHcolMat"] = tile_cols(want["tileHrowMat"][:, 0], h["hcols"])
    if "frows" in h:
        want["tileFrowMat"] = tile_rows(h["frows"])
        want["tileEcolMat"] = tile_cols(np.int32(NEG_INF_I32), h["ecols"])
    return want


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols,th,tw", ORACLE_CASES)
def test_tile_headers_match_the_numpy_layout(blosum62, spec, rows, cols, th,
                                             tw):
    """``tile_headers`` lays the fill's headers out tile-major exactly as
    the store's numpy code did, and the registry's align attaches that
    layout; two inputs aligned in turn, with no reset between, keep their
    own, unchanged headers."""
    kind, gap = spec.split("_")
    gap = "affine" if gap == "ag" else "linear"
    alg = get_algorithm_map()["tpu7_pallas_mlsp"]
    nws, wants = [], []
    for k in range(2):
        y, x = _seqs(rows + 3 * cols + k, rows, cols)
        yp, xp = _padded(y, x, th, tw)
        out = mlsp_fill_plain(
            torch.from_numpy(blosum62), torch.from_numpy(yp),
            torch.from_numpy(xp), GAPO, GAPE, rows + 1, cols + 1,
            tile_h=th, tile_w=tw, kind=kind, gap=gap,
        )
        trows, tcols = (len(yp) - 1) // th, (len(xp) - 1) // tw
        want = _numpy_tiles(out, th, tw, trows, tcols)
        got = tile_headers(out["hrows"], out["hcols"], th, tw, trows, tcols,
                           frows=out.get("frows"), ecols=out.get("ecols"),
                           best=out.get("best"))
        assert sorted(got) == sorted([*want] + ["best"] * (kind == "sw"))
        for name, mat in want.items():
            assert got[name].dtype == np.int32, name
            assert got[name].flags.c_contiguous, name
            np.testing.assert_array_equal(got[name], mat, err_msg=name)
        if kind == "sw":
            np.testing.assert_array_equal(got["best"], out["best"].numpy())
        nw = make_alg_input(blosum62, y, x, GAPO, GAPE, spec, device="cpu")
        assert alg.align(AlgParams(_tiles(th, tw)), nw,
                         AlgResult()) == Status.success
        nws.append(nw)
        wants.append(want)
    for a in MATS:
        for b in MATS:
            if getattr(nws[0], a) is not None and getattr(nws[1], b) \
                    is not None:
                assert not np.shares_memory(getattr(nws[0], a),
                                            getattr(nws[1], b)), (a, b)
    for nw, want in zip(nws, wants):
        for name in MATS:
            if name not in want:
                assert getattr(nw, name) is None, name
                continue
            np.testing.assert_array_equal(getattr(nw, name), want[name],
                                          err_msg=name)


def _padded(y, x, th, tw):
    trows = max(1, -(-(len(y) - 1) // th))
    tcols = max(1, -(-(len(x) - 1) // tw))
    yp = np.zeros(1 + trows * th, np.int32)
    xp = np.zeros(1 + tcols * tw, np.int32)
    yp[: len(y)], xp[: len(x)] = y, x
    return yp, xp


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols,th,tw", [
    (70, 45, 32, 16), (33, 130, 40, 64), (5, 7, 1, 1),
])
def test_fill_headers_include_padding(blosum62, spec, rows, cols, th, tw):
    """Padded cells are part of the output: every header of the padded
    matrix, past adjrows/adjcols too, equals the oracle run on the
    zero-padded sequences (pad letter 0 through the same recurrence)."""
    yp, xp = _padded(*_seqs(rows + cols, rows, cols), th, tw)
    kind, gap = spec.split("_")
    gap = "affine" if gap == "ag" else "linear"
    out = mlsp_fill_plain(
        torch.from_numpy(blosum62), torch.from_numpy(yp),
        torch.from_numpy(xp), GAPO, GAPE, rows + 1, cols + 1,
        tile_h=th, tile_w=tw, kind=kind, gap=gap,
    )
    mats = oracle_align_dense(
        jax_types.AlignSpec.from_name(spec), blosum62, yp, xp, GAPO, GAPE
    )
    rows_p, cols_p = len(yp) - 1, len(xp) - 1
    hdr_rows = np.arange(0, rows_p, th)
    hdr_cols = np.arange(0, cols_p, tw)
    inner = np.arange(1, rows_p + 1).reshape(-1, th)
    np.testing.assert_array_equal(out["hrows"].numpy(), mats["H"][hdr_rows])
    np.testing.assert_array_equal(
        out["hcols"].numpy(), mats["H"][inner][:, :, hdr_cols]
    )
    if gap == "affine":
        np.testing.assert_array_equal(
            out["frows"].numpy(), mats["F"][hdr_rows]
        )
        np.testing.assert_array_equal(
            out["ecols"].numpy(), mats["E"][inner][:, :, hdr_cols]
        )
        assert (out["frows"].numpy()[:, 0] == NEG_INF_I32).all()
        assert (out["ecols"].numpy()[:, :, 0] == NEG_INF_I32).all()


@pytest.mark.parametrize("spec", ["sw_lg", "sw_ag"])
@pytest.mark.parametrize("rows,cols,th,tw", [
    (50, 1, 16, 64),   # adjc == 2; the tile column is almost all padding
    (3, 65, 16, 64),   # the last tile column holds one live column
])
def test_sw_best_ignores_padding(blosum62, spec, rows, cols, th, tw):
    """Pad letter 0 scores positive against letter 0, so an all-0 pair
    has larger cells in the padding than in the live matrix; the best
    cell must come from the live cells only."""
    y = np.zeros(1 + rows, np.int32)
    x = np.zeros(1 + cols, np.int32)
    args = (blosum62, y, x, spec, _tiles(th, tw))
    port = run_port(*args)
    mats = oracle_align_dense(
        jax_types.AlignSpec.from_name(spec), blosum62, y, x, GAPO, GAPE
    )
    assert (port[1].best_i, port[1].best_j) == tuple(
        int(v) for v in mats["best"]
    )
    assert_same(port, run_jax(*args))


@pytest.mark.parametrize("spec", ["sw_lg", "sw_ag"])
def test_sw_no_positive_cell(spec):
    """No cell > 0: cost 0 and best (0, 0)."""
    subst = np.full((4, 4), -1, np.int32)
    y, x = _seqs(3, 20, 30, letters=4)
    args = (subst, y, x, spec, _tiles(8, 16))
    port = run_port(*args)
    assert port[0] == [0, 0, 0]
    assert (port[2].align_cost, port[1].best_i, port[1].best_j) == (0, 0, 0)
    assert_same(port, run_jax(*args))


@pytest.mark.parametrize("spec", ["nw_ag", "sw_ag"])
@pytest.mark.parametrize("gapo,gape", [(1, -2), (-11, 1)])
def test_affine_positive_cost_is_invalid(blosum62, spec, gapo, gape):
    y, x = _seqs(1, 10, 10)
    args = (blosum62, y, x, spec, _tiles(8, 8))
    port = run_port(*args, gapo=gapo, gape=gape)
    assert port[0] == [int(Status.errorInvalidValue)]
    assert port[0] == run_jax(*args, gapo=gapo, gape=gape)[0]


@pytest.mark.parametrize("th,tw", [(-1, 512), (128, -5)])
def test_tile_below_one_is_invalid(blosum62, th, tw):
    y, x = _seqs(2, 10, 10)
    stats = run_port(blosum62, y, x, "nw_lg", _tiles(th, tw))[0]
    assert stats == [int(Status.errorInvalidValue)]


def test_tuning_keys_accepted_and_ignored(blosum62):
    """The TPU tuning keys change nothing on the port."""
    y, x = _seqs(4, 150, 260)
    base = run_port(blosum62, y, x, "nw_ag", _tiles(64, 128))
    tuned = dict(_tiles(64, 128), kChains=[4], winW=[256], packedx=[1],
                 packedef=[1], rematHdr=[1], noBc=[1], subProw=[1])
    assert_same(run_port(blosum62, y, x, "nw_ag", tuned), base)


def test_wrapper_on_cpu_is_the_plain_version(blosum62):
    """On CPU tensors the kernel wrapper returns the plain version's
    outputs, and counts no launch."""
    yp, xp = _padded(*_seqs(5, 40, 50), 16, 32)
    args = (torch.from_numpy(blosum62), torch.from_numpy(yp),
            torch.from_numpy(xp), GAPO, GAPE, 41, 51)
    kw = dict(tile_h=16, tile_w=32, kind="sw", gap="affine")
    before = mlsp_cuda.LAUNCHES
    got = mlsp_cuda.mlsp_fill(*args, **kw)
    want = mlsp_fill_plain(*args, **kw)
    assert mlsp_cuda.LAUNCHES == before
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "tile"])
def test_wrapper_rejects_bad_inputs(blosum62, bad):
    subst = torch.from_numpy(blosum62)
    y = torch.zeros(1 + 32, dtype=torch.int32)
    x = torch.zeros(1 + 64, dtype=torch.int32)
    th = 16
    if bad == "dtype":
        y = y.long()
    elif bad == "shape":
        x = torch.zeros(1 + 60, dtype=torch.int32)
    elif bad == "contiguous":
        subst = subst.t()
    else:
        th = 0
    with pytest.raises((TypeError, ValueError)):
        mlsp_cuda.mlsp_fill(subst, y, x, GAPO, GAPE, 10, 10, tile_h=th,
                            tile_w=16, kind="nw", gap="linear")


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("name", ["tpu7_pallas_mlsp", "tpu9_giant_mlsp",
                                  "v1"])
def test_trace_at_tile_corner_matches_oracle(name, mirror):
    """A diagonal step onto the header row at a tile-column boundary (1 x
    600 at 128x512), or onto the header column at a tile-row boundary (the
    mirror, 600 x 1 at 512x128; 512x512 for the v1 flow, whose tiles are
    never taller than wide), moves one tile index only: the walk stays on
    that header and gives the oracle's transcript (512 deletions, then a
    match, then 87 deletions; insertions for the mirror)."""
    from gpuseqalign_tpu_torch.core.registry import mlsp
    from gpuseqalign_tpu_torch.ops import wavefront

    subst = np.full((4, 4), -5, np.int32)
    np.fill_diagonal(subst, 10)
    y = np.array([0, 3], np.int32)
    x = np.ones(601, np.int32)
    x[0], x[513] = 0, 3
    th, tw = 128, 512
    if mirror:
        y, x, th, tw = x, y, 512, 512 if name == "v1" else 128
    alg = (mlsp(wavefront.align_mlsp) if name == "v1"
           else get_algorithm_map()[name])
    nw = make_alg_input(subst, y, x, -1, 0, "nw_lg", device="cpu")
    res = AlgResult()
    assert alg.align(AlgParams(_tiles(th, tw)), nw, res) == Status.success
    assert alg.hash(nw, res) == Status.success
    assert alg.trace(nw, res, False) == Status.success
    aspec = jax_types.AlignSpec.from_name("nw_lg")
    mats = oracle_align_dense(aspec, subst, y, x, -1, 0)
    transcript, thash, _ = oracle_trace_dense(aspec, mats, subst, y, x, -1,
                                              0)
    assert transcript == ("512I1=87I" if mirror else "512D1=87D")
    assert res.align_cost == align_cost_of(aspec, mats) == -589
    assert res.edit_trace == transcript
    assert res.trace_hash == thash
    assert res.score_hash == oracle_hash_dense(mats["H"])


@pytest.mark.parametrize("spec", SPECS)
def test_align_host_flow_is_tiled_by_spans(blosum62, spec):
    """The registry's align gives the ``align.*`` spans: the six steps in
    order, one after the other, every torch operator of the align inside
    one of them, and the store's parts inside ``align.store``: the header
    copies, and for NW the last tile's recompute (SW takes its cost from
    the fill's best cell), eight spans in all; the reset after it is the
    span ``align.reset``. The stopwatch keeps the four laps it had."""
    from torch.profiler import ProfilerActivity, profile

    steps = ["align.setup", "align.alloc", "align.cpy_dev", "align.calc",
             "align.cpy_host", "align.store"]
    parts = ["align.store.headers"]
    if spec.startswith("nw"):
        parts.append("align.store.last_tile")
    alg = get_algorithm_map()["tpu7_pallas_mlsp"]
    y, x = _seqs(11, 30, 70)
    nw = make_alg_input(blosum62, y, x, GAPO, GAPE, spec, device="cpu")
    res = AlgResult()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stat = alg.align(AlgParams(_tiles(16, 32)), nw, res)
        cost, rows = res.align_cost, nw.tile_hdr_mat_rows
        nw.reset_cycle()
    assert stat == Status.success and rows == 2
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    spans = [e for e in events if e.name.startswith("align.")]
    assert [e.name for e in spans[-1:]] == ["align.reset"]
    spans = spans[:-1]
    assert sorted(e.name for e in spans) == sorted(steps + parts)
    top = [e for e in spans if e.name in steps]
    assert [e.name for e in top] == steps
    for a, b in zip(top, top[1:]):
        # One after the other: only the stopwatch's bookkeeping between.
        assert 0 <= b.time_range.start - a.time_range.end < 20e3  # us
    store = top[-1].time_range
    for e in spans:
        if e.name.startswith("align.store."):
            assert store.start <= e.time_range.start
            assert e.time_range.end <= store.end
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for op in ops:
        assert any(s.time_range.start <= op.time_range.start
                   and op.time_range.end <= s.time_range.end
                   for s in top), op.name
    assert list(res.sw_align.laps()) == [
        "align.alloc", "align.cpy_dev", "align.calc", "align.cpy_host"]
    aspec = jax_types.AlignSpec.from_name(spec)
    assert cost == align_cost_of(
        aspec, oracle_align_dense(aspec, blosum62, y, x, GAPO, GAPE))


def test_stopwatch_phase_is_a_span_and_a_lap(monkeypatch):
    """``Stopwatch.phase`` laps its name when the block leaves (adding to
    a lap of the same name), inside a ``record_function`` span of that
    name while a profiler records and no span otherwise, and laps nothing
    when the block raises."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpuseqalign_tpu_torch.utils.stopwatch import Stopwatch

    names = []
    enter = record_function.__enter__

    def named_enter(rf):
        names.append(rf.name)
        return enter(rf)

    monkeypatch.setattr(record_function, "__enter__", named_enter)
    sw = Stopwatch()
    sw.start()
    with sw.phase("a"):
        pass
    assert names == [] and list(sw.laps()) == ["a"]
    with profile(activities=[ProfilerActivity.CPU]):
        with sw.phase("b"):
            pass
        with sw.phase("a"):
            pass
        with pytest.raises(KeyError):
            with sw.phase("c"):
                raise KeyError("c")
    assert names == ["b", "a", "c"]
    assert list(sw.laps()) == ["a", "b"]
    assert all(ms >= 0 for ms in sw.laps().values())
