"""The giant engine's calls taller than a pass (``parallel/giant2.py``):
at D > 1 a band's K7 call holds C passes, and every C gives the layout of
D = 1 and of gpuseqalign_tpu's CPU route, bit for bit.

Inputs are made with numpy from a seed. The port runs K7's plain version
on a CPU mesh that names the CPU D times; the reference is the JAX
registry's CPU route of ``tpu7_pallas_mlsp`` at the same tile (its XLA
row scan; no Pallas interpret mode). ``banded_cuda.LAUNCHES`` counts CUDA
launches only, so the schedule's calls are counted by wrapping
``banded_pass``.
"""

import numpy as np
import pytest

from gpuseqalign_tpu.core import registry as jax_registry
from gpuseqalign_tpu.core import types as jax_types

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.ops import banded_cuda
from gpuseqalign_tpu_torch.parallel import (
    align_giant2,
    align_giant2_stream,
    call_model_steps,
    make_mesh,
    pick_call_passes,
)
from gpuseqalign_tpu_torch.parallel import giant2

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2
MATS = ("tileHrowMat", "tileHcolMat", "tileFrowMat", "tileEcolMat")
# One row block a pass (kChains 1, passBlocks 1): 300 rows are 3 passes of
# 128 rows, so calls of 1, 2 (a short last call) and 3 passes.
PARAMS = {"tileBy": [128], "tileBx": [128], "kChains": [1],
          "passBlocks": [1]}
SHAPE = (300, 500)
N_PASS = 3


def _gape(spec):
    return GAPE if spec.endswith("ag") else 0


def _seqs(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return (np.concatenate([[0], rng.integers(0, 25, rows)]).astype(np.int32),
            np.concatenate([[0], rng.integers(0, 25, cols)]).astype(np.int32))


def _finish(alg, nw, res, stat):
    stats = [stat]
    if stat == Status.success:
        stats += [alg.hash(nw, res), alg.trace(nw, res, False)]
    return [int(s) for s in stats], nw, res


def run_port(subst, y, x, spec, D, params=PARAMS):
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    nw = make_alg_input(subst, y, x, GAPO, _gape(spec), spec, device="cpu")
    res = AlgResult()
    mesh = make_mesh(devices=["cpu"] * D, axis_name="sp")
    return _finish(alg, nw, res, align_giant2(AlgParams(params), nw, res,
                                              mesh=mesh))


def run_jax_tpu7(subst, y, x, spec):
    alg = jax_registry.get_algorithm_map()["tpu7_pallas_mlsp"]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = subst, subst.shape[0]
    nw.seqY, nw.seqX = y, x
    nw.adjrows, nw.adjcols = len(y), len(x)
    nw.gapo_cost, nw.gape_cost = GAPO, _gape(spec)
    nw.spec = jax_types.AlignSpec.from_name(spec)
    res = jax_types.AlgResult()
    stat = alg.align(jax_types.AlgParams({"tileBy": [128],
                                          "tileBx": [128]}), nw, res)
    return _finish(alg, nw, res, stat)


def assert_same(port, ref):
    """Statuses, cost, hashes, transcript, best cell and every sparse mat
    on the tiles both layouts have."""
    (ps, pnw, pres), (rs, rnw, rres) = port, ref
    assert ps == rs == [0, 0, 0]
    for name in ("align_cost", "score_hash", "trace_hash", "edit_trace"):
        assert getattr(pres, name) == getattr(rres, name), name
    assert (pnw.best_i, pnw.best_j) == (rnw.best_i, rnw.best_j)
    tr = min(pnw.tile_hdr_mat_rows, rnw.tile_hdr_mat_rows)
    tc = min(pnw.tile_hdr_mat_cols, rnw.tile_hdr_mat_cols)
    for name in MATS:
        a, b = getattr(pnw, name), getattr(rnw, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a = a.reshape(pnw.tile_hdr_mat_rows, pnw.tile_hdr_mat_cols, -1)
        b = b.reshape(rnw.tile_hdr_mat_rows, rnw.tile_hdr_mat_cols, -1)
        np.testing.assert_array_equal(a[:tr, :tc], b[:tr, :tc],
                                      err_msg=name)


@pytest.fixture
def count_calls(monkeypatch):
    """banded_pass wrapped: the list of each call's row blocks."""
    calls = []
    real = banded_cuda.banded_pass

    def counted(subst, y, *args, **kw):
        calls.append((y.numel() - 1) // kw["tile_h"])
        return real(subst, y, *args, **kw)

    monkeypatch.setattr(banded_cuda, "banded_pass", counted)
    return calls


@pytest.fixture(scope="module")
def refs(blosum62):
    """Per spec: the JAX tpu7 CPU route's result and the port's D = 1."""
    y, x = _seqs(11, *SHAPE)
    return {spec: (run_jax_tpu7(blosum62, y, x, spec),
                   run_port(blosum62, y, x, spec, 1)) for spec in SPECS}


@pytest.mark.parametrize("C", range(1, N_PASS + 1))
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("spec", SPECS)
def test_call_height_matches_d1_and_jax(blosum62, refs, count_calls,
                                        monkeypatch, spec, D, C):
    """Every call height from one pass to the whole band: the layout of
    D = 1 and of the JAX CPU route, and D x n_calls banded_pass calls of
    C row blocks (the last call of the pair shorter)."""
    monkeypatch.setattr(giant2, "pick_call_passes", lambda *a, **k: C)
    y, x = _seqs(11, *SHAPE)
    port = run_port(blosum62, y, x, spec, D)
    jax_ref, d1 = refs[spec]
    assert_same(port, jax_ref)
    assert_same(port, d1)
    heights = [min(C, N_PASS - p) for p in range(0, N_PASS, C)]
    assert sorted(count_calls) == sorted(heights * D)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_fill_plan_is_the_schedule_run(blosum62, count_calls, D):
    """fill_plan's C and calls are what align_giant2 runs: D x calls
    banded_pass calls of C·BL row blocks (the last one shorter)."""
    y, x = _seqs(11, *SHAPE)
    plan = giant2.fill_plan(AlgParams(PARAMS), [SHAPE[0]], [SHAPE[1]], D)
    assert plan.n_pass == (N_PASS,)
    assert plan.C == pick_call_passes(N_PASS, D, BL=plan.BL,
                                      band_cols=plan.band_cols)
    run_port(blosum62, y, x, "nw_lg", D)
    assert len(count_calls) == D * plan.calls
    assert max(count_calls) == plan.C * plan.BL


def test_d1_is_one_call_a_band(blosum62, count_calls):
    y, x = _seqs(11, *SHAPE)
    run_port(blosum62, y, x, "nw_ag", 1)
    assert count_calls == [N_PASS]


@pytest.mark.parametrize("C,D", [(1, 2), (2, 2), (2, 3), (None, 1)])
def test_stream_calls_stop_at_each_pair(blosum62, count_calls, monkeypatch,
                                        C, D):
    """A stream of pairs of 3, 1 and 2 passes: calls never cross a pair's
    edge (D x the sum of ceil(passes / C) calls; one a pair at D = 1), and
    every pair's result equals align_giant2 on it alone at D = 1."""
    if C is not None:
        monkeypatch.setattr(giant2, "pick_call_passes", lambda *a, **k: C)
    sizes = [(300, 500), (90, 200), (256, 300)]
    pairs = [_seqs(20 + k, r, c) for k, (r, c) in enumerate(sizes)]
    passes = [3, 1, 2]
    inputs = [make_alg_input(blosum62, y, x, GAPO, _gape("sw_ag"), "sw_ag",
                             device="cpu") for y, x in pairs]
    results = [AlgResult() for _ in inputs]
    mesh = make_mesh(devices=["cpu"] * D, axis_name="sp")
    stats = align_giant2_stream(AlgParams(PARAMS), inputs, results,
                                mesh=mesh)
    C_ = C or max(passes)
    heights = [min(C_, n - p) for n in passes for p in range(0, n, C_)]
    assert sorted(count_calls) == sorted(heights * D)
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    for (y, x), nw, res, stat in zip(pairs, inputs, results, stats):
        single = run_port(blosum62, y, x, "sw_ag", 1)
        assert_same(_finish(alg, nw, res, stat), single)


# The 100000^2 pair at the engine's geometry off the card: R = TW = 128,
# BL = 16 at D = 1 (49 passes) and 2 at D > 1 (391 passes).
GIANT = 100000


def _geometry(D):
    plan = giant2.fill_plan(AlgParams({}), [GIANT], [GIANT], D)
    return plan.n_pass[0], plan.BL, plan.band_cols


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_pick_call_passes_minimizes_its_model(D):
    n_pass, BL, bc = _geometry(D)
    C = pick_call_passes(n_pass, D, BL=BL, band_cols=bc)
    steps = [call_model_steps([n_pass], c, D, BL=BL, band_cols=bc)
             for c in range(1, n_pass + 1)]
    if D == 1:
        assert C == n_pass  # one call a band
    else:
        assert steps[C - 1] == min(steps)
        assert C == steps.index(min(steps)) + 1  # the smallest of equals


def test_call_rows_grow_with_the_band():
    """At 100000^2: C·BL falls as the band narrows (D = 2, 4, 8), lies in
    the 200-400 row blocks the model predicts at D = 2 and 4, and the
    model's pipeline stays within twice D = 1's steps."""
    rows, steps = [], []
    for D in (2, 4, 8):
        n_pass, BL, bc = _geometry(D)
        C = pick_call_passes(n_pass, D, BL=BL, band_cols=bc)
        rows.append(C * BL)
        steps.append(call_model_steps([n_pass], C, D, BL=BL, band_cols=bc))
    assert rows == sorted(rows, reverse=True)
    assert all(150 <= r <= 400 for r in rows[:2])
    n1, BL1, bc1 = _geometry(1)
    one = call_model_steps([n1], n1, 1, BL=BL1, band_cols=bc1)
    assert all(s < 2 * one for s in steps[:2])


def test_stream_model_counts_calls_per_pair():
    """n_calls is the sum over pairs: no call crosses a pair's edge."""
    assert call_model_steps([3, 1, 2], 2, 2, BL=1, band_cols=128) == (
        (2 + 1 + 1) + 1) * (128 + 1 * giant2.LAG_STEPS)
    assert pick_call_passes([3, 1, 2], 1, BL=1, band_cols=128) == 3
