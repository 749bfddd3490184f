"""The port's dense path against gpuseqalign_tpu, bit for bit.

Inputs are made with numpy from a seed and handed to both packages: the
port through ``make_alg_input`` on the CPU (the plain PyTorch fills), the
JAX package through its own AlgInput and its CPU route of the same
registry names (``tpu3_pallas_dense`` runs the XLA row scan there; no
Pallas kernel). The plain fills are also held against the JAX XLA fills
and the numpy oracle on the same padded inputs. No tolerance: every field
is int32 and must be identical. Every shape pads to the JAX package's
129- or 257-wide compile buckets.
"""

import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core import registry as jax_registry
from gpuseqalign_tpu.core import types as jax_types
from gpuseqalign_tpu.models.oracle import oracle_align_dense
from gpuseqalign_tpu.ops import skew as jax_skew
from gpuseqalign_tpu.ops import xla_kernels

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.io.params import parse_alg_params_file
from gpuseqalign_tpu_torch.ops import dense_cuda, dense_plain, skew

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
NAMES = ["tpu3_pallas_dense", "tpu1_xla_diag", "tpu2_xla_rowscan"]
GAPO, GAPE = -11, -2
RESRC = os.path.join(os.path.dirname(__file__), "..", "resrc")


def _seqs(seed, rows, cols, letters=25):
    rng = np.random.default_rng(seed)
    y = np.concatenate([[0], rng.integers(0, letters, rows)]).astype(np.int32)
    x = np.concatenate([[0], rng.integers(0, letters, cols)]).astype(np.int32)
    return y, x


def _kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


def run_port(name, subst, y, x, spec, params=None, gapo=GAPO, gape=GAPE):
    """align -> score hash -> trace through the port's registry."""
    alg = get_algorithm_map()[name]
    nw = make_alg_input(subst, y, x, gapo, gape, spec, device="cpu")
    res = AlgResult()
    stats = [alg.align(AlgParams(params or {}), nw, res)]
    if stats[0] == Status.success:
        stats.append(alg.hash(nw, res))
        stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


def run_jax(name, subst, y, x, spec, params=None, gapo=GAPO, gape=GAPE):
    """The same through gpuseqalign_tpu's registry on its CPU route."""
    alg = jax_registry.get_algorithm_map()[name]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = subst, subst.shape[0]
    nw.seqY, nw.seqX = y, x
    nw.adjrows, nw.adjcols = len(y), len(x)
    nw.gapo_cost, nw.gape_cost = gapo, gape
    nw.spec = jax_types.AlignSpec.from_name(spec)
    res = jax_types.AlgResult()
    stats = [alg.align(jax_types.AlgParams(params or {}), nw, res)]
    if stats[0] == jax_types.Status.success:
        stats.append(alg.hash(nw, res))
        stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


def assert_same(port, ref):
    (ps, pnw, pres), (rs, rnw, rres) = port, ref
    assert ps == rs
    assert (pnw.score is None) == (rnw.score is None)
    if pnw.score is not None:
        assert pnw.score.dtype == rnw.score.dtype == np.int32
        np.testing.assert_array_equal(pnw.score, rnw.score)
    for name in ("best_i", "best_j"):
        assert getattr(pnw, name) == getattr(rnw, name), name
    for name in ("align_cost", "score_hash", "trace_hash", "edit_trace"):
        assert getattr(pres, name) == getattr(rres, name), name


# (residues of y, residues of x): an empty side, 1x1, 1xN, Nx1, square,
# rectangular, and sides past one 128-lane bucket; none but 128 is a
# multiple of 128.
SHAPES = [(0, 5), (1, 1), (1, 100), (100, 1), (128, 128), (77, 120),
          (130, 200)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_dense_path_matches_jax(blosum62, name, spec, rows, cols):
    y, x = _seqs(rows * 7 + cols, rows, cols)
    port = run_port(name, blosum62, y, x, spec)
    assert port[0] == [0, 0, 0]
    assert_same(port, run_jax(name, blosum62, y, x, spec))


def test_aliases_match_jax():
    """Every JAX name, the giant engine's too, in the JAX map's order, and
    each alias bound to the port's entry of the JAX alias's target."""
    jmap = jax_registry.get_algorithm_map()
    pmap = get_algorithm_map()
    assert list(pmap) == list(jmap)
    for name in pmap:
        target = next(m for m in jmap if jmap[m] is jmap[name])
        assert pmap[name] is pmap[target], name


def _padded(y, x):
    rows_p = -(-max(len(y) - 1, 1) // 128) * 128
    cols_p = -(-max(len(x) - 1, 1) // 128) * 128
    yp = np.zeros(1 + rows_p, np.int32)
    xp = np.zeros(1 + cols_p, np.int32)
    yp[: len(y)], xp[: len(x)] = y, x
    return yp, xp


@pytest.mark.parametrize("fn", ["rowscan_dense", "diag_dense"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols", [(1, 100), (77, 120), (130, 200)])
def test_plain_fill_matches_jax_and_oracle(blosum62, fn, spec, rows, cols):
    """The whole padded H, header and padding included."""
    yp, xp = _padded(*_seqs(rows + cols, rows, cols))
    got = getattr(dense_plain, fn)(
        torch.from_numpy(blosum62), torch.from_numpy(yp),
        torch.from_numpy(xp), GAPO, GAPE, **_kind_gap(spec)).numpy()
    want = np.asarray(getattr(xla_kernels, fn)(
        blosum62, yp, xp, np.int32(GAPO), np.int32(GAPE), **_kind_gap(spec)))
    assert got.dtype == np.int32 and got.shape == (len(yp), len(xp))
    np.testing.assert_array_equal(got, want)
    mats = oracle_align_dense(jax_types.AlignSpec.from_name(spec), blosum62,
                              yp, xp, GAPO, GAPE)
    np.testing.assert_array_equal(got, mats["H"])


@pytest.mark.parametrize("rows,cols", [(5, 7), (1, 9), (9, 1), (130, 3)])
def test_skew_matches_jax(rows, cols):
    P = np.random.default_rng(rows).integers(-99, 99, (rows, cols)).astype(
        np.int32)
    S = skew.skew_rows(torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(S, jax_skew.skew_rows(np, P))
    np.testing.assert_array_equal(
        skew.unskew_rows(torch.from_numpy(S), rows).numpy(),
        jax_skew.unskew_rows(np, S, rows))
    np.testing.assert_array_equal(
        skew.unskew_rows(torch.from_numpy(S), rows).numpy(), P)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("spec", ["nw_ag", "sw_ag"])
@pytest.mark.parametrize("gapo,gape", [(1, -2), (-11, 1)])
def test_affine_positive_cost_is_invalid(blosum62, name, spec, gapo, gape):
    y, x = _seqs(1, 10, 10)
    port = run_port(name, blosum62, y, x, spec, gapo=gapo, gape=gape)
    assert port[0] == [int(Status.errorInvalidValue)]
    assert port[0] == run_jax(name, blosum62, y, x, spec, gapo=gapo,
                              gape=gape)[0]


_GPU_ALIASES = ["NwAlign_Gpu1_Ml_Diag", "NwAlign_Gpu2_Ml_DiagRow2Pass",
                "NwAlign_Gpu3_Ml_DiagDiag", "NwAlign_Gpu4_Ml_DiagDiag2Pass",
                "NwAlign_Gpu5_Coop_DiagDiag",
                "NwAlign_Gpu6_Coop_DiagDiag2Pass"]


@pytest.mark.parametrize("name", _GPU_ALIASES)
def test_tuning_keys_accepted_and_ignored(blosum62, name):
    """The reference's tuned keys (resrc/param_best.json) and every other
    dense tuning key change neither the result nor the Status."""
    best = parse_alg_params_file(os.path.join(RESRC, "param_best.json"))
    keys = dict(best[name], threadsPerBlock=[32], threadsPerBlockA=[64],
                tileAx=[8], tileAy=[8], tileBx=[3], tileBy=[256],
                kChains=[4])
    y, x = _seqs(11, 150, 90)
    base = run_port(name, blosum62, y, x, "sw_ag")
    assert base[0] == [0, 0, 0]
    assert_same(run_port(name, blosum62, y, x, "sw_ag", best[name]), base)
    assert_same(run_port(name, blosum62, y, x, "sw_ag", keys), base)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols", [(40, 70), (0, 9), (9, 0)])
def test_wrapper_on_cpu_is_the_plain_version(blosum62, spec, rows, cols):
    """On CPU tensors the kernel wrapper returns the (adjr, adjc) window of
    the plain row scan over the padded inputs, and counts no launch."""
    y, x = _seqs(5, rows, cols)
    yp, xp = (torch.from_numpy(a) for a in _padded(y, x))
    subst = torch.from_numpy(blosum62)
    before = dense_cuda.LAUNCHES
    got = dense_cuda.dense_fill(subst, yp, xp, GAPO, GAPE, len(y), len(x),
                                **_kind_gap(spec))
    want = dense_plain.rowscan_dense(subst, yp, xp, GAPO, GAPE,
                                     **_kind_gap(spec))
    assert dense_cuda.LAUNCHES == before
    assert got.shape == (len(y), len(x)) and got.dtype == torch.int32
    assert torch.equal(got, want[: len(y), : len(x)])


@pytest.mark.parametrize("bad", ["dtype", "square", "contiguous", "adjr",
                                 "adjc"])
def test_wrapper_rejects_bad_inputs(blosum62, bad):
    subst = torch.from_numpy(blosum62)
    y = torch.zeros(1 + 32, dtype=torch.int32)
    x = torch.zeros(1 + 64, dtype=torch.int32)
    adjr, adjc = 10, 10
    if bad == "dtype":
        y = y.long()
    elif bad == "square":
        subst = subst[:, :5].contiguous()
    elif bad == "contiguous":
        subst = subst.t()
    elif bad == "adjr":
        adjr = 34
    else:
        adjc = 0
    with pytest.raises((TypeError, ValueError)):
        dense_cuda.dense_fill(subst, y, x, GAPO, GAPE, adjr, adjc,
                              kind="nw", gap="linear")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("name", NAMES)
def test_align_defaults_to_the_card(blosum62, no_cuda, name):
    y, x = _seqs(2, 10, 10)
    nw = make_alg_input(blosum62, y, x, GAPO, 0, "nw_lg")
    assert nw.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        get_algorithm_map()[name].align(AlgParams({}), nw, AlgResult())
