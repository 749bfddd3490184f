"""The port's row-block wavefront path (the v1 NW-linear fills, K2 and K4)
against gpuseqalign_tpu and the numpy oracle, bit for bit.

Inputs are made with numpy from a seed. The port's helpers are held
against the JAX package's own (``_build_pskew`` is plain jnp there; no
Pallas kernel runs in interpret mode here), the plain fills against the
oracle over every element of their outputs, and the host flows, through
the registry's trace and hash bundles, against ``cpu1_st_row`` and the
JAX package's CPU routes of ``tpu7_pallas_mlsp`` (the sparse layout at the
same tile) and ``tpu2_xla_rowscan`` (the H window). No tolerance: every
field is int32 and must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpuseqalign_tpu.core import registry as jax_registry
from gpuseqalign_tpu.core import types as jax_types
from gpuseqalign_tpu.models.oracle import oracle_align_dense
from gpuseqalign_tpu.ops import pallas_wavefront as jax_wf
from gpuseqalign_tpu.ops import skew as jax_skew

from gpuseqalign_tpu_torch.core import registry
from gpuseqalign_tpu_torch.core.types import (
    NEG_INF_I32,
    AlgParams,
    AlgResult,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.ops import skew, wavefront, wavefront_cuda
from gpuseqalign_tpu_torch.ops.wavefront_plain import (
    dense_nw_lg_plain,
    mlsp_nw_lg_plain,
)

SPEC = jax_types.AlignSpec.from_name("nw_lg")
GAPO = -11


def _seq(rng, n, pad_to=None):
    """Header-prefixed random letters, zero-padded to ``pad_to`` residues."""
    s = np.zeros(1 + (pad_to or n), np.int32)
    s[1:n + 1] = rng.integers(0, 25, n)
    return s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rows,cols,R,W", [
    (256, 384, 128, 128), (128, 1024, 128, 256), (2048, 256, 2048, 256),
])
def test_build_pskew_matches_jax(blosum62, rows, cols, R, W):
    rng = np.random.default_rng(rows + cols)
    y, x = _seq(rng, rows), _seq(rng, cols)
    B, NSpad = rows // R, wavefront_cuda.nspad_of(R, cols, W)
    want = np.asarray(jax_wf._build_pskew(
        jnp.asarray(blosum62), jnp.asarray(y), jnp.asarray(x), B, R, NSpad))
    got = wavefront._build_pskew(_t(blosum62), _t(y), _t(x), B, R, NSpad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R,C,extra", [
    (1, 1, 0), (4, 7, 0), (7, 4, 3), (128, 40, 128), (3, 300, 1),
])
def test_unskew_cols_matches_jax(R, C, extra):
    V = np.random.default_rng(R * C).integers(
        -50, 50, (R + C - 1 + extra, R)).astype(np.int32)
    want = jax_skew.unskew_cols(np, V, C)
    got = skew.unskew_cols(_t(V), C)
    assert tuple(got.shape) == (R, C)
    np.testing.assert_array_equal(got.numpy(), want)


def test_choose_r_and_params_ok_match_jax():
    for rows in (0, 1, 127, 128, 129, 1000, 1024, 1025, 23728):
        for tile_by in (0, 1, 100, 128, 256, 384, 2048, 4096):
            assert (wavefront._choose_r(rows, tile_by)
                    == jax_wf._choose_r(rows, tile_by)), (rows, tile_by)
    for th in (1, 64, 128, 256, 384, 512, 1024, 2048):
        for tw in (1, 76, 128, 256, 384, 512, 640, 1024, 1536, 2048):
            assert (wavefront.mlsp_params_ok(th, tw)
                    == jax_wf.mlsp_params_ok(th, tw)), (th, tw)


def _expected(H, R, TW, W, NSpad, cols_p):
    """The kernels' outputs built from the oracle's H of the padded pair:
    hrow, hcol (the contract of ops/wavefront_plain.py) and vhist."""
    rows_p = H.shape[0] - 1
    B, SUB = rows_p // R, R // 128
    hrow = np.full((B, NSpad + 128), NEG_INF_I32, np.int32)
    hrow[:, :cols_p + 1] = H[R::R]
    ct = -(-(NSpad // W) // (TW // W))
    hcol = np.full((B, ct, R), NEG_INF_I32, np.int32)
    for k in range(1, cols_p // TW + 1):
        hcol[:, k] = H[1:, k * TW].reshape(B, R)
    vhist = np.full((B, NSpad, R), NEG_INF_I32, np.int32)
    for b in range(B):
        for r in range(R):
            i = b * R + r + 1
            vhist[b, r:r + cols_p, r] = H[i, 1:]
    return (hrow, hcol.reshape(B, ct, SUB, 128),
            vhist.reshape(B, NSpad, SUB, 128))


# The JAX package's own cases (tests/test_pallas_wavefront.py), then TW ==
# R with several blocks, rows and columns that are not tile multiples
# (zero-padded as the host flows pad them), one block of R = 2048, a
# one-row pair, and two other gap costs.
FILL_CASES = [  # rows, cols, R, TW, W, gapo: rows and cols are residues
    (256, 384, 128, 128, 128, GAPO),
    (512, 512, 256, 256, 256, GAPO),
    (128, 1024, 128, 512, 256, GAPO),
    (384, 256, 128, 128, 128, GAPO),
    (300, 700, 128, 512, 512, GAPO),
    (2048, 2048, 2048, 2048, 512, GAPO),
    (1, 5, 128, 128, 128, GAPO),
    (256, 256, 128, 128, 128, -1),
    (256, 256, 128, 128, 128, 0),
]


@pytest.mark.parametrize("rows,cols,R,TW,W,gapo", FILL_CASES)
def test_fills_match_oracle(blosum62, rows, cols, R, TW, W, gapo):
    rng = np.random.default_rng(3 * rows + cols - gapo)
    rows_p, cols_p = -(-rows // R) * R, -(-cols // TW) * TW
    y, x = _seq(rng, rows, rows_p), _seq(rng, cols, cols_p)
    H = oracle_align_dense(SPEC, blosum62, y, x, gapo)["H"]
    NSpad = wavefront_cuda.nspad_of(R, cols_p, W)
    hrow_w, hcol_w, vhist_w = _expected(H, R, TW, W, NSpad, cols_p)

    hrow, hcol = wavefront.mlsp_nw_lg(_t(blosum62), _t(y), _t(x), gapo,
                                      R=R, W=W, TW=TW)
    np.testing.assert_array_equal(hrow.numpy(), hrow_w)
    np.testing.assert_array_equal(hcol.numpy(), hcol_w)
    # Outside the contract (hcol[:, 0], past cols_p) every element is -inf.
    assert (hcol.numpy()[:, 0] == NEG_INF_I32).all()
    assert (hrow.numpy()[:, cols_p + 1:] == NEG_INF_I32).all()

    Hd = wavefront.dense_nw_lg(_t(blosum62), _t(y), _t(x), gapo, R=R, W=W)
    np.testing.assert_array_equal(Hd.numpy(), H)
    pskew = wavefront._build_pskew(_t(blosum62), _t(y), _t(x), rows_p // R,
                                   R, NSpad)
    vhist = wavefront_cuda.dense_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W)
    np.testing.assert_array_equal(vhist.numpy(), vhist_w)


def _pskew(blosum62, rows_p, cols_p, R, W, seed=0):
    rng = np.random.default_rng(seed)
    y, x = _seq(rng, rows_p), _seq(rng, cols_p)
    return wavefront._build_pskew(_t(blosum62), _t(y), _t(x), rows_p // R,
                                  R, wavefront_cuda.nspad_of(R, cols_p, W))


def test_wrappers_on_cpu_are_the_plain_versions(blosum62):
    """On a CPU tensor each wrapper returns its plain version's outputs
    and counts no launch."""
    pskew = _pskew(blosum62, 256, 512, 128, 256)
    before = dict(wavefront_cuda.LAUNCHES)
    got = wavefront_cuda.mlsp_nw_lg_fill(pskew, GAPO, cols_p=512, W=256,
                                         TW=256)
    want = mlsp_nw_lg_plain(pskew, GAPO, cols_p=512, W=256, TW=256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = wavefront_cuda.dense_nw_lg_fill(pskew, GAPO, cols_p=512, W=256)
    assert torch.equal(got, dense_nw_lg_plain(pskew, GAPO, cols_p=512))
    assert wavefront_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    "dtype", "shape", "steps", "r_not_128", "tw_below_r", "r_too_large",
])
def test_wrappers_reject_bad_inputs(blosum62, bad):
    R, TW, W, cols_p = 256, 256, 256, 512
    pskew = _pskew(blosum62, 256, cols_p, R, W)
    if bad == "dtype":
        pskew = pskew.long()
    elif bad == "shape":
        pskew = pskew.view(pskew.shape[0], pskew.shape[1], -1)
    elif bad == "steps":
        pskew = pskew[:, :-128].contiguous()
    elif bad == "r_not_128":
        pskew = pskew.view(*pskew.shape[:2], 4, 64)
    elif bad == "tw_below_r":
        TW = 128
    else:
        R = TW = wavefront_cuda.MAX_R + 128
        pskew = torch.empty((1, wavefront_cuda.nspad_of(R, cols_p, W),
                             R // 128, 128), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        wavefront_cuda.mlsp_nw_lg_fill(pskew, GAPO, cols_p=cols_p, W=W,
                                       TW=TW)
    if bad != "tw_below_r":
        with pytest.raises((TypeError, ValueError)):
            wavefront_cuda.dense_nw_lg_fill(pskew, GAPO, cols_p=cols_p, W=W)


# The v1 flows in the registry's bundles (no registry name reaches them).
FLOWS = {
    "mlsp": registry.mlsp(wavefront.align_mlsp),
    "dense": registry.dense(wavefront.align_dense),
}


def run_port(alg, subst, y, x, params, spec="nw_lg"):
    """align -> score hash -> trace through a registry bundle, on the CPU."""
    nw = make_alg_input(subst, y, x, GAPO, 0, spec, device="cpu")
    res = AlgResult()
    stats = [alg.align(AlgParams(params), nw, res)]
    if stats[0] == Status.success:
        stats.append(alg.hash(nw, res))
        stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


def run_jax(name, subst, y, x, params):
    """The same through gpuseqalign_tpu's registry on its CPU route."""
    alg = jax_registry.get_algorithm_map()[name]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = subst, subst.shape[0]
    nw.seqY, nw.seqX = y, x
    nw.adjrows, nw.adjcols = len(y), len(x)
    nw.gapo_cost, nw.gape_cost = GAPO, 0
    nw.spec = SPEC
    res = jax_types.AlgResult()
    stats = [alg.align(jax_types.AlgParams(params), nw, res)]
    stats.append(alg.hash(nw, res))
    stats.append(alg.trace(nw, res, False))
    return [int(s) for s in stats], nw, res


# pair_debug.txt-style shapes: 1 x 1, one side short, both sides short
# of a tile and past it.
FLOW_CASES = [(1, 1), (5, 300), (300, 5), (200, 700), (130, 515)]
TILE = {"tileBy": [128], "tileBx": [512]}


@pytest.mark.parametrize("rows,cols", FLOW_CASES)
def test_flows_match_reference(blosum62, rows, cols):
    rng = np.random.default_rng(rows * 31 + cols)
    y, x = _seq(rng, rows), _seq(rng, cols)
    ref = run_port(registry.get_algorithm_map()["cpu1_st_row"], blosum62, y,
                   x, {})
    assert ref[0] == [0, 0, 0]
    for name, params in (("mlsp", TILE), ("dense", {})):
        stats, nw, res = run_port(FLOWS[name], blosum62, y, x, params)
        assert stats == [0, 0, 0], name
        for field in ("align_cost", "score_hash", "trace_hash",
                      "edit_trace"):
            assert getattr(res, field) == getattr(ref[2], field), (name,
                                                                   field)
        if name == "mlsp":
            _, jnw, _ = run_jax("tpu7_pallas_mlsp", blosum62, y, x, TILE)
            for mat in ("tileHrowMat", "tileHcolMat"):
                np.testing.assert_array_equal(getattr(nw, mat),
                                              getattr(jnw, mat), mat)
            assert (nw.tile_hdr_mat_rows, nw.tile_hdr_mat_cols) == (
                jnw.tile_hdr_mat_rows, jnw.tile_hdr_mat_cols)
        else:
            _, jnw, _ = run_jax("tpu2_xla_rowscan", blosum62, y, x, {})
            np.testing.assert_array_equal(nw.score, jnw.score)
        assert res.shmem_peak_allocs == 0  # the kernel has no shared memory


@pytest.mark.parametrize("spec", ["nw_ag", "sw_lg", "sw_ag"])
@pytest.mark.parametrize("flow", ["mlsp", "dense"])
def test_other_specs_are_invalid(blosum62, spec, flow):
    rng = np.random.default_rng(2)
    y, x = _seq(rng, 20), _seq(rng, 30)
    assert run_port(FLOWS[flow], blosum62, y, x, TILE, spec)[0] == [
        int(Status.errorInvalidValue)]


@pytest.mark.parametrize("params", [
    {"tileBy": [128], "tileBx": [76]},     # tile width not a multiple of 128
    {"tileBy": [512], "tileBx": [128]},    # TW < R
    {"tileBy": [8192], "tileBx": [8192]},  # R above the largest instance
])
def test_sparse_tiles_the_kernel_refuses_are_invalid(blosum62, params):
    rng = np.random.default_rng(3)
    y, x = _seq(rng, 20), _seq(rng, 30)
    assert run_port(FLOWS["mlsp"], blosum62, y, x, params)[0] == [
        int(Status.errorInvalidValue)]
