"""The port's giant-pair engines, mesh, batch mesh branch and multihost
batch against gpuseqalign_tpu, bit for bit.

Inputs are made with numpy from a seed and handed to both packages. The
banded engine (``parallel/giant2.align_giant2``, K7's plain version on a
CPU mesh that names the CPU D times) is held against the JAX registry's
CPU route of ``tpu7_pallas_mlsp`` at the same tile (its XLA row scan; no
Pallas interpret mode), the portable engine (``parallel/giant.py``)
against the JAX one on its virtual CPU devices. No tolerance: every field
is int32 and must be identical.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core import registry as jax_registry
from gpuseqalign_tpu.core import types as jax_types
from gpuseqalign_tpu.ops import pallas_wavefront2 as jax_wavefront2
from gpuseqalign_tpu.parallel import giant2 as jax_giant2
from gpuseqalign_tpu.parallel.giant import (
    align_giant_mlsp as jax_align_giant_mlsp,
)
from gpuseqalign_tpu.parallel.mesh import make_mesh as jax_make_mesh

from gpuseqalign_tpu_torch.bench import throughput
from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    AlignSpec,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.ops import banded_cuda
from gpuseqalign_tpu_torch.ops.banded_plain import banded_pass_plain
from gpuseqalign_tpu_torch.ops.mlsp_kernels import _mlsp_store, tile_headers
from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain
from gpuseqalign_tpu_torch.parallel import (
    align_giant2,
    align_giant2_stream,
    align_giant_mlsp,
    align_pairs_batched,
    align_pairs_multihost,
    distributed_init,
    make_mesh,
)
from gpuseqalign_tpu_torch.parallel import giant2
from gpuseqalign_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    synchronize_mesh,
)

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2
MATS = ("tileHrowMat", "tileHcolMat", "tileFrowMat", "tileEcolMat")
TILES = {"tileBy": [128], "tileBx": [128]}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gape(spec):
    return GAPE if spec.endswith("ag") else 0


def _seqs(seed, rows, cols, letters=25):
    rng = np.random.default_rng(seed)
    y = np.concatenate([[0], rng.integers(0, letters, rows)]).astype(np.int32)
    x = np.concatenate([[0], rng.integers(0, letters, cols)]).astype(np.int32)
    return y, x


def _cpu_mesh(D):
    return make_mesh(devices=["cpu"] * D, axis_name="sp")


def _finish(alg, nw, res, stat):
    stats = [stat]
    if stat == Status.success:
        stats += [alg.hash(nw, res), alg.trace(nw, res, False)]
    return [int(s) for s in stats], nw, res


def run_port(subst, y, x, spec, align, params=None, **kw):
    """align -> score hash -> trace with the port's sparse trace/hash."""
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    nw = make_alg_input(subst, y, x, GAPO, _gape(spec), spec, device="cpu")
    res = AlgResult()
    return _finish(alg, nw, res, align(AlgParams(params or {}), nw, res,
                                       **kw))


def run_jax(subst, y, x, spec, name, params=None, align=None, **kw):
    """The same through gpuseqalign_tpu on its CPU route."""
    alg = jax_registry.get_algorithm_map()[name]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = subst, subst.shape[0]
    nw.seqY, nw.seqX = y, x
    nw.adjrows, nw.adjcols = len(y), len(x)
    nw.gapo_cost, nw.gape_cost = GAPO, _gape(spec)
    nw.spec = jax_types.AlignSpec.from_name(spec)
    res = jax_types.AlgResult()
    stat = (align or alg.align)(jax_types.AlgParams(params or {}), nw, res,
                                **kw)
    return _finish(alg, nw, res, stat)


def assert_same(port, ref, layout=True):
    """Statuses, cost, hashes and transcript; with ``layout``, the best
    cell and every sparse mat on the tiles both layouts have (the giant
    layout pads its rows to whole passes and its columns to whole
    bands)."""
    (ps, pnw, pres), (rs, rnw, rres) = port, ref
    assert ps == rs
    for name in ("align_cost", "score_hash", "trace_hash", "edit_trace"):
        assert getattr(pres, name) == getattr(rres, name), name
    if not layout:
        return
    assert (pnw.best_i, pnw.best_j) == (rnw.best_i, rnw.best_j)
    tr, tc = rnw.tile_hdr_mat_rows, rnw.tile_hdr_mat_cols
    assert pnw.tile_hdr_mat_rows >= tr and pnw.tile_hdr_mat_cols >= tc
    for name in MATS:
        a, b = getattr(pnw, name), getattr(rnw, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a = a.reshape(pnw.tile_hdr_mat_rows, pnw.tile_hdr_mat_cols, -1)
        np.testing.assert_array_equal(a[:tr, :tc],
                                      b.reshape(tr, tc, -1), err_msg=name)


# 300 rows at R = 128 and K = 2 give two passes of two row blocks; 500
# columns give band_cols 512, 256 and 256 at D = 1, 2, 3 (> TW = 128).
GIANT_SHAPE = (300, 500)


@pytest.fixture(scope="module")
def jax_tpu7(blosum62):
    """JAX tpu7_pallas_mlsp (CPU route) at the giant tile, per spec."""
    y, x = _seqs(7, *GIANT_SHAPE)
    return {spec: run_jax(blosum62, y, x, spec, "tpu7_pallas_mlsp", TILES)
            for spec in SPECS}


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("spec", SPECS)
def test_giant2_matches_jax(blosum62, jax_tpu7, spec, D):
    y, x = _seqs(7, *GIANT_SHAPE)
    port = run_port(blosum62, y, x, spec, align_giant2, mesh=_cpu_mesh(D))
    assert port[0] == [0, 0, 0]
    assert port[1].tile_hdr_mat_rows == 4  # two passes of two blocks
    assert_same(port, jax_tpu7[spec])


def run_port_tpu7(subst, y, x, spec):
    alg = get_algorithm_map()["tpu7_pallas_mlsp"]
    nw = make_alg_input(subst, y, x, GAPO, _gape(spec), spec, device="cpu")
    res = AlgResult()
    return _finish(alg, nw, res, alg.align(AlgParams(TILES), nw, res))


# Against the port's own tpu7 (itself held against JAX in
# test_torch_mlsp.py): an explicit passBlocks (BL = 4 row blocks a pass,
# padded rows), other kChains, degenerate pairs and four bands.
@pytest.mark.parametrize("spec,rows,cols,D,params", [
    ("nw_lg", 700, 1100, 2, {"kChains": [1], "passBlocks": [2]}),
    ("nw_ag", 700, 1100, 2, {"passBlocks": [2]}),
    ("sw_lg", 700, 1100, 3, {"kChains": [3]}),
    ("sw_ag", 700, 1100, 1, {"passBlocks": [2]}),
    ("nw_ag", 1, 1, 2, {"kChains": [1]}),
    ("sw_ag", 5, 300, 2, {"kChains": [1]}),
    ("nw_lg", 129, 129, 4, {}),
    ("sw_lg", 1, 700, 3, {}),
])
def test_giant2_matches_tpu7(blosum62, spec, rows, cols, D, params):
    y, x = _seqs(rows + 3 * cols, rows, cols)
    port = run_port(blosum62, y, x, spec, align_giant2,
                    dict(TILES, **params), mesh=_cpu_mesh(D))
    assert port[0] == [0, 0, 0]
    assert_same(port, run_port_tpu7(blosum62, y, x, spec))


# The portable NW linear-gap engine against JAX's, two shapes: the JAX
# registry's own mesh (its 8 virtual CPU devices) and a mesh of 3.
GIANT1_CASES = [(300, 2100, 8), (130, 700, 3)]


@pytest.mark.parametrize("rows,cols,D", GIANT1_CASES)
def test_giant_mlsp_matches_jax(blosum62, rows, cols, D):
    y, x = _seqs(rows + cols, rows, cols)
    port = run_port(blosum62, y, x, "nw_lg", align_giant_mlsp,
                    mesh=_cpu_mesh(D))
    ref = run_jax(blosum62, y, x, "nw_lg", "tpu9_giant_mlsp",
                  align=jax_align_giant_mlsp,
                  mesh=jax_make_mesh(D, axis_name="sp"))
    assert port[0] == [0, 0, 0]
    assert (port[1].tile_hdr_mat_rows, port[1].tile_hdr_mat_cols) == (
        ref[1].tile_hdr_mat_rows, ref[1].tile_hdr_mat_cols)
    assert_same(port, ref, layout=False)
    for name in ("tileHrowMat", "tileHcolMat"):
        np.testing.assert_array_equal(getattr(port[1], name),
                                      getattr(ref[1], name), err_msg=name)


def test_giant_mlsp_rejects_other_specs(blosum62):
    y, x = _seqs(1, 40, 40)
    stats, _, _ = run_port(blosum62, y, x, "nw_ag", align_giant_mlsp,
                           mesh=_cpu_mesh(2))
    assert stats == [int(Status.errorInvalidValue)]


def test_tpu9_nw_lg_matches_jax_cpu_route(blosum62):
    """Port tpu9_giant_mlsp (the banded engine) against the JAX registry's
    CPU route of the same name (its portable engine on 8 virtual devices):
    the layouts differ, the answers may not."""
    rows, cols, _ = GIANT1_CASES[0]
    y, x = _seqs(rows + cols, rows, cols)
    port = run_port(blosum62, y, x, "nw_lg",
                    get_algorithm_map()["tpu9_giant_mlsp"].align,
                    mesh=_cpu_mesh(2))
    ref = run_jax(blosum62, y, x, "nw_lg", "tpu9_giant_mlsp")
    assert port[0] == [0, 0, 0]
    assert_same(port, ref, layout=False)


@pytest.mark.parametrize("spec", SPECS)
def test_banded_pass_plain_assembles_the_matrix(blosum62, spec):
    """Bands assembled by hand, pass by pass, each from its neighbours'
    outputs, equal mlsp_fill_plain on the whole matrix."""
    kind, gap = spec.split("_")
    kw = dict(kind=kind, gap="affine" if gap == "ag" else "linear")
    affine = kw["gap"] == "affine"
    th, tw, bc, nb, D = 4, 8, 16, 2, 3  # 3 passes of 2 blocks, 3 bands
    rows_p, cols_p = 3 * nb * th, D * bc
    adjr, adjc = rows_p - 2, cols_p - 5
    y, x = _seqs(11, rows_p, cols_p, letters=blosum62.shape[0])
    y[adjr:], x[adjc:] = 0, 0
    subst = torch.from_numpy(blosum62)
    yt, xt = torch.from_numpy(y), torch.from_numpy(x)
    g, ge = GAPO, _gape(spec)
    whole = mlsp_fill_plain(subst, yt, xt, g, ge, adjr, adjc, tile_h=th,
                            tile_w=tw, **kw)
    jtE = bc // tw
    best = []
    for k in range(D):
        c0 = k * bc
        for p in range(3):
            r0, b0 = p * nb * th, p * nb
            col = c0 // tw
            haloH = torch.cat([whole["hrows"][b0, c0:c0 + 1],
                               whole["hcols"][b0:b0 + nb, :, col].reshape(-1)])
            got = banded_pass_plain(
                subst, yt[r0:r0 + nb * th + 1], xt[c0:c0 + bc + 1], g, ge,
                whole["hrows"][b0, c0:c0 + bc + 1],
                whole["frows"][b0, c0:c0 + bc + 1] if affine else None,
                haloH,
                whole["ecols"][b0:b0 + nb, :, col].reshape(-1)
                if affine else None,
                adjr - r0, adjc - c0, tile_h=th, tile_w=tw, **kw)
            last_band = k == D - 1
            n_rows = nb + (0 if p == 2 else 1)
            n_cols = jtE + (0 if last_band else 1)
            assert torch.equal(got["hrows"][:n_rows],
                               whole["hrows"][b0:b0 + n_rows, c0:c0 + bc + 1])
            assert torch.equal(got["hcols"][:, :, :n_cols],
                               whole["hcols"][b0:b0 + nb, :, col:col + n_cols])
            if affine:
                assert torch.equal(
                    got["frows"][1:n_rows, 1:],
                    whole["frows"][b0 + 1:b0 + n_rows, c0 + 1:c0 + bc + 1])
                assert torch.equal(
                    got["ecols"][:, :, 1:n_cols],
                    whole["ecols"][b0:b0 + nb, :, col + 1:col + n_cols])
            if kind == "sw":
                v, i, j = got["best"].tolist()
                assert v == 0 or (1 <= i <= nb * th and 1 <= j <= bc)
                best.append((-v, i + r0, j + c0) if v > 0 else (0, 0, 0))
    if kind == "sw":
        v, i, j = min(best)
        assert [-v, i, j] == whole["best"].tolist()


@pytest.mark.parametrize("K", [1, 2, 4])
def test_geometry_helpers_match_jax(K):
    for R in (128, 256, 2048):
        for W in (128, 512):
            for bc in (128, 256, 640, 8192, 100096):
                kw = dict(R=R, W=W, K=K, band_cols=bc)
                assert giant2.wrap_ok(**kw) == jax_wavefront2.wrap_ok(**kw)
                for D in (1, 2, 4, 8):
                    for nb in (1, 2, 3, 8, 64, 782, [8] * 4, [3, 5, 9]):
                        assert giant2.pick_kb(
                            nb, K, D, R=R, W=W, band_cols=bc) == \
                            jax_giant2.pick_kb(nb, K, D, R=R, W=W,
                                               band_cols=bc)
    for R in (0, 64, 128, 192, 256):
        for TW in (32, 128, 384):
            assert giant2._tile_params_ok(R, TW, K) == \
                jax_giant2._tile_params_ok(R, TW, K)


@pytest.mark.parametrize("spec,rows,cols,gapo,gape,params", [
    ("nw_ag", 50, 60, 1, -2, {}),            # affine with a positive cost
    ("sw_ag", 50, 60, -11, 2, {}),
    ("nw_lg", 50, 60, -11, 0, {"tileBy": [64]}),   # tiles not of 128
    ("nw_lg", 50, 60, -11, 0, {"tileBx": [32]}),
    ("sw_lg", 50, 60, -11, 0, {"tileBy": [192], "tileBx": [100]}),
    ("nw_lg", 300, 500, -11, 0, {"kChains": [2], "passBlocks": [2]}),
])
def test_invalid_params_match_jax_status(blosum62, spec, rows, cols, gapo,
                                         gape, params):
    """The Status contracts, held against the JAX engine itself (each
    returns before any compile): the same parameters, the same Status."""
    y, x = _seqs(rows, rows, cols)
    nw = make_alg_input(blosum62, y, x, gapo, gape, spec, device="cpu")
    mesh = _cpu_mesh(2)
    stat = align_giant2(AlgParams(dict(TILES, **params)), nw, AlgResult(),
                        mesh=mesh)
    stream = align_giant2_stream(AlgParams(dict(TILES, **params)), [nw, nw],
                                 [AlgResult(), AlgResult()], mesh=mesh)
    jnw = jax_types.AlgInput()
    jnw.subst, jnw.substsz = blosum62, blosum62.shape[0]
    jnw.seqY, jnw.seqX, jnw.adjrows, jnw.adjcols = y, x, len(y), len(x)
    jnw.gapo_cost, jnw.gape_cost = gapo, gape
    jnw.spec = jax_types.AlignSpec.from_name(spec)
    want = jax_giant2.align_giant2(
        jax_types.AlgParams(dict(TILES, **params)), jnw,
        jax_types.AlgResult(), mesh=jax_make_mesh(2, axis_name="sp"),
        interpret=True)
    assert int(stat) == int(want) == int(Status.errorInvalidValue)
    assert stream == [Status.errorInvalidValue] * 2


def test_stream_mixed_costs_rejected(blosum62):
    ya, xa = _seqs(1, 60, 60)
    a = make_alg_input(blosum62, ya, xa, -11, 0, "nw_lg", device="cpu")
    b = make_alg_input(blosum62, ya, xa, -4, 0, "nw_lg", device="cpu")
    c = make_alg_input(blosum62, ya, xa, -11, 0, "sw_lg", device="cpu")
    mesh = _cpu_mesh(2)
    for other in (b, c):
        assert align_giant2_stream(AlgParams({}), [a, other],
                                   [AlgResult(), AlgResult()], mesh=mesh) \
            == [Status.errorInvalidValue] * 2
    other_subst = blosum62.copy()
    other_subst[0, 0] += 1
    d = make_alg_input(other_subst, ya, xa, -11, 0, "nw_lg", device="cpu")
    assert align_giant2_stream(AlgParams({}), [a, d],
                               [AlgResult(), AlgResult()], mesh=mesh) \
        == [Status.errorInvalidValue] * 2
    assert align_giant2_stream(AlgParams({}), [], [], mesh=mesh) == []


@pytest.mark.parametrize("kind", ["sw"])
def test_sw_band_clamp(kind):
    """SW best never reaches past a band's own columns: the TPU kernel's
    regression (a band left of the pair's last column, all-0 row letters,
    band letters never 0, so every true cell scores <= 0; junk cells
    past the band would score 1200). The port computes no cell past the
    band, and adjc_loc past it is clamped to the band's 1 + band_cols."""
    subst = np.full((8, 8), -3, np.int32)
    np.fill_diagonal(subst, 10)
    R = TW = bc = 128
    rng = np.random.default_rng(7)
    y = torch.zeros(1 + R, dtype=torch.int32)
    x = torch.from_numpy(np.concatenate(
        [[0], rng.integers(1, 8, bc)]).astype(np.int32))
    args = (torch.from_numpy(subst), y, x, -4, 0,
            torch.zeros(bc + 1, dtype=torch.int32), None,
            torch.zeros(R + 1, dtype=torch.int32), None, 121)
    kw = dict(tile_h=R, tile_w=TW, kind=kind, gap="linear")
    past = banded_cuda.banded_pass(*args, 300, **kw)
    edge = banded_pass_plain(*args, bc + 1, **kw)
    assert past["best"].tolist() == [0, 0, 0]
    for k in edge:
        assert torch.equal(past[k], edge[k]), k


@pytest.mark.parametrize("spec", SPECS)
def test_stream_matches_single(blosum62, spec):
    """Three unequal pairs through one stream on two bands (pair-local
    passes 2/1/3, the middle pair narrower than the band) equal each
    pair through align_giant2 alone."""
    sizes = [(300, 500), (90, 150), (600, 400)]
    mesh = _cpu_mesh(2)
    inputs, singles = [], []
    for k, (r, c) in enumerate(sizes):
        y, x = _seqs(100 + k, r, c)
        inputs.append(make_alg_input(blosum62, y, x, GAPO, _gape(spec), spec,
                                     device="cpu"))
        singles.append(run_port(blosum62, y, x, spec, align_giant2, TILES,
                                mesh=mesh))
    results = [AlgResult() for _ in inputs]
    stats = align_giant2_stream(AlgParams(TILES), inputs, results, mesh=mesh)
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    for nw, res, stat, single in zip(inputs, results, stats, singles):
        assert_same(_finish(alg, nw, res, stat), single)


def _batch_pairs(seed):
    sizes = [(1100, 300), (1030, 200), (300, 200), (1, 50), (200, 1),
             (250, 260), (40, 30), (1, 1), (90, 500)]
    return [_seqs(seed + k, r, c) for k, (r, c) in enumerate(sizes)]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("D", [2, 3])
def test_batch_mesh_matches_one_device(blosum62, spec, D):
    pairs = _batch_pairs(40)
    aspec = AlignSpec.from_name(spec)
    one = align_pairs_batched(aspec, blosum62, pairs, GAPO, _gape(spec),
                              device="cpu")
    mesh = make_mesh(devices=["cpu"] * D)
    got = align_pairs_batched(aspec, blosum62, pairs, GAPO, _gape(spec),
                              mesh=mesh)
    for name in ("costs", "best_i", "best_j"):
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name))
    with pytest.raises(ValueError, match="mesh or a device"):
        align_pairs_batched(aspec, blosum62, pairs, GAPO, _gape(spec),
                            device="cpu", mesh=mesh)


def test_mesh():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"], axis_name="sp")
    assert mesh.size == 3 and mesh.axis_name == "sp"
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    assert make_mesh(devices=["cpu"]).axis_name == "pairs"
    with pytest.raises(ValueError):
        make_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    distributed_init(num_processes=1)  # one process alone: a no-op
    assert not torch.distributed.is_initialized()


def test_default_mesh_is_the_input_device():
    """With no mesh, the giant engines run one band on the input's own
    device, whatever the number of cards."""
    assert default_mesh("cpu") == Mesh((torch.device("cpu"),), "sp")
    assert default_mesh(torch.device("cpu")).size == 1
    synchronize_mesh(_cpu_mesh(2))  # the CPU has nothing queued
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            default_mesh(None)


@pytest.mark.parametrize("flag,devices,mode", [
    ("--giantStream", 1, "giant sequential"),
    ("--giantStream", 2, "giant stream"),
    ("--giantSequential", 2, "giant sequential"),
])
def test_throughput_giant_modes_on_cpu(tmp_path, flag, devices, mode):
    """--giantStream takes the stream only over D > 1 bands (with one
    band it would pad every pair to the widest for no pipeline to fill);
    every mode agrees with the oracle on the pairs it checks."""
    out = tmp_path / "giant.json"
    rc = throughput.main([
        "--seqPath", os.path.join(REPO, "resrc", "seq_generated.fa"),
        "--substPath", os.path.join(REPO, "resrc", "subst.json"),
        "--synthPairs", "4,100,300", "--algKind", "sw_ag", "--repeat", "1",
        "--verify", "2", "--devices", str(devices), "--jsonPath", str(out),
        flag], device="cpu")
    assert rc == 0
    res = json.loads(out.read_text())
    assert (res["mode"], res["bands"], res["pairs"]) == (mode, devices, 4)
    assert res["verify_mismatches"] == 0


def test_multihost_single_process_falls_through(blosum62):
    pairs = _batch_pairs(60)
    aspec = AlignSpec.from_name("sw_ag")
    want = align_pairs_batched(aspec, blosum62, pairs, GAPO, GAPE,
                               device="cpu")
    got = align_pairs_multihost(aspec, blosum62, pairs, GAPO, GAPE,
                                device="cpu")
    for name in ("costs", "best_i", "best_j"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


_MULTIHOST_WORKER = """
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.io.subst import parse_subst_file
from gpuseqalign_tpu_torch.parallel import (
    align_pairs_multihost, distributed_init)
rank = int(sys.argv[1])
distributed_init("localhost:{port}", 2, rank)
subst = parse_subst_file({subst!r}).subst_map["blosum62"]
rng = np.random.default_rng(5)
pairs = [(np.concatenate([[0], rng.integers(0, 25, r)]).astype(np.int32),
          np.concatenate([[0], rng.integers(0, 25, c)]).astype(np.int32))
         for r, c in [(120, 90), (1, 40), (300, 260), (50, 50), (7, 1)]]
out = align_pairs_multihost(AlignSpec.from_name("sw_ag"), subst, pairs,
                            -11, -2, device="cpu")
print(json.dumps([out.costs.tolist(), out.best_i.tolist(),
                  out.best_j.tolist()]))
import torch.distributed
torch.distributed.destroy_process_group()
"""


def test_multihost_two_processes(blosum62, tmp_path):
    """Two gloo processes share the pairs round-robin; both return every
    pair's result, equal to one process alone."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_MULTIHOST_WORKER.format(
        repo=REPO, port=port,
        subst=os.path.join(REPO, "resrc", "subst.json")))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(tmp_path))
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            p.kill()
    rng = np.random.default_rng(5)
    pairs = [(np.concatenate([[0], rng.integers(0, 25, r)]).astype(np.int32),
              np.concatenate([[0], rng.integers(0, 25, c)]).astype(np.int32))
             for r, c in [(120, 90), (1, 40), (300, 260), (50, 50), (7, 1)]]
    want = align_pairs_batched(AlignSpec.from_name("sw_ag"), blosum62, pairs,
                               GAPO, GAPE, device="cpu")
    expect = [want.costs.tolist(), want.best_i.tolist(), want.best_j.tolist()]
    assert [json.loads(o) for o in outs] == [expect, expect]


def _store_loop(nw, hrows, hcols, th, tw, trows, tcols, frows=None,
                ecols=None):
    """The per-tile loop the store ran before its strided form."""
    n_tiles = trows * tcols
    mats = {"tileHrowMat": np.zeros((n_tiles, 1 + tw), np.int32),
            "tileHcolMat": np.zeros((n_tiles, 1 + th), np.int32)}
    if frows is not None:
        mats["tileFrowMat"] = np.zeros((n_tiles, 1 + tw), np.int32)
        mats["tileEcolMat"] = np.zeros((n_tiles, 1 + th), np.int32)
    for it in range(trows):
        row = hrows[it]
        for jt in range(tcols):
            k = it * tcols + jt
            mats["tileHrowMat"][k] = row[jt * tw: jt * tw + tw + 1]
            mats["tileHcolMat"][k, 0] = row[jt * tw]
            mats["tileHcolMat"][k, 1:] = hcols[it, :, jt]
            if frows is not None:
                mats["tileFrowMat"][k] = frows[it][jt * tw: jt * tw + tw + 1]
                mats["tileEcolMat"][k, 1:] = ecols[it, :, jt]
    if frows is not None:
        mats["tileEcolMat"][:, 0] = -(2 ** 30)
    return mats


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("th,tw,trows,tcols,extra", [
    (4, 8, 3, 5, 0), (1, 1, 7, 9, 0), (16, 3, 2, 1, 4), (5, 2, 1, 6, 3)])
def test_mlsp_store_matches_the_loop(blosum62, affine, th, tw, trows, tcols,
                                     extra):
    """tile_headers and _mlsp_store against their former per-tile loop on
    random headers (rows wider than the tiles, by ``extra``, as the giant
    layout may give)."""
    rng = np.random.default_rng(th * 100 + tw)
    width = 1 + tcols * tw + extra
    hrows = rng.integers(-999, 999, (trows, width)).astype(np.int32)
    hcols = rng.integers(-999, 999, (trows, th, tcols)).astype(np.int32)
    frows = ecols = None
    if affine:
        frows = rng.integers(-999, 999, (trows, width)).astype(np.int32)
        ecols = rng.integers(-999, 999, (trows, th, tcols)).astype(np.int32)
    y, x = _seqs(3, trows * th, tcols * tw)
    nw = make_alg_input(blosum62, y, x, GAPO, GAPE if affine else 0,
                        "sw_ag" if affine else "sw_lg", device="cpu")
    res = AlgResult()
    best = np.array([5, 1, 1], np.int32)
    mats = tile_headers(hrows, hcols, th, tw, trows, tcols, frows=frows,
                        ecols=ecols, best=best)
    assert _mlsp_store(nw, res, mats, th, tw, trows, tcols) == Status.success
    want = _store_loop(nw, hrows, hcols, th, tw, trows, tcols, frows, ecols)
    for name in MATS:
        got = getattr(nw, name)
        if name not in want:
            assert got is None
            continue
        assert got.dtype == np.int32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_banded_pass_checks_its_inputs(blosum62):
    subst = torch.from_numpy(blosum62)
    y = torch.zeros(1 + 8, dtype=torch.int32)
    x = torch.zeros(1 + 16, dtype=torch.int32)
    row = torch.zeros(17, dtype=torch.int32)
    col = torch.zeros(9, dtype=torch.int32)
    kw = dict(tile_h=4, tile_w=8, kind="nw", gap="linear")
    banded_cuda.banded_pass(subst, y, x, -11, 0, row, None, col, None, 9,
                            17, **kw)
    with pytest.raises(ValueError):
        banded_cuda.banded_pass(subst, y, x, -11, 0, row[:-1], None, col,
                                None, 9, 17, **kw)
    with pytest.raises(ValueError):
        banded_cuda.banded_pass(subst, y[:-1], x, -11, 0, row, None, col,
                                None, 9, 17, **kw)
    with pytest.raises(TypeError):
        banded_cuda.banded_pass(subst, y.long(), x, -11, 0, row, None, col,
                                None, 9, 17, **kw)
    with pytest.raises(ValueError, match="affine"):
        banded_cuda.banded_pass(subst, y, x, -11, -2, row, None, col, None,
                                9, 17, tile_h=4, tile_w=8, kind="nw",
                                gap="affine")
