"""The port's autotuner (``bench/autotune.py``) and the card's tuned cache
(``ops/tuned.py``) on the CPU.

``tune`` gives the JAX ``tune``'s output shape; ``tune_v2`` and
``tune_banded`` gate every tile on the oracle; ``save_defaults`` merges
into the cache without losing the ``banded`` sub-entry; and the cache is
read on a CUDA device only, so every CPU run keeps its literal tiles. The
cache's name is that of the card, so these tests stand one in
(``tuned.cache_name``) and write under ``tmp_path``. No Pallas interpret
mode.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.bench.autotune import tune as jax_tune
from gpuseqalign_tpu.core.types import AlignSpec as JaxAlignSpec

from gpuseqalign_tpu_torch.bench import autotune
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    AlignSpec,
    make_alg_input,
)
from gpuseqalign_tpu_torch.models.cpu_algs import align_cpu1_st_row
from gpuseqalign_tpu_torch.ops import mlsp_cuda, tuned
from gpuseqalign_tpu_torch.ops.mlsp_kernels import _mlsp_setup
from gpuseqalign_tpu_torch.parallel import giant2

from conftest import RESRC, random_seq

CARD = "test_card"
ENTRY = {"tileBy": 256, "tileBx": 1024, "_gcups": 99.5}
BANDED = {"tileBy": 256, "tileBx": 512, "_at_rows": 100000, "_gcups": 77.25}


@pytest.fixture
def card_cache(tmp_path, monkeypatch):
    """The cache of a stand-in card under tmp_path, read by default."""
    monkeypatch.setattr(tuned, "cache_name", lambda device: CARD)
    monkeypatch.setattr(tuned, "ROOT", str(tmp_path))
    return tmp_path


def _write(root, data):
    with open(os.path.join(root, f"{CARD}.json"), "w") as f:
        json.dump(data, f)


def test_tune_has_the_jax_tunes_shape(blosum62, rng):
    y = random_seq(rng, 300)
    x = random_seq(rng, 400)
    grids = {
        "cpu1_st_row": {},
        "tpu7_pallas_mlsp": {"tileBy": [128, 256], "tileBx": [128, 256]},
    }
    got = autotune.tune(grids, blosum62, y, x, -11, samples=1, device="cpu")
    want = jax_tune(grids, blosum62, y, x, -11, samples=1,
                    spec=JaxAlignSpec())
    assert list(got) == list(want) == list(grids)
    for name in grids:
        assert list(got[name]) == list(want[name])
        for k, v in got[name].items():
            assert isinstance(v, list) and len(v) == 1
            assert isinstance(v[0], type(want[name][k][0]))
    combo = got["tpu7_pallas_mlsp"]
    assert combo["tileBy"][0] in (128, 256)
    assert combo["tileBx"][0] in (128, 256)
    assert combo["_gcups"][0] > 0


def test_tune_skips_a_combination_that_disagrees(blosum62, rng,
                                                 monkeypatch):
    y, x = random_seq(rng, 200), random_seq(rng, 150)
    real = mlsp_cuda.mlsp_fill

    def wrong_at_128(*args, **kw):
        out = real(*args, **kw)
        if kw["tile_h"] == 128:
            out["best"][0] += 1
        return out

    monkeypatch.setattr(mlsp_cuda, "mlsp_fill", wrong_at_128)
    got = autotune.tune(
        {"cpu1_st_row": {},
         "tpu7_pallas_mlsp": {"tileBy": [64, 128], "tileBx": [64]}},
        blosum62, y, x, -11, spec=AlignSpec.from_name("sw_lg"), samples=1,
        device="cpu")
    assert got["tpu7_pallas_mlsp"]["tileBy"] == [64]


def _plant_wrong_cost(out):
    """Outputs of a fill one off the right cost: SW's best, or NW's every
    header below the edge row (the host's recompute of the last tile, two
    tile rows down or more, then reads a boundary one higher)."""
    if "best" in out:
        out["best"][0] += 1
    else:
        out["hrows"][1:] += 1
        out["hcols"][1:] += 1


@pytest.mark.parametrize("spec", ["nw_lg", "sw_ag"])
def test_tune_v2_gates_every_tile(blosum62, rng, monkeypatch, spec):
    seq = random_seq(rng, 300)
    sp = AlignSpec.from_name(spec)
    gape = -2 if spec.endswith("ag") else 0
    grid = {"tileBy": [32, 128], "tileBx": [64, 128]}
    best = autotune.tune_v2(blosum62, seq, sp, -11, gape, grid=grid,
                            m_iters=1, device="cpu")
    assert set(best) == {"tileBy", "tileBx", "_gcups"}
    assert best["tileBy"] in (32, 128) and best["tileBx"] in (64, 128)

    real = mlsp_cuda.mlsp_fill
    seen = []

    def wrong_but_32(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw["tile_h"], args[1].numel() - 1))
        if kw["tile_h"] != 32:
            _plant_wrong_cost(out)
        return out

    monkeypatch.setattr(mlsp_cuda, "mlsp_fill", wrong_but_32)
    best = autotune.tune_v2(blosum62, seq, sp, -11, gape, grid=grid,
                            m_iters=1, device="cpu")
    assert best["tileBy"] == 32
    # Each gate problem is two strips and two tile rows tall (strips of 32
    # rows for tiles of 32, 128 for 128).
    assert (32, 64) in seen and (128, 256) in seen


def test_tune_v2_raises_when_no_tile_passes(blosum62, rng, monkeypatch):
    real = mlsp_cuda.mlsp_fill

    def wrong(*args, **kw):
        out = real(*args, **kw)
        out["best"][0] += 1
        return out

    monkeypatch.setattr(mlsp_cuda, "mlsp_fill", wrong)
    with pytest.raises(RuntimeError, match="no tile passed"):
        autotune.tune_v2(blosum62, random_seq(rng, 100),
                         AlignSpec.from_name("sw_lg"), -11, 0,
                         grid={"tileBy": [32], "tileBx": [32]}, m_iters=1,
                         device="cpu")


def test_tune_banded_gives_the_banded_entry(blosum62, rng, monkeypatch):
    seq = random_seq(rng, 300)
    sp = AlignSpec.from_name("nw_ag")
    grid = {"tileBy": [128, 256], "tileBx": [128]}
    best = autotune.tune_banded(blosum62, seq, sp, -11, -2, grid=grid,
                                m_iters=1, device="cpu")
    assert set(best) == {"tileBy", "tileBx", "_at_rows", "_gcups"}
    assert best["_at_rows"] == 300 and best["tileBy"] in (128, 256)

    from gpuseqalign_tpu_torch.ops import banded_cuda

    real = banded_cuda.banded_pass

    def wrong_at_256(*args, **kw):
        out = real(*args, **kw)
        if kw["tile_h"] == 256:
            out["hrows"][1:, 1:] += 1
            out["hcols"][1:] += 1
        return out

    monkeypatch.setattr(banded_cuda, "banded_pass", wrong_at_256)
    best = autotune.tune_banded(blosum62, seq, sp, -11, -2, grid=grid,
                                m_iters=1, device="cpu")
    assert best["tileBy"] == 128


def test_save_defaults_round_trips_and_keeps_banded(card_cache):
    path = autotune.save_defaults({"banded": BANDED}, "nw_ag",
                                  root=str(card_cache))
    assert path == os.path.join(str(card_cache), f"{CARD}.json")
    autotune.save_defaults(ENTRY, "nw_ag", root=str(card_cache))
    autotune.save_defaults({"tileBy": 64, "tileBx": 512, "_gcups": 1.0},
                           "sw_lg", root=str(card_cache))
    assert tuned.tuned_defaults("nw_ag", "cuda", root=str(card_cache)) == {
        **ENTRY, "banded": BANDED}
    assert tuned.tuned_defaults("sw_lg", "cuda")["tileBy"] == 64
    assert tuned.tuned_defaults("nw_lg", "cuda") == {}
    with open(path) as f:
        assert json.load(f)["nw_ag"]["banded"] == BANDED
    # A new sweep replaces the tile and still keeps the banded sub-entry.
    autotune.save_defaults({**ENTRY, "tileBy": 512}, "nw_ag")
    assert tuned.tuned_defaults("nw_ag", "cuda") == {
        **ENTRY, "tileBy": 512, "banded": BANDED}


def test_tpu_levers_are_ignored(card_cache):
    _write(card_cache, {"_flags": {"wrap_tpu_validated": True},
                        "nw_lg": {**ENTRY, "kChains": 6, "packedx": 1,
                                  "winW": 512, "subProw": 1,
                                  "banded": {**BANDED, "rematHdr": 1,
                                             "kChains": 6}}})
    assert tuned.tuned_defaults("nw_lg", "cuda") == {**ENTRY,
                                                     "banded": BANDED}


def test_the_cpu_reads_no_cache(card_cache):
    _write(card_cache, {"nw_ag": {**ENTRY, "banded": BANDED}})
    for dev in ("cpu", torch.device("cpu")):
        assert tuned.tuned_defaults("nw_ag", dev) == {}
    assert tuned.tuned_tile("nw_ag", "cpu", (128, 512)) == (128, 512)
    assert tuned.tuned_tile("nw_ag", "cuda", (128, 512)) == (256, 1024)
    assert tuned.tuned_tile("nw_ag", "cuda", (128, 128),
                            banded=True) == (256, 512)
    assert tuned.tuned_tile("sw_ag", "cuda", (128, 512)) == (128, 512)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_mlsp_setup_reads_the_cache_on_a_card_only(blosum62, card_cache,
                                                   device):
    _write(card_cache, {"nw_ag": ENTRY})
    y = np.zeros(1001, np.int32)
    nw = make_alg_input(blosum62, y, y, -11, -2, "nw_ag", device=device)
    want = (256, 1024) if device == "cuda" else (128, 512)
    assert _mlsp_setup(AlgParams({}), nw)[:2] == want
    # An explicit tile always wins.
    assert _mlsp_setup(AlgParams({"tileBy": [16], "tileBx": [48]}),
                       nw) == (16, 48, 63, 21)
    assert _mlsp_setup(AlgParams({"tileBx": [48]}), nw)[:2] == (want[0], 48)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_giant_tile_reads_banded_then_the_tile_on_a_card(card_cache,
                                                         device):
    sp = AlignSpec.from_name("sw_lg")
    dev = torch.device(device)
    _write(card_cache, {"sw_lg": {**ENTRY, "banded": BANDED}})
    on_card = device == "cuda"
    assert giant2._tile_params(AlgParams({}), sp, dev) == (
        (256, 512, 2) if on_card else (128, 128, 2))
    _write(card_cache, {"sw_lg": ENTRY})
    assert giant2._tile_params(AlgParams({}), sp, dev) == (
        (256, 1024, 2) if on_card else (128, 128, 2))
    # A tuned tile the engine cannot run leaves the literal.
    _write(card_cache, {"sw_lg": {"tileBy": 64, "tileBx": 512}})
    assert giant2._tile_params(AlgParams({}), sp, dev) == (128, 128, 2)
    _write(card_cache, {"sw_lg": ENTRY})
    assert giant2._tile_params(
        AlgParams({"tileBy": [384], "kChains": [1]}), sp, dev) == (
        384, 1024 if on_card else 128, 1)
    geo = giant2.band_geometry(AlgParams({}), [1000], [3000], 1, sp, dev)
    assert geo[:2] == ((256, 1024) if on_card else (128, 128))
    # Without a spec and device (callers outside the engine), literals.
    assert giant2.band_geometry(AlgParams({}), [1000], [3000], 1)[:2] == (
        128, 128)


def test_align_on_the_cpu_ignores_a_present_cache(blosum62, card_cache,
                                                  rng):
    """The registry's sparse and giant names on the CPU, with a cache that
    names other tiles: the layout is the literal tiles'."""
    from gpuseqalign_tpu_torch.core.registry import get_algorithm_map

    _write(card_cache, {"nw_lg": {"tileBy": 32, "tileBx": 64,
                                  "banded": {"tileBy": 256, "tileBx": 256}}})
    y, x = random_seq(rng, 300), random_seq(rng, 700)
    for name, tile in (("tpu7_pallas_mlsp", (128, 512)),
                       ("tpu9_giant_mlsp", (128, 128))):
        nw = make_alg_input(blosum62, y, x, -11, 0, "nw_lg", device="cpu")
        res = AlgResult()
        assert get_algorithm_map()[name].align(AlgParams({}), nw, res) == 0
        assert (nw.tile_hcol_len - 1, nw.tile_hrow_len - 1) == tile
        nwo = make_alg_input(blosum62, y, x, -11, 0, "nw_lg", device="cpu")
        reso = AlgResult()
        align_cpu1_st_row(AlgParams({}), nwo, reso)
        assert res.align_cost == reso.align_cost


def test_main_tune_writes_the_param_file(tmp_path, capsys):
    params = tmp_path / "grid.json"
    params.write_text(json.dumps({
        "cpu1_st_row": {},
        "tpu7_pallas_mlsp": {"tileBy": [64, 128], "tileBx": [128]}}))
    out = tmp_path / "tuned" / "params.json"
    rc = autotune.main([
        "--algParamPath", str(params),
        "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--pair", "len196", "len256", "--samples", "1",
        "--out", str(out)], device="cpu")
    assert rc == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == {"cpu1_st_row", "tpu7_pallas_mlsp"}
    assert got["tpu7_pallas_mlsp"]["tileBx"] == [128]


def test_save_defaults_needs_the_card_for_its_name(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.save_defaults(ENTRY, "nw_ag", root=str(tmp_path))
    assert not os.listdir(tmp_path)
