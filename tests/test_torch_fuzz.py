"""The port's differential fuzzer (``bench/fuzz.py``) on the CPU.

Its inputs are the JAX fuzz's, field for field; its results through the
CPU route equal the JAX package's; a seeded run passes; a planted wrong
cost makes it fail with a repro line; and its own draws reach what the
card needs reached: tile sides of 1-3 for K1, and batch buckets that
``fill_route`` sends to K5 and to K6 on a card of 132 SMs. No Pallas
interpret mode.
"""

import dataclasses
import re

import numpy as np
import pytest

from gpuseqalign_tpu.bench import fuzz as jax_fuzz
from gpuseqalign_tpu.core import registry as jax_registry

from gpuseqalign_tpu_torch.bench import fuzz
from gpuseqalign_tpu_torch.core import registry

JAX_FIELDS = ("subst", "substsz", "spec", "gapo", "gape", "y", "x",
              "tileBy", "tileBx", "blocksz", "giantBy", "giantBx", "giantK",
              "giantFlags", "v2Flags")
SUMMARY = re.compile(r"(\d+) cases, (\d+) failures")


def test_ladders_are_the_jax_fuzzs():
    assert fuzz.SIZES == jax_fuzz.SIZES
    assert fuzz.TILES == jax_fuzz.TILES
    assert fuzz.SPECS == jax_fuzz.SPECS
    assert fuzz.DEFAULT_ALGS == jax_fuzz.DEFAULT_ALGS


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_gen_case_draws_the_jax_inputs(seed):
    for case in range(50):
        got, want = fuzz._gen_case(seed, case), jax_fuzz._gen_case(seed, case)
        assert set(want) == set(JAX_FIELDS)
        for k in JAX_FIELDS:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k], (seed, case, k)


# Small cases (at most 55 x 55, every spec, tpu7 tiles 1x3, 48x5 and
# 512x16), so the JAX CPU route compiles quickly.
RUN_CASES = [(0, 6), (1, 9), (12345, 10), (0, 12)]


@pytest.mark.parametrize("alg_name", ["cpu1_st_row", "tpu2_xla_rowscan",
                                      "tpu7_pallas_mlsp"])
@pytest.mark.parametrize("seed,case", RUN_CASES)
def test_run_alg_matches_jax(alg_name, seed, case):
    c = fuzz._gen_case(seed, case)
    assert max(len(c["y"]), len(c["x"])) <= 56
    got = fuzz._run_alg(registry.get_algorithm_map()[alg_name], alg_name, c,
                        "cpu")
    want = jax_fuzz._run_alg(jax_registry.get_algorithm_map()[alg_name],
                             alg_name, jax_fuzz._gen_case(seed, case))
    assert isinstance(got, tuple) and got == want


def test_seeded_run_passes(capsys):
    rc = fuzz.main(["--cases", "6", "--seconds", "0", "--seed", "12345"],
                   device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert "6 cases, 0 failures" in out
    assert "FAIL" not in out


def test_giant_cases_pass_on_one_and_two_bands(capsys):
    common = ["--cases", "3", "--seconds", "0", "--seed", "7",
              "--algs", "cpu1_st_row,tpu7_pallas_mlsp", "--includeGiant",
              "--batchEvery", "0"]
    assert fuzz.main(common, device="cpu") == 0
    assert fuzz.main(common + ["--devices", "2"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("3 cases, 0 failures") == 2


def test_planted_wrong_cost_fails_with_a_repro_line(capsys, monkeypatch):
    real = registry.get_algorithm_map

    def planted():
        algs = real()
        good = algs["tpu7_pallas_mlsp"]

        def align(pr, nw, res):
            stat = good.align(pr, nw, res)
            res.align_cost += 1
            return stat

        algs["tpu7_pallas_mlsp"] = dataclasses.replace(good, align=align)
        return algs

    monkeypatch.setattr(registry, "get_algorithm_map", planted)
    rc = fuzz.main(["--cases", "2", "--seconds", "0", "--seed", "3",
                    "--algs", "cpu1_st_row,tpu7_pallas_mlsp",
                    "--batchEvery", "0"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1
    fails = [ln for ln in out.splitlines() if ln.startswith("FAIL")]
    assert len(fails) == 2
    c = fuzz._gen_case(3, 0)
    assert fails[0].startswith(
        f"FAIL seed=3 case=0 alg=tpu7_pallas_mlsp {c['spec']} "
        f"{len(c['y']) - 1}x{len(c['x']) - 1} ")
    assert f"tiles={fuzz._tiles('tpu7_pallas_mlsp', c)}" in fails[0]
    assert "field=cost" in fails[0]
    assert SUMMARY.search(out).groups() == ("2", "2")


def test_planted_wrong_batch_cost_fails(capsys, monkeypatch):
    from gpuseqalign_tpu_torch.parallel import batch

    real = batch.align_pairs_batched

    def planted(*args, **kw):
        out = real(*args, **kw)
        out.costs[0] += 1
        return out

    monkeypatch.setattr(batch, "align_pairs_batched", planted)
    rc = fuzz.main(["--cases", "1", "--seconds", "0", "--seed", "0",
                    "--algs", "cpu1_st_row"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1
    assert re.search(r"^FAIL seed=0 case=0 alg=batch \w+ pair 0 .*"
                     r"field=cost", out, re.M)


def test_draws_reach_both_batch_routes_and_small_tiles():
    routes, sides, quanta, wide = set(), set(), set(), 0
    for case in range(200):
        c = fuzz._gen_case(0, case)
        sides |= set(c["tpu7Tiles"])
        bc = fuzz._gen_batch_case(0, case, 132)
        routes |= set(fuzz.batch_routes(bc, 132))
        quanta.add(bc["quantum"])
        if bc["wide"]:
            wide += 1
            assert 264 <= len(bc["pairs"]) <= 396
            assert fuzz.batch_routes(bc, 132) == ["tiny"]
            assert max(max(len(y), len(x)) for y, x in bc["pairs"]) <= 378
        else:
            assert 1 <= len(bc["pairs"]) <= 8
    assert routes == {"tiny", "fill"}
    assert {1, 2, 3} <= sides
    assert set(fuzz.ODD_QUANTA) <= quanta and {"pow2", 64} <= quanta
    assert 20 <= wide <= 80
    # The same draws on the CPU (no SM count) route by height alone.
    assert set().union(*(fuzz.batch_routes(fuzz._gen_batch_case(0, k, 132),
                                           None)
                         for k in range(0, 40, 5))) == {"tiny"}


def test_tpu7_takes_the_wider_ladder_in_about_half_the_cases():
    """tpu7's tiles come from stream 2, the wider ladder in about half the
    cases (the JAX tile fields stay as they were: see above)."""
    wider = 0
    for case in range(200):
        c = fuzz._gen_case(5, case)
        if c["tpu7Tiles"] != (c["tileBy"], c["tileBx"]):
            wider += 1
            assert set(c["tpu7Tiles"]) <= set(fuzz.TPU7_TILES)
    assert 60 <= wider <= 140
