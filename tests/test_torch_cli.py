"""The port's nw-compatible CLI, driven on the CPU.

Every spec runs the verify pairs with ``cpu1_st_row`` as the reference
algorithm, so the benchmark's own differential check (err_step 5 on any
mismatch of cost, score hash or trace hash) holds the sparse path to the
dense oracle. For nw_lg the TSV is also compared with the JAX package's
CLI on the same inputs.
"""

import json
import os

import pytest

from gpuseqalign_tpu.bench.cli import main as jax_main
from gpuseqalign_tpu.core.registry import (
    get_algorithm_map as jax_algorithm_map,
)
from gpuseqalign_tpu_torch.bench.cli import main
from gpuseqalign_tpu_torch.core.registry import get_algorithm_map

RESRC = os.path.join(os.path.dirname(__file__), "..", "resrc")

VERIFY_PAIRS = """\
len1 len1
len31 len33
len196 len256
len512[2:] len728[:726]
len2 len1
len384 len1
"""

PARAMS = {
    "cpu1_st_row": {},
    "tpu7_pallas_mlsp": {"tileBy": [128], "tileBx": [512], "kChains": [4],
                         "winW": [512], "noBc": [1]},
    "NwAlign_Gpu8_Mlsp_DiagDiag": {"threadsPerBlockA": [160],
                                   "tileBx": [76]},
    "NwAlign_Gpu7_Mlsp_DiagDiag": {"tileBy": [96], "tileBx": [40]},
}


def _read_tsv(path):
    with open(path) as f:
        lines = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return [dict(zip(lines[0], row)) for row in lines[1:]]


def _run(run_main, tmp_path, spec, params=PARAMS, extra=(), **kw):
    param_file = tmp_path / "params.json"
    param_file.write_text(json.dumps(params))
    pair_file = tmp_path / "pairs.txt"
    pair_file.write_text(VERIFY_PAIRS)
    res = tmp_path / "out.tsv"
    argv = [
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--algParamPath", str(param_file),
        "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
        "--seqPairPath", str(pair_file),
        "--resPath", str(res),
        "--fCalcScoreHash", "--fCalcTrace", "--algKind", spec,
        *(["--gapeCost", "-2"] if spec.endswith("ag") else []),
        *extra,
    ]
    rc = run_main(argv, **kw)
    return rc, (_read_tsv(res) if res.exists() else [])


@pytest.mark.parametrize("spec", ["nw_lg", "nw_ag", "sw_lg", "sw_ag"])
def test_cli_all_specs_agree_with_reference(tmp_path, spec):
    rc, rows = _run(main, tmp_path, spec, device="cpu")
    assert rc == 0
    assert len(rows) == len(PARAMS) * len(VERIFY_PAIRS.splitlines())
    assert all(r["err_step"] == "0" for r in rows), [
        (r["alg_name"], r["seqY_id"], r["seqX_id"], r["err_step"])
        for r in rows if r["err_step"] != "0"
    ]


def test_cli_nw_lg_matches_jax_cli(tmp_path):
    params = {k: PARAMS[k] for k in ("cpu1_st_row", "tpu7_pallas_mlsp")}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    rc, port_rows = _run(main, tmp_path / "port", "nw_lg", params,
                         device="cpu")
    assert rc == 0
    rc, jax_rows = _run(jax_main, tmp_path / "jax", "nw_lg", params)
    assert rc == 0
    cols = ("alg_name", "seqY_id", "seqX_id", "err_step", "align_cost",
            "score_hash", "trace_hash")
    assert [tuple(r[c] for c in cols) for r in port_rows] == [
        tuple(r[c] for c in cols) for r in jax_rows
    ]


@pytest.mark.parametrize("name", ["tpu9_giant_mlsp"])
def test_cli_rejects_unported_algorithms(tmp_path, capsys, name):
    """Every name of the JAX package is ported now, the giant engine
    last: it runs beside the reference, and a name that neither package
    has is still rejected."""
    (tmp_path / "ported").mkdir()
    rc, rows = _run(main, tmp_path / "ported", "nw_lg",
                    {"cpu1_st_row": {}, name: {}}, device="cpu")
    assert rc == 0
    assert {r["alg_name"] for r in rows} == {"cpu1_st_row", name}
    assert all(r["err_step"] == "0" for r in rows)
    assert name in jax_algorithm_map()
    unknown = name + "_unknown"
    assert unknown not in jax_algorithm_map()
    rc, _ = _run(main, tmp_path, "nw_lg", {unknown: {}}, device="cpu")
    assert rc == -1
    assert "unknown algorithm" in capsys.readouterr().err


@pytest.mark.parametrize("name", [
    "tpu1_xla_diag", "tpu2_xla_rowscan", "tpu3_pallas_dense",
    "NwAlign_Gpu1_Ml_Diag", "NwAlign_Gpu6_Coop_DiagDiag2Pass",
])
def test_cli_dense_algorithms_agree_with_reference(tmp_path, name):
    params = {"cpu1_st_row": {}, name: {}}
    rc, rows = _run(main, tmp_path, "nw_lg", params, device="cpu")
    assert rc == 0
    assert [r["alg_name"] for r in rows] == [
        n for n in params for _ in VERIFY_PAIRS.splitlines()]
    assert all(r["err_step"] == "0" for r in rows)


def test_cli_loads_param_best_whole(tmp_path):
    """The reference's own parameter file, all 13 names, on a few small
    pairs; the port's names are the JAX package's, in its order."""
    best = os.path.join(RESRC, "param_best.json")
    pair_file = tmp_path / "pairs.txt"
    pair_file.write_text("len1 len1\nlen31 len33\nlen2 len128\n")
    res = tmp_path / "out.tsv"
    rc = main([
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--algParamPath", best,
        "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
        "--seqPairPath", str(pair_file), "--resPath", str(res),
        "--fCalcScoreHash", "--fCalcTrace",
    ], device="cpu")
    assert rc == 0
    rows = _read_tsv(res)
    assert len({r["alg_name"] for r in rows}) == 13
    assert len(rows) == 13 * 3
    assert all(r["err_step"] == "0" for r in rows)
    assert list(get_algorithm_map()) == list(jax_algorithm_map())


def test_cli_profile_dir_writes_trace(tmp_path):
    params = {"tpu7_pallas_mlsp": {"tileBy": [64], "tileBx": [64]}}
    prof = tmp_path / "prof"
    rc, rows = _run(main, tmp_path, "nw_lg", params,
                    extra=("--profileDir", str(prof)), device="cpu")
    assert rc == 0 and rows
    assert (prof / "trace.json").stat().st_size > 0
