"""A cell, a configuration and metrics added as new files and new entries
of BENCHMARK.json alone: the harness finds and runs them, and no file
that was there before changes."""

import hashlib
import json
import os
import pathlib
import shutil

from benchmark import harness
from conftest import ROOT, make_tiny_root, tiny_name


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(pathlib.Path(root, "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(root):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return _digests(root)


def test_a_cell_added_as_new_files(tmp_path):
    before = _copy(tmp_path)
    bench_dir = tmp_path / "benchmark"

    # A new deployment: NW with an affine gap, another file.
    cfg = json.loads((bench_dir / "configs" / "upstream_nw_lg.json")
                     .read_text())
    cfg.update(name="added_nw_ag", algorithm="nw_ag", gape=-2)
    (bench_dir / "configs" / "added_nw_ag.json").write_text(
        json.dumps(cfg))
    # A new traffic mix: data only.
    (bench_dir / "traffic" / "added_few.json").write_text(json.dumps({
        "entry": {"name": "batch", "quantum": 64},
        "alphabet": "ACDEFGHIKLMNPQRSTVWY", "pool": 3,
        "pairs": {"list": [[31, 70], [5, 6], [64, 64]]}}))
    # A new metric: its own small reader.
    (bench_dir / "metrics" / "added_median_call_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median([c.seconds for c in run.calls])) * 1e3\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "added_nw_ag", "source": "a test",
        "file": "benchmark/configs/added_nw_ag.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "added_nw_ag.added_few", "config": "added_nw_ag",
        "traffic": "added_few", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "added_median_call_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["added_nw_ag.added_few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.run_cell("added_nw_ag.added_few", 5, 0.2, False,
                           device="cpu", root=str(tmp_path))
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "gcups", "added_median_call_ms"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "benchmark/configs/added_nw_ag.json",
        "benchmark/traffic/added_few.json",
        "benchmark/metrics/added_median_call_ms.py"}


def test_a_database_search_cell_added_as_new_files(tmp_path):
    """A query-against-database cell under the existing configuration and
    entry: one traffic file, with its own tiny twin, and new entries."""
    root = tmp_path / "root"
    root.mkdir()
    before = _copy(root)
    traffic = root / "benchmark" / "traffic" / "added_dbsearch.json"
    traffic.write_text(json.dumps({
        "entry": {"name": "batch", "quantum": "pow2"},
        "alphabet": "ARNDCQEGHILKMFPSTWYV", "pool": 3,
        "pairs": {"query_vs_db": {
            "queries": [31, 12, 47],
            "subjects": [2, 17, 40, 33, 96, 9, 150, 21, 64, 5, 38, 71]}},
        "tiny": {"pool": 2, "pairs": {"query_vs_db": {
            "queries": [6, 11], "subjects": [2, 5, 9, 3, 14]}}}}))
    cell = "blastp_sw_ag.added_dbsearch"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": cell, "config": "blastp_sw_ag",
        "traffic": "added_dbsearch",
        "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "blastp_sw_ag.allvsall20" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    for name, where in ((cell, str(root)),
                        (tiny_name(cell),
                         make_tiny_root(root, tmp_path / "tiny"))):
        for trace in (False, True):
            res = harness.run_cell(name, 2 ** 31 + 41, 0.2, trace,
                                   device="cpu", root=where)
            assert res["correct"] is True and res["failed"] == 0
            assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"host_prep_ms"}  # traced, no card
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "benchmark/traffic/added_dbsearch.json"}
