"""A cell, a configuration and metrics added as new files and new entries
of BENCHMARK.json alone: the harness finds and runs them, and no file
that was there before changes."""

import hashlib
import json
import os
import pathlib
import shutil

from benchmark import harness
from conftest import ROOT


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(pathlib.Path(root, "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = _digests(tmp_path)
    bench_dir = tmp_path / "benchmark"

    # A new deployment: NW with an affine gap, another file.
    cfg = json.loads((bench_dir / "configs" / "upstream_nw_lg.json")
                     .read_text())
    cfg.update(name="upstream_nw_ag", algorithm="nw_ag", gape=-2)
    (bench_dir / "configs" / "upstream_nw_ag.json").write_text(
        json.dumps(cfg))
    # A new traffic mix: data only.
    (bench_dir / "traffic" / "few.json").write_text(json.dumps({
        "entry": {"name": "batch", "quantum": 64},
        "alphabet": "ACDEFGHIKLMNPQRSTVWY", "pool": 3,
        "pairs": {"list": [[31, 70], [5, 6], [64, 64]]}}))
    # A new metric: its own small reader.
    (bench_dir / "metrics" / "median_call_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median([c.seconds for c in run.calls])) * 1e3\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "upstream_nw_ag", "source": "a test",
        "file": "benchmark/configs/upstream_nw_ag.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "upstream_nw_ag.few", "config": "upstream_nw_ag",
        "traffic": "few", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "median_call_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["upstream_nw_ag.few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.run_cell("upstream_nw_ag.few", 5, 0.2, False,
                           device="cpu", root=str(tmp_path))
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "gcups", "median_call_ms"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "benchmark/configs/upstream_nw_ag.json", "benchmark/traffic/few.json",
        "benchmark/metrics/median_call_ms.py"}
