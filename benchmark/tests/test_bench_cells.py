"""Each cell end to end on the CPU at a tiny size: its tiny twin (the same
configuration and entry, short sequences) through ``harness.run_cell``,
down to the result line the contract asks for."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import ROOT, THREE, tiny_name, tiny_of, workloads

CELLS = [w["name"] for w in workloads()]
SEED = 2 ** 31 + 977


def _declared(bench, workload, group):
    return {m["name"] for m in bench[group]
            if workload in m.get("workloads", [workload])}


def test_cells_are_the_issue_s_three(bench):
    """The first benchmark's three cells stay; of all the cells at most a
    quarter, rounded down, ask for four chips, and one always may."""
    names = [w["name"] for w in bench["workloads"]]
    assert set(THREE) <= set(names) and len(set(names)) == len(names)
    chips = [w["chips"] for w in bench["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_every_cell_has_a_tiny_twin(bench):
    """Each cell's traffic file has a ``"tiny"`` key, or the cell is one
    of the three whose twins ``conftest.TINY_TRAFFIC`` holds."""
    missing = []
    for w in bench["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               f"{w['traffic']}.json")) as f:
            if tiny_of(w["traffic"], json.load(f)) is None:
                missing.append(w["name"])
    assert not missing, f"cells with no tiny twin: {missing}"


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_line(tiny_root, cell, trace):
    name = tiny_name(cell)
    res = harness.run_cell(name, SEED, 0.2, bool(trace), device="cpu",
                           root=tiny_root)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["checks"] == {"wrong": {"value": 0, "limit": 0}}
    bench = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    group = "per_layer" if trace else "end_to_end"
    declared = _declared(bench, name, group)
    units = {m["name"]: m["unit"] for m in bench[group]}
    assert set(line["metrics"]) <= declared
    for key, m in line["metrics"].items():
        assert m["unit"] == units[key] and m["value"] > 0
    if not trace:
        assert set(line["metrics"]) == declared
        assert "busy_s" not in line["device"]
    else:
        # No kernel runs on the CPU: only the host's readings are there.
        host = {"host_prep_ms", "cpy_host_ms"} & declared
        assert set(line["metrics"]) == host
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) >= 1
    assert line["device"]["platform"] == "cpu"


def test_same_seed_same_pool(tiny_root):
    cell = harness.Cell(tiny_name("blastp_sw_ag.allvsall20"), tiny_root)
    from benchmark import generate

    a = generate.make_pool(cell.traffic, cell.config, SEED)
    b = generate.make_pool(cell.traffic, cell.config, SEED)
    c = generate.make_pool(cell.traffic, cell.config, SEED + 1)
    flat = [s for pairs in a for p in pairs for s in p]
    assert all((u == v).all() for u, v in zip(
        flat, [s for pairs in b for p in pairs for s in p]))
    assert any((u != v).any() for u, v in zip(
        flat, [s for pairs in c for p in pairs for s in p]))
    # Every seed gives the same lengths; residues are the 20 standard ones.
    assert [len(s) for s in flat] == [
        len(s) for pairs in c for p in pairs for s in p]
    assert all(s[0] == 0 and 0 <= s[1:].min() and s[1:].max() < 20
               for s in flat)


def test_negative_and_huge_seeds(tiny_root):
    cell = harness.Cell(tiny_name("upstream_nw_lg.release"), tiny_root)
    from benchmark import generate

    for seed in (-1, 2 ** 40 + 3):
        assert len(generate.make_pool(cell.traffic, cell.config, seed)) == 2


def test_run_py_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", THREE[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files: no result line, a non-zero exit (here already for want of a
    card; the import of the port fails after it on a card)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", THREE[2],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", "from benchmark import harness; "
         f"harness.run_cell({THREE[2]!r}, 1, 0.1, False, device='cpu')"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'gpuseqalign_tpu_torch'" in out.stderr
