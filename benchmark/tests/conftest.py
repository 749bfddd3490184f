"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU: the port's kernels are replaced there by their plain
versions, at tiny sizes. A test that needs the card carries the ``card``
marker and skips inside itself when there is none.
"""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# One thread: the tiny shapes gain nothing from more, and on a shared
# host the idle threads' spinning slows every small operator.
torch.set_num_threads(1)

# Each real cell's tiny twin: the same configuration and entry, lengths cut
# so that the plain fills on the CPU take a moment.
TINY_TRAFFIC = {
    "pg1": {"all_vs_all": [5, 10, 15, 20, 25, 45, 50, 94]},
    "allvsall20": {"all_vs_all": [3, 4, 6, 9, 12, 19, 33, 47]},
    "release": {"all_vs_all": [237]},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips itself without one")


def tiny_name(workload: str) -> str:
    return workload + "_tiny"


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout-like root in ``tmp_path``: BENCHMARK.json and the
    benchmark's files, plus for every cell a tiny twin added as new files
    (a traffic file) and new entries (the workload, and the twin beside the
    cell in every metric's list)."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for w in list(bench["workloads"]):
        traffic = json.loads(
            (tmp_path / "benchmark" / "traffic" / f"{w['traffic']}.json")
            .read_text())
        traffic["pairs"] = TINY_TRAFFIC[w["traffic"]]
        traffic["pool"] = 2
        name = w["traffic"] + "_tiny"
        (tmp_path / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        bench["workloads"].append(dict(w, name=tiny_name(w["name"]),
                                       traffic=name))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(tiny_name(w["name"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
