"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU: the port's kernels are replaced there by their plain
versions, at tiny sizes. A test that needs the card carries the ``card``
marker and skips inside itself when there is none.
"""

import json
import os
import pathlib
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

# The tiny twins of the cells that came before the ``"tiny"`` key: the same
# configuration and entry, lengths cut so that the plain fills on the CPU
# take a moment. A cell added later brings its own, as ``"tiny":
# {"pairs": {...}, "pool": n}`` in its traffic file.
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


def tiny_of(traffic_name: str, traffic: dict):
    """A traffic's tiny twin, ``{"pairs": ..., "pool": n}``, from its own
    ``"tiny"`` key or ``TINY_TRAFFIC``; None where it has neither."""
    if "tiny" in traffic:
        return traffic["tiny"]
    if traffic_name in TINY_TRAFFIC:
        return {"pairs": TINY_TRAFFIC[traffic_name], "pool": 2}
    return None


def make_tiny_root(src, dst) -> str:
    """A checkout-like root in ``dst``: ``src``'s BENCHMARK.json and
    benchmark files, plus for every cell with a tiny twin (``tiny_of``)
    that twin added as new files (a traffic file) and new entries (the
    workload, and the twin beside the cell in every metric's list)."""
    dst = pathlib.Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(src, "benchmark"), dst / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    traffic_dir = dst / "benchmark" / "traffic"
    for w in list(bench["workloads"]):
        traffic = json.loads((traffic_dir / f"{w['traffic']}.json")
                             .read_text())
        tiny = tiny_of(w["traffic"], traffic)
        if tiny is None:
            continue
        traffic.pop("tiny", None)
        traffic.update(pairs=tiny["pairs"], pool=tiny["pool"])
        name = w["traffic"] + "_tiny"
        (traffic_dir / f"{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append(dict(w, name=tiny_name(w["name"]),
                                       traffic=name))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(tiny_name(w["name"]))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(dst)


@pytest.fixture
def tiny_root(tmp_path):
    """``make_tiny_root`` of the repository in ``tmp_path``."""
    return make_tiny_root(ROOT, tmp_path)


def workloads() -> list:
    """The cells of BENCHMARK.json, in its order."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)["workloads"]


# The three cells of the first benchmark, which every later one keeps.
THREE = ["upstream_nw_lg.pg1", "blastp_sw_ag.allvsall20",
         "upstream_nw_lg.release"]


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
