"""Each cell of BENCHMARK.json through ``benchmark/run.py`` on the card,
briefly, untraced and traced: ``python -m pytest benchmark/tests -m card``
on a machine with the card. Skips itself without one."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, workloads

CELLS = [w["name"] for w in workloads()]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "4", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1] == "check wrong 0 limit 0"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        roof = [v["value"] for k, v in line["metrics"].items()
                if k.endswith("fill_roofline")]
        assert roof and 0 < roof[0] <= 100
