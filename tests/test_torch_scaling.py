"""The port's scaling report (``bench/scaling_report.py``) on the CPU at
the JAX report's quick sizes: one JSON document with its five rows, each
from a fresh subprocess and each naming the CPU it ran on."""

import contextlib
import io
import json

import pytest

from gpuseqalign_tpu_torch.bench import scaling_report

ROWS = ("1cpu", "mesh", "2procs", "giant_pair", "giant_stream")


@pytest.fixture(scope="module")
def printed(tmp_path_factory):
    """(stdout, the --out file) of one quick report on the CPU."""
    out = tmp_path_factory.mktemp("scaling") / "report.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert scaling_report.main(["--quick", "--device", "cpu", "--out",
                                    str(out)]) == 0
    return buf.getvalue(), out.read_text()


@pytest.fixture(scope="module")
def report(printed):
    return json.loads(printed[1])


def _rows(report):
    rows = dict(report["configs"])
    giant = rows.pop("giant_pair")
    rows["giant_D1"], rows["giant_D4"] = giant["D1"], giant["D4"]
    return rows


def test_report_has_the_five_rows(report):
    assert tuple(report["configs"]) == ROWS
    assert report["quick"] and report["spec"] == "nw_ag"


@pytest.mark.parametrize("row,entries", [
    ("1cpu", 1), ("mesh", 2), ("2procs", 2), ("giant_D1", 1),
    ("giant_D4", 4), ("giant_stream", 4)])
def test_each_row_names_the_cpu(report, row, entries):
    where = _rows(report)[row]["ran_on"]
    assert where["platform"] == "cpu" and where["cards"] == 0
    assert where["entries"] == entries
    assert where["where"].endswith("the CPU")


def test_rows_agree(report):
    """The batch rows align the same pairs; the giant pair's cost is the
    same at D = 1 and 4, its calls are the call model's."""
    rows = report["configs"]
    assert (rows["1cpu"]["cost_sum"] == rows["mesh"]["cost_sum"]
            == rows["2procs"]["cost_sum"])
    g1, g4 = rows["giant_pair"]["D1"], rows["giant_pair"]["D4"]
    assert g1["cost"] == g4["cost"]
    assert (g1["calls"], g4["bands"]) == (1, 4)
    assert g4["calls"] == -(-g4["n_pass"] // g4["call_passes"])
    assert rows["giant_stream"]["pairs"] == 3


def test_report_prints_what_it_writes(printed):
    """stdout is the one JSON document that --out holds."""
    assert json.loads(printed[0]) == json.loads(printed[1])


def test_a_bad_row_fails():
    with pytest.raises(KeyError):
        scaling_report.run_job(json.dumps({"kind": "none"}))
