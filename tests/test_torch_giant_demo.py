"""The port's giant-pair demo (``bench/giant_demo.py``) on the CPU: the JAX
demo's inputs, its result line, and a fill whose cost is the oracle's."""

import json
import os
import re

import numpy as np
import pytest

from gpuseqalign_tpu_torch.bench import giant_demo
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    Status,
    make_alg_input,
)
from gpuseqalign_tpu_torch.models.cpu_algs import align_cpu1_st_row
from gpuseqalign_tpu_torch.ops import tuned
from gpuseqalign_tpu_torch.ops.mlsp_kernels import _mlsp_store, tile_headers

LINE = re.compile(r"^nw_affine 300x300: \d+ ms  \d+\.\d GCUPS  sparse output "
                  r"\d+ MB \(dense would be \d+ GB\)$", re.M)


def _jax_recipe(n):
    """The draws of gpuseqalign_tpu/bench/giant_demo.py's main, as it makes
    them (its y and x padded to its own tiles; the residues are these)."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 25, n)
    x = rng.integers(0, 25, n)
    subst = rng.integers(-4, 10, size=(25, 25))
    return y, x, subst


@pytest.mark.parametrize("n", [1, 300, 100_000])
def test_demo_inputs_are_the_jax_demos(n):
    y, x, subst = giant_demo.demo_inputs(n)
    jy, jx, js = _jax_recipe(n)
    assert y.dtype == x.dtype == subst.dtype == np.int32
    assert y[0] == x[0] == 0 and len(y) == len(x) == n + 1
    np.testing.assert_array_equal(y[1:], jy)
    np.testing.assert_array_equal(x[1:], jx)
    np.testing.assert_array_equal(subst, js)


def test_main_prints_the_jax_line(capsys):
    assert giant_demo.main(["300", "nw_ag"], device="cpu") == 0
    out = capsys.readouterr().out
    assert LINE.search(out)
    assert out.splitlines()[0] == "card: cpu, power limit None"


@pytest.mark.parametrize("spec", ["nw_lg", "nw_ag", "sw_lg", "sw_ag"])
def test_the_fills_cost_is_cpu1s(spec):
    r = giant_demo.run_demo(300, spec, "cpu")
    assert r["tile"] == (128, 512)
    y, x, subst = giant_demo.demo_inputs(300)
    gape = giant_demo.GAPE if spec.endswith("ag") else 0
    h = {k: v.numpy() for k, v in r["headers"].items()}
    nw = make_alg_input(subst, y, x, giant_demo.GAPO, gape, spec,
                        device="cpu")
    res = AlgResult()
    th, tw = r["tile"]
    trows, tcols = h["hrows"].shape[0], h["hcols"].shape[2]
    mats = tile_headers(h["hrows"], h["hcols"], th, tw, trows, tcols,
                        frows=h.get("frows"), ecols=h.get("ecols"),
                        best=h.get("best"))
    assert _mlsp_store(nw, res, mats, th, tw, trows,
                       tcols) == Status.success
    nwo = make_alg_input(subst, y, x, giant_demo.GAPO, gape, spec,
                         device="cpu")
    reso = AlgResult()
    assert align_cpu1_st_row(AlgParams({}), nwo, reso) == Status.success
    assert res.align_cost == reso.align_cost
    assert r["out_bytes"] == sum(v.nbytes for v in h.values())


def test_the_demo_ignores_a_cache_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tuned, "cache_name", lambda device: "test_card")
    monkeypatch.setattr(tuned, "ROOT", str(tmp_path))
    with open(os.path.join(tmp_path, "test_card.json"), "w") as f:
        json.dump({"nw_ag": {"tileBy": 64, "tileBx": 256}}, f)
    assert giant_demo.run_demo(50, "nw_ag", "cpu")["tile"] == (128, 512)
