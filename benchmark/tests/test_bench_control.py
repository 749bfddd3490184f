"""The comparison that decides ``correct`` fails what it has to fail.

The control (the reference in a narrower integer put in the program's
place) at a size where its values leave that integer's range, and a run
with the timed path broken underneath: the harness's look for a card is
skipped (``device="cpu"``), the rest of the run is as on the card. The
cells run on one card, so there is no exchange between cards to leave
out.
"""

import json
import os

import numpy as np
import pytest

from benchmark import control, harness
from conftest import tiny_name


def _add_cell(root, name, config, traffic):
    path = os.path.join(root, "benchmark", "traffic", f"{name}.json")
    with open(path, "w") as f:
        json.dump(traffic, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    cell = f"{config}.{name}"
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": name, "chips": 1, "why": "test"})
    json.dump(bench, open(bench_path, "w"))
    return cell


def test_nw_control_fails_where_sixteen_bits_saturate(tiny_root):
    # 40 residues against 3100: a global cost below -32768.
    cell = _add_cell(tiny_root, "wide", "upstream_nw_lg", {
        "entry": {"name": "batch", "quantum": "pow2"},
        "alphabet": "ARNDCQEGHILKMFPSTWYV", "pool": 2,
        "pairs": {"list": [[40, 3100], [30, 50]]}})
    r = control.readings(cell, 4, 0.05, [16], device="cpu", root=tiny_root)
    assert r["program_wrong"] == 0
    assert r["control16_pairs_wrong"] == 2  # the wide pair of each request
    assert r["control16_wrong"] == r["calls"]


def test_a_self_pair_of_the_release_shape_leaves_sixteen_bits():
    # The release cell aligns one sequence with itself: a cost of about
    # 5.8 a residue, past 32767 from about 5700 residues (23728 on the
    # card; 6000 here).
    from benchmark import generate
    from benchmark.reference import dp

    cfg = harness.Cell("upstream_nw_lg.release").config
    traffic = {"alphabet": "ARNDCQEGHILKMFPSTWYV", "pool": 1,
               "pairs": {"all_vs_all": [6000]}}
    pairs = generate.make_pool(traffic, cfg, 2 ** 31 + 11)[0]
    subst = dp.matrix(cfg)
    kw = dict(algorithm="nw_lg", gapo=cfg["gapo"], gape=cfg["gape"])
    exact = dp.align(pairs, subst, **kw)[0, 0]
    assert exact > 2 ** 15
    assert dp.align(pairs, subst, bits=16, **kw)[0, 0] != exact


def test_sw_control_fails_at_eight_bits(tiny_root):
    # Self pairs score far above 127; 16 bits hold them.
    r = control.readings(tiny_name("blastp_sw_ag.allvsall20"), 4, 0.05,
                         [16, 8], device="cpu", root=tiny_root)
    assert r["program_wrong"] == 0 and r["control16_wrong"] == 0
    assert r["control8_pairs_wrong"] > 0 and r["control8_wrong"] > 0


def _half_left_out(align):
    def broken(spec, subst, pairs, *a, **k):
        out = align(spec, subst, pairs[:len(pairs) // 2], *a, **k)
        pad = len(pairs) - len(out.costs)
        # The missing half takes the mean of the rest.
        fill = lambda v: np.concatenate([v, np.full(pad, int(v.mean()),
                                                    v.dtype)])
        return type(out)(fill(out.costs), fill(out.best_i),
                         fill(out.best_j), out.n_buckets)
    return broken


def _altered(bucket_scores):
    def broken(*a, **k):
        res = bucket_scores(*a, **k).clone()
        res[0, 0] += 1  # one cost altered where the kernel route gives it
        return res
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["upstream_nw_lg.pg1",
                                  "blastp_sw_ag.allvsall20"])
def test_broken_batch_path_reads_not_correct(tiny_root, monkeypatch, cell,
                                             fault):
    from gpuseqalign_tpu_torch.parallel import batch

    entry_mod = harness._module(tiny_root, "entries", "batch")
    if fault == "unchanged":
        # A call that returns the state of the call before it.
        last = {}
        call = entry_mod.Entry.call

        def stale(self, k):
            out = last.get("out") or call(self, k)
            last["out"] = call(self, k)
            return out
        monkeypatch.setattr(entry_mod.Entry, "call", stale)
    elif fault == "half":
        monkeypatch.setattr(entry_mod, "align_pairs_batched",
                            _half_left_out(batch.align_pairs_batched))
    else:
        monkeypatch.setattr(batch, "bucket_scores",
                            _altered(batch.bucket_scores))
    monkeypatch.setattr(harness, "_module",
                        lambda root, kind, name, _m=harness._module:
                        entry_mod if kind == "entries" else _m(root, kind,
                                                               name))
    res = harness.run_cell(tiny_name(cell), 9, 0.2, False, device="cpu",
                           root=tiny_root)
    assert res["correct"] is False
    assert res["checks"]["wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_single_pair_path_reads_not_correct(tiny_root, monkeypatch,
                                                   fault):
    from gpuseqalign_tpu_torch.ops import mlsp_kernels

    if fault == "unchanged":
        # The store hands back the cost of the call before.
        store = mlsp_kernels._mlsp_store
        last = {}

        def stale(nw, res, *a, **k):
            stat = store(nw, res, *a, **k)
            res.align_cost, last["cost"] = last.get("cost",
                                                    res.align_cost), \
                res.align_cost
            return stat
        monkeypatch.setattr(mlsp_kernels, "_mlsp_store", stale)
    else:
        fill = mlsp_kernels.mlsp_cuda.mlsp_fill

        def altered(*a, **k):
            out = fill(*a, **k)
            out["hrows"] = out["hrows"].clone()
            out["hrows"][-1] += 1  # the last tile's header row altered
            return out
        monkeypatch.setattr(mlsp_kernels.mlsp_cuda, "mlsp_fill", altered)
    res = harness.run_cell(tiny_name("upstream_nw_lg.release"), 9, 0.2,
                           False, device="cpu", root=tiny_root)
    assert res["correct"] is False
    assert res["checks"]["wrong"]["value"] > 0
