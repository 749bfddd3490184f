"""The giant pair across processes (``parallel/giant2.py`` over a mesh that
spans a gloo group, ``parallel/mesh.py``): two processes of two CPU bands
each (D = 4) return, on both ranks, the cost, score hash, trace hash and
transcript of the one-process D = 4 run, of ``cpu1_st_row`` and of the
JAX package's dense oracle (``gpuseqalign_tpu.models.oracle``), which
its own two-process test holds its engine against.

The pair is the JAX package's own two-process case
(``tests/test_multihost.py::test_two_process_giant_pair``: nw_ag 130 x 300,
a random 25 x 25 matrix from seed 33, tile 128 x 128, kChains 1), and the
same for sw_lg; then a stream of 3 pairs through ``align_giant2_stream``.
Both workers run every case in one spawn; each run has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core.types import AlignSpec as JaxAlignSpec
from gpuseqalign_tpu.models.oracle import (
    align_cost_of,
    oracle_align_dense,
    oracle_hash_dense,
    oracle_trace_dense,
)

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams,
    AlgResult,
    AlignSpec,
    make_alg_input,
)
from gpuseqalign_tpu_torch.parallel import (
    align_giant2,
    align_giant2_stream,
    align_pairs_batched,
    make_mesh,
)
from gpuseqalign_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("nw_ag", "sw_lg")
FIELDS = ("cost", "score_hash", "trace_hash", "edit_trace")

# Shared by the workers and the test: the case's inputs and how a result
# is read.
CASES = """
import numpy as np

PARAMS = {"tileBy": [128], "tileBx": [128], "kChains": [1]}
GAPO = -11


def gape(spec):
    return -2 if spec.endswith("ag") else 0


def inputs():
    rng = np.random.default_rng(33)
    subst = rng.integers(-4, 10, size=(25, 25)).astype(np.int32)

    def seq(n):
        return np.concatenate(
            [np.zeros(1, np.int32), rng.integers(0, 25, n, dtype=np.int32)])

    pair = (seq(130), seq(300))
    stream = [(seq(r), seq(c)) for r, c in ((130, 300), (300, 90),
                                            (260, 200))]
    return subst, pair, stream


def finish(alg, nw, res, stat):
    assert stat == 0, stat
    assert alg.hash(nw, res) == 0 and alg.trace(nw, res, False) == 0
    return {"cost": int(res.align_cost), "score_hash": int(res.score_hash),
            "trace_hash": int(res.trace_hash), "edit_trace": res.edit_trace}
"""

WORKER = """
import json
import sys
sys.path.insert(0, {repo!r})
from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams, AlgResult, make_alg_input)
from gpuseqalign_tpu_torch.parallel import (
    align_giant2, align_giant2_stream, distributed_init, make_mesh)
import torch.distributed as dist

rank = int(sys.argv[1])
distributed_init("localhost:{port}", 2, rank)
mesh = make_mesh(devices=["cpu", "cpu"], axis_name="sp",
                 span_processes=True)
alg = get_algorithm_map()["tpu9_giant_mlsp"]
subst, (y, x), stream = inputs()
out = {{"size": mesh.size, "first": mesh.first}}
for spec in {specs!r}:
    nw = make_alg_input(subst, y, x, GAPO, gape(spec), spec, device="cpu")
    res = AlgResult()
    out[spec] = finish(alg, nw, res,
                       align_giant2(AlgParams(PARAMS), nw, res, mesh=mesh))
    nws = [make_alg_input(subst, a, b, GAPO, gape(spec), spec, device="cpu")
           for a, b in stream]
    results = [AlgResult() for _ in nws]
    stats = align_giant2_stream(AlgParams(PARAMS), nws, results, mesh=mesh)
    out["stream_" + spec] = [finish(alg, *t)
                             for t in zip(nws, results, stats)]
# Ranks that name unequal device counts are refused, on every rank.
try:
    make_mesh(devices=["cpu"] * (1 + rank), span_processes=True)
    out["unequal"] = "accepted"
except ValueError:
    out["unequal"] = "refused"
print(json.dumps(out))
dist.destroy_process_group()
"""

ns = {}
exec(CASES, ns)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both workers' outputs: two gloo processes, two CPU bands each."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path_factory.mktemp("giant_procs") / "worker.py"
    script.write_text(CASES + WORKER.format(repo=REPO, port=port,
                                            specs=SPECS))
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(script.parent))
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


def _one_process(spec, pairs, subst, D):
    """The same case in this process: align_giant2 on each pair and the
    stream of them on a mesh of D CPU entries, and cpu1_st_row."""
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    ref = get_algorithm_map()["cpu1_st_row"]
    mesh = make_mesh(devices=["cpu"] * D, axis_name="sp")
    single, oracle = [], []
    nws = []
    for y, x in pairs:
        args = (subst, y, x, ns["GAPO"], ns["gape"](spec), spec)
        nw, res = make_alg_input(*args, device="cpu"), AlgResult()
        single.append(ns["finish"](alg, nw, res, align_giant2(
            AlgParams(ns["PARAMS"]), nw, res, mesh=mesh)))
        nw, res = make_alg_input(*args, device="cpu"), AlgResult()
        oracle.append(ns["finish"](ref, nw, res,
                                   ref.align(AlgParams({}), nw, res)))
        nws.append(make_alg_input(*args, device="cpu"))
    results = [AlgResult() for _ in nws]
    stats = align_giant2_stream(AlgParams(ns["PARAMS"]), nws, results,
                                mesh=mesh)
    stream = [ns["finish"](alg, *t) for t in zip(nws, results, stats)]
    return single, stream, oracle


def _jax_oracle(spec, pairs, subst):
    """Each pair's cost, hashes and transcript by the JAX package's dense
    oracle."""
    jspec = JaxAlignSpec.from_name(spec)
    out = []
    for y, x in pairs:
        costs = (ns["GAPO"], ns["gape"](spec))
        mats = oracle_align_dense(jspec, subst, y, x, *costs)
        trace, thash, _ = oracle_trace_dense(jspec, mats, subst, y, x,
                                             *costs)
        out.append({"cost": align_cost_of(jspec, mats),
                    "score_hash": oracle_hash_dense(mats["H"]),
                    "trace_hash": thash, "edit_trace": trace})
    return out


def test_mesh_spans_the_processes(ranks):
    assert [(o["size"], o["first"]) for o in ranks] == [(4, 0), (4, 2)]
    assert [o["unequal"] for o in ranks] == ["refused", "refused"]


@pytest.mark.parametrize("spec", SPECS)
def test_giant_pair_over_two_processes(ranks, spec):
    subst, pair, _ = ns["inputs"]()
    single, _, oracle = _one_process(spec, [pair], subst, 4)
    jax_ref = _jax_oracle(spec, [pair], subst)
    for o in ranks:
        assert o[spec] == single[0]
        assert {k: o[spec][k] for k in FIELDS} == oracle[0] == jax_ref[0]


@pytest.mark.parametrize("spec", SPECS)
def test_giant_stream_over_two_processes(ranks, spec):
    subst, _, stream = ns["inputs"]()
    single, one_stream, oracle = _one_process(spec, stream, subst, 4)
    assert one_stream == single == oracle == _jax_oracle(spec, stream, subst)
    for o in ranks:
        assert o["stream_" + spec] == single


def test_spanning_mesh_without_a_group_raises(blosum62):
    """No quiet fall back to one process: a mesh that spans processes
    needs its group, to be made and to be run."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="distributed"):
        make_mesh(devices=["cpu"], span_processes=True)
    mesh = Mesh((torch.device("cpu"),) * 2, "sp", processes=2, rank=0)
    assert mesh.size == 4
    y = np.zeros(11, np.int32)
    nw = make_alg_input(blosum62, y, y, -11, 0, "nw_lg", device="cpu")
    with pytest.raises(RuntimeError, match="distributed"):
        align_giant2(AlgParams({}), nw, AlgResult(), mesh=mesh)
    with pytest.raises(ValueError, match="processes"):
        align_pairs_batched(AlignSpec.from_name("nw_lg"), blosum62,
                            [(y, y)], -11, mesh=mesh)
