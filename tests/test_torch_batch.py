"""The port's batch engine against gpuseqalign_tpu, bit for bit.

Inputs are made with numpy from a seed and handed to both packages: the
port on the CPU (the kernels' plain versions), the JAX package through its
CPU route (the vmapped XLA row-scan ``scores_batch``; no Pallas kernel).
Wider checks hold the port against the numpy oracle. No tolerance: every
output is int32 and must be identical.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core.types import AlignSpec as JaxSpec
from gpuseqalign_tpu.models.oracle import align_cost_of, oracle_align_dense
from gpuseqalign_tpu.parallel import batch as jax_batch

from gpuseqalign_tpu_torch.bench import throughput
from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.ops import batch_cuda, mlsp_cuda
from gpuseqalign_tpu_torch.ops.batch_plain import (
    mlsp_fill_batch_plain,
    scores_batch_plain,
)
from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain
from gpuseqalign_tpu_torch.parallel import (
    align_pairs_batched,
    bucket_pairs,
)
from gpuseqalign_tpu_torch.parallel import batch as port_batch

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2
RESRC = os.path.join(os.path.dirname(__file__), "..", "resrc")


def _pair(rng, rows, cols, letters=25):
    y = np.concatenate([[0], rng.integers(0, letters, rows)]).astype(np.int32)
    x = np.concatenate([[0], rng.integers(0, letters, cols)]).astype(np.int32)
    return y, x


def _stack(pairs, rows_p, cols_p):
    """numpy (ys, xs, adjrs, adjcs) of the pairs padded to one shape."""
    b = len(pairs)
    ys = np.zeros((b, 1 + rows_p), np.int32)
    xs = np.zeros((b, 1 + cols_p), np.int32)
    for k, (y, x) in enumerate(pairs):
        ys[k, :len(y)], xs[k, :len(x)] = y, x
    adjrs = np.array([len(y) for y, _ in pairs], np.int32)
    adjcs = np.array([len(x) for _, x in pairs], np.int32)
    return ys, xs, adjrs, adjcs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


@pytest.mark.parametrize("quantum", [128, 256, "pow2"])
def test_bucket_pairs_matches_jax(quantum):
    rng = np.random.default_rng(7)
    lens = [0, 1, 2, 127, 128, 129, 255, 256, 257, 511, 600, 1023, 1025,
            3000] + list(rng.integers(0, 2000, 30))
    pairs = [(np.zeros(1 + r, np.int32), np.zeros(1 + c, np.int32))
             for r, c in zip(lens, reversed(lens))]
    assert bucket_pairs(pairs, quantum) == jax_batch.bucket_pairs(
        pairs, quantum)


@pytest.mark.parametrize("spec", SPECS)
def test_degenerate_cost_matches_jax(spec):
    grid = [(r, c) for r in (1, 2, 3, 9) for c in (1, 2, 3, 9)
            if r < 2 or c < 2]
    for gapo, gape in ((-11, -2), (-3, 0), (0, -1)):
        for r, c in grid:
            assert port_batch._degenerate_cost(
                AlignSpec.from_name(spec), r, c, gapo, gape
            ) == jax_batch._degenerate_cost(
                JaxSpec.from_name(spec), r, c, gapo, gape)


# Residue counts; the last pair's bucket is >= 1024 rows tall, so it
# takes the batched tile fill's route (its plain version on the CPU).
SIZES = [(1, 1), (3, 200), (130, 75), (257, 513), (64, 64), (200, 3),
         (1030, 40)]


@pytest.mark.parametrize("spec", SPECS)
def test_align_pairs_batched_matches_jax_and_oracle(blosum62, spec):
    rng = np.random.default_rng(11)
    pairs = [_pair(rng, r, c) for r, c in SIZES]
    port = align_pairs_batched(AlignSpec.from_name(spec), blosum62, pairs,
                               GAPO, GAPE, device="cpu")
    ref = jax_batch.align_pairs_batched(JaxSpec.from_name(spec), blosum62,
                                        pairs, GAPO, GAPE)
    for name in ("costs", "best_i", "best_j"):
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.n_buckets == ref.n_buckets == 3
    jspec = JaxSpec.from_name(spec)
    for k, (y, x) in enumerate(pairs):
        mats = oracle_align_dense(jspec, blosum62, y, x, GAPO, GAPE)
        assert port.costs[k] == align_cost_of(jspec, mats)
        if spec.startswith("sw"):
            assert (port.best_i[k], port.best_j[k]) == tuple(
                int(v) for v in mats["best"])


@pytest.mark.parametrize("spec", SPECS)
def test_empty_sequences_get_the_edge_cost(blosum62, spec):
    """Pairs with an empty sequence never reach a kernel; their cost is the
    analytic edge, as in the JAX package and the oracle."""
    rng = np.random.default_rng(3)
    pairs = [_pair(rng, r, c) for r, c in ((0, 0), (0, 5), (7, 0), (4, 6))]
    port = align_pairs_batched(AlignSpec.from_name(spec), blosum62, pairs,
                               GAPO, GAPE, device="cpu")
    ref = jax_batch.align_pairs_batched(JaxSpec.from_name(spec), blosum62,
                                        pairs, GAPO, GAPE)
    np.testing.assert_array_equal(port.costs, ref.costs)
    np.testing.assert_array_equal(port.best_i, ref.best_i)
    np.testing.assert_array_equal(port.best_j, ref.best_j)


@pytest.mark.parametrize("spec", SPECS)
def test_scores_batch_plain_matches_jax(blosum62, spec):
    """A stacked bucket of a non-power-of-two quantum (100): mixed true
    lengths, adjr == 2 and adjc == 2 among them."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    sizes = [(300, 200), (1, 150), (250, 1), (201, 101), (17, 199)]
    ys, xs, adjrs, adjcs = _stack([_pair(rng, r, c) for r, c in sizes],
                                  300, 200)
    got = scores_batch_plain(*_torch(blosum62, ys, xs, adjrs, adjcs), GAPO,
                             GAPE, **_kind_gap(spec))
    want = jax_batch.scores_batch(
        jnp.asarray(blosum62), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(adjrs), jnp.asarray(adjcs), jnp.int32(GAPO),
        jnp.int32(GAPE), **_kind_gap(spec))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("spec", SPECS)
def test_fill_batch_plain_per_pair(blosum62, spec):
    """Each pair's headers equal ``mlsp_fill_plain`` on that pair alone,
    the cost and best equal the oracle, and every block-bottom row equals
    the oracle run on the padded pair."""
    rng = np.random.default_rng(9)
    th, tw, rows_p, cols_p = 32, 48, 96, 144
    pairs = [_pair(rng, r, c) for r, c in ((96, 144), (1, 50), (60, 1),
                                           (70, 100))]
    ys, xs, adjrs, adjcs = _stack(pairs, rows_p, cols_p)
    kw = dict(tile_h=th, tile_w=tw, **_kind_gap(spec))
    subst_t, ys_t, xs_t, ar_t, ac_t = _torch(blosum62, ys, xs, adjrs, adjcs)
    out = mlsp_fill_batch_plain(subst_t, ys_t, xs_t, GAPO, GAPE, ar_t, ac_t,
                                **kw)
    jspec = JaxSpec.from_name(spec)
    for k, (y, x) in enumerate(pairs):
        one = mlsp_fill_plain(subst_t, ys_t[k], xs_t[k], GAPO, GAPE,
                              int(adjrs[k]), int(adjcs[k]), **kw)
        for name, t in one.items():
            assert torch.equal(out[name][k], t), name
        mats = oracle_align_dense(jspec, blosum62, y, x, GAPO, GAPE)
        assert int(out["cost"][k]) == align_cost_of(jspec, mats)
        hp = oracle_align_dense(jspec, blosum62, ys[k], xs[k], GAPO,
                                GAPE)["H"]
        np.testing.assert_array_equal(out["hrows"][k].numpy(),
                                      hp[0:rows_p:th])


@pytest.mark.parametrize("spec", ["sw_lg", "sw_ag"])
def test_sw_ties_take_the_row_major_first_cell(spec):
    """Several cells share the maximum: the best is the smallest row, then
    the smallest column, in the port, the JAX package and the oracle."""
    subst = np.full((4, 4), -5, np.int32)
    subst[1, 1] = 3
    y = np.array([0, 2, 1, 2, 2, 1, 2, 1], np.int32)
    x = np.array([0, 1, 2, 2, 1, 2, 2, 1, 2], np.int32)
    jspec = JaxSpec.from_name(spec)
    mats = oracle_align_dense(jspec, subst, y, x, GAPO, GAPE)
    assert (mats["H"] == mats["H"].max()).sum() > 2
    pairs = [(y, x), (x, y)]
    port = align_pairs_batched(AlignSpec.from_name(spec), subst, pairs,
                               GAPO, GAPE, device="cpu")
    ref = jax_batch.align_pairs_batched(jspec, subst, pairs, GAPO, GAPE)
    for k, (a, b) in enumerate(pairs):
        m = oracle_align_dense(jspec, subst, a, b, GAPO, GAPE)
        want = (align_cost_of(jspec, m), *(int(v) for v in m["best"]))
        assert (port.costs[k], port.best_i[k], port.best_j[k]) == want
        assert (ref.costs[k], ref.best_i[k], ref.best_j[k]) == want


@pytest.mark.parametrize("gapo,gape", [(1, -2), (-11, 1)])
def test_affine_guard_raises_like_jax(blosum62, gapo, gape):
    pairs = [_pair(np.random.default_rng(1), 5, 5)]
    with pytest.raises(ValueError) as port:
        align_pairs_batched(AlignSpec.from_name("nw_ag"), blosum62, pairs,
                            gapo, gape, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_batch.align_pairs_batched(JaxSpec.from_name("nw_ag"), blosum62,
                                      pairs, gapo, gape)
    assert str(port.value) == str(ref.value)


def test_wrappers_on_cpu_are_the_plain_versions(blosum62):
    """On CPU tensors the kernel wrappers return their plain versions'
    outputs and count no launch."""
    rng = np.random.default_rng(2)
    ys, xs, adjrs, adjcs = _stack([_pair(rng, 30, 40), _pair(rng, 12, 7)],
                                  32, 48)
    args = _torch(blosum62, ys, xs, adjrs, adjcs)
    before = (batch_cuda.FILL_LAUNCHES, batch_cuda.TINY_LAUNCHES)
    kw = dict(kind="sw", gap="affine")
    got = batch_cuda.tiny_scores(args[0], args[1], args[2], GAPO, GAPE,
                                 args[3], args[4], **kw)
    want = scores_batch_plain(*args, GAPO, GAPE, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fill_kw = dict(tile_h=16, tile_w=24, **kw)
    got = batch_cuda.mlsp_fill_batch(args[0], args[1], args[2], GAPO, GAPE,
                                     args[3], args[4], headers=True,
                                     **fill_kw)
    want = mlsp_fill_batch_plain(args[0], args[1], args[2], GAPO, GAPE,
                                 args[3], args[4], **fill_kw)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    lean = batch_cuda.mlsp_fill_batch(args[0], args[1], args[2], GAPO, GAPE,
                                      args[3], args[4], **fill_kw)
    assert sorted(lean) == ["best", "cost"]
    assert (batch_cuda.FILL_LAUNCHES, batch_cuda.TINY_LAUNCHES) == before


@pytest.mark.parametrize("spec", SPECS)
def test_alloc_headers_writes_the_plain_edge(blosum62, spec):
    """The kernel wrappers' header buffers start with the analytic edge
    (header row 0, column 0) that the plain fill computes, for one pair
    and for a leading pair axis."""
    rng = np.random.default_rng(4)
    th, tw, rows_p, cols_p = 16, 24, 48, 72
    ys, xs, adjrs, adjcs = _stack([_pair(rng, 40, 70)], rows_p, cols_p)
    kw = _kind_gap(spec)
    plain = mlsp_fill_plain(*_torch(blosum62, ys[0], xs[0]), GAPO, GAPE,
                            41, 71, tile_h=th, tile_w=tw, **kw)
    for lead in ((), (3,)):
        got = mlsp_cuda.alloc_headers(lead, rows_p, cols_p, th, tw, GAPO,
                                      GAPE, kw["kind"], kw["gap"],
                                      torch.device("cpu"))
        assert sorted(got) == sorted(k for k in plain if k != "best")
        for name in ("hrows", "frows"):
            if name in got:
                want = plain[name]
                edge = got[name].reshape(-1, *want.shape)
                assert (edge[:, 0] == want[0]).all(), name
                assert (edge[:, 1:, 0] == want[1:, 0]).all(), name
        for name in ("hcols", "ecols"):
            if name in got:
                want = plain[name]
                edge = got[name].reshape(-1, *want.shape)
                assert (edge[..., 0] == want[..., 0]).all(), name


def test_tile_best_takes_the_row_major_first_maximum():
    tbest = torch.tensor([
        [[5, 9, 2], [7, 4, 8], [7, 4, 3], [7, 6, 1]],   # tie: (4, 3) wins
        [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]],   # nothing > 0
        [[2, 1, 1], [1, 1, 0], [2, 0, 9], [2, 3, 0]],   # tie: (0, 9) wins
    ], dtype=torch.int32)
    got = mlsp_cuda.tile_best(tbest, width=20)
    assert got.tolist() == [[7, 4, 3], [0, 0, 0], [2, 0, 9]]


@pytest.mark.parametrize("bad", ["dtype", "rows", "lengths", "tile"])
def test_wrappers_reject_bad_inputs(blosum62, bad):
    subst = torch.from_numpy(blosum62)
    ys = torch.zeros((2, 1 + 32), dtype=torch.int32)
    xs = torch.zeros((2, 1 + 64), dtype=torch.int32)
    adjrs = torch.full((2,), 5, dtype=torch.int32)
    adjcs = torch.full((2,), 5, dtype=torch.int32)
    th = 16
    if bad == "dtype":
        ys = ys.long()
    elif bad == "rows":
        xs = torch.zeros((3, 1 + 64), dtype=torch.int32)
    elif bad == "lengths":
        adjcs = torch.full((3,), 5, dtype=torch.int32)
    else:
        th = 5
    with pytest.raises((TypeError, ValueError)):
        batch_cuda.mlsp_fill_batch(subst, ys, xs, GAPO, GAPE, adjrs, adjcs,
                                   tile_h=th, tile_w=16, kind="nw",
                                   gap="linear")
    if bad != "tile":
        with pytest.raises((TypeError, ValueError)):
            batch_cuda.tiny_scores(subst, ys, xs, GAPO, GAPE, adjrs, adjcs,
                                   kind="nw", gap="linear")


@pytest.mark.parametrize("spec", SPECS)
def test_throughput_on_cpu_verifies(tmp_path, capsys, spec):
    out = tmp_path / "out.json"
    rc = throughput.main([
        "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--synthPairs", "48,1,300", "--algKind", spec, "--repeat", "1",
        "--jsonPath", str(out),
    ], device="cpu")
    assert rc == 0
    assert "verify ok" in capsys.readouterr().out
    got = json.loads(out.read_text())
    assert got["pairs"] == len(got["costs"]) == 48
    assert got["device"] == "cpu"
    assert got["seconds"] == float(np.median(got["seconds_all"]))
    assert got["seconds_best"] == min(got["seconds_all"])


def test_engine_steps_are_profiler_spans(blosum62):
    """align_pairs_batched marks its host steps as torch.profiler spans,
    which the chip smoke run reads to split a window between host and
    device."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    pairs = [_pair(rng, r, c) for r, c in ((20, 30), (0, 4), (300, 10))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        align_pairs_batched(AlignSpec.from_name("nw_lg"), blosum62, pairs,
                            GAPO, device="cpu")
    names = {e.key for e in prof.key_averages()}
    assert {"batch.bucket_pairs", "batch.subst", "batch.stack_bucket",
            "batch.pad_rows", "batch.bucket_scores", "batch.tiny",
            "batch.copy_back", "batch.gather"} <= names


@pytest.mark.parametrize("spec", SPECS)
def test_bucket_route_is_a_span_inside_its_step(blosum62, monkeypatch,
                                                spec):
    """While a profiler records (here: the flag the spans read), each
    bucket's kernel call is the span of its route, ``batch.fill`` for a
    bucket of rows_p >= 1024 and ``batch.tiny`` for a short one (on the
    CPU ``fill_route`` decides by height), once a bucket whatever its
    pairs, inside the bucket's ``batch.bucket_scores`` beside
    ``batch.copy_back``; ``batch.pad_rows`` lies inside
    ``batch.stack_bucket``."""
    from torch.autograd.profiler import record_function

    spans = []  # (name, start, end) of every span, host clock
    enter, leave = record_function.__enter__, record_function.__exit__

    def timed_enter(rf):
        rf.t0 = time.perf_counter_ns()
        return enter(rf)

    def timed_exit(rf, *exc):
        out = leave(rf, *exc)
        spans.append((rf.name, rf.t0, time.perf_counter_ns()))
        return out

    monkeypatch.setattr(record_function, "__enter__", timed_enter)
    monkeypatch.setattr(record_function, "__exit__", timed_exit)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    rng = np.random.default_rng(9)
    pairs = [_pair(rng, r, c) for r, c in
             ((1000, 3), (20, 30), (40, 50), (0, 4))]
    res = align_pairs_batched(AlignSpec.from_name(spec), blosum62, pairs,
                              GAPO, GAPE, quantum=256, device="cpu")

    def within(parent, name):
        return [s[0] for s in spans if s[0] == name
                and parent[1] <= s[1] and s[2] <= parent[2]]

    routes = ("batch.fill", "batch.tiny")
    scores = [s for s in spans if s[0] == "batch.bucket_scores"]
    stacks = [s for s in spans if s[0] == "batch.stack_bucket"]
    assert [[r for n in routes for r in within(s, n)] for s in scores] == [
        ["batch.fill"], ["batch.tiny"]]
    assert [len(within(s, "batch.copy_back")) for s in scores] == [1, 1]
    assert [len(within(s, "batch.pad_rows")) for s in stacks] == [1, 1]
    assert sum(s[0] in routes + ("batch.pad_rows", "batch.copy_back")
               for s in spans) == 6
    assert res.n_buckets == 2


def test_throughput_streaming_on_cpu(tmp_path, capsys):
    """--stream aligns every record against the first, chunk by chunk."""
    rng = np.random.default_rng(6)
    fasta = tmp_path / "seqs.fa"
    fasta.write_text("".join(
        f">s{k}\n" + "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"),
                                          int(rng.integers(1, 120)))) + "\n"
        for k in range(12)))
    rc = throughput.main([
        "--seqPath", str(fasta),
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--stream", "5", "--algKind", "sw_ag", "--verify", "2",
    ], device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert "11 pairs" in out and "verify ok" in out


def test_synth_pairs_match_jax_benchmark():
    """--synthPairs draws the same pairs as gpuseqalign_tpu's benchmark
    (same seed, same order of draws)."""
    rng = np.random.default_rng(20260817)
    for y, x in throughput.synth_pairs(20, 1, 300, 25):
        r = int(rng.integers(1, 301))
        c = int(rng.integers(1, 301))
        assert len(y) == 1 + r and len(x) == 1 + c
        np.testing.assert_array_equal(y[1:], rng.integers(0, 25, r))
        np.testing.assert_array_equal(x[1:], rng.integers(0, 25, c))


def test_throughput_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        throughput.main([
            "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
            "--substPath", os.path.join(RESRC, "subst.json"),
            "--synthPairs", "4,1,30",
        ])
