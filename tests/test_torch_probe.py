"""The port's step-body probes (K8a–d) and its headline bench, on the CPU.

The plain versions of the probe kernels (``ops/probe_plain.py``, what the
wrappers of ``ops/probe_cuda.py`` return for CPU tensors) are held bit for
bit against gpuseqalign_tpu: the elementwise chains against a
``jax.lax.fori_loop`` of the JAX probe's own body expressions
(``bench/vpu_probe.py``, written out here: they are local lambdas there),
and the DP strips against ``models/oracle.oracle_align_dense`` on a pair of
the strip's size, at every strip height the kernels take (32·R rows, R
rows a lane) and at one and two strips (warps) a block. Inputs are made
with numpy from a seed. No Pallas kernel is compiled and nothing runs in
interpret mode.
"""

import io
import json
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuseqalign_tpu.core import types as jax_types
from gpuseqalign_tpu.models import cpu_algs as jax_cpu_algs
from gpuseqalign_tpu.models.oracle import oracle_align_dense

from gpuseqalign_tpu_torch.bench import headline, vpu_probe
from gpuseqalign_tpu_torch.ops import probe_cuda
from gpuseqalign_tpu_torch.ops.probe_plain import (
    CHAIN_BODIES,
    INT16_MODES,
    VARIANTS,
    fullstep_plain,
)

GAPO, GAPE = -11, -2
SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
# Rows a strip: 32·R for R rows a lane.
STRIP_ROWS = [32, 64, 128, 256]


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v, np.int32))


def _jax_chains(a, body, nch, iters, dtype):
    """The JAX probe's _chain_kernel recipe without Pallas: chain k starts
    at a + k, ``iters`` iterations of ``body``, the max over chains."""
    a = jnp.asarray(a, dtype)
    carry = tuple(a + jnp.asarray(k, dtype) for k in range(nch))
    vs = jax.lax.fori_loop(0, iters, lambda i, c: tuple(body(a, s) for s in c),
                           carry)
    out = vs[0]
    for v in vs[1:]:
        out = jnp.maximum(out, v)
    return np.asarray(out)


# vpu_probe.py:100-102 (probe_ops) and :1005-1021 (probe_int16).
JAX_BODIES = {
    "maxadd2": lambda a, st: jnp.maximum(st + a, a + 7),
    "select": lambda a, st: jnp.where(a > 0, st, a),
    "shift_add2": lambda a, st: (st >> 2) + a,
}


@pytest.mark.parametrize("iters", [0, 1, 9])
@pytest.mark.parametrize("body", ["maxadd2", "viaddmax", "select",
                                  "shift_add2"])
def test_chain_bodies_match_jax(body, iters):
    rng = np.random.default_rng(11)
    a = rng.integers(-3, 4, (2, 64)).astype(np.int32)
    got = probe_cuda.probe_chain(_t(a), body, 12, iters)
    want = _jax_chains(a, JAX_BODIES.get(body, JAX_BODIES["maxadd2"]), 12,
                       iters, jnp.int32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nch", [1, 12])
@pytest.mark.parametrize("body", ["shfl", "xwarp"])
def test_rotations_move_chains_by_a_lane_or_a_warp(body, nch):
    nt, iters = 96, 7
    a = np.arange(2 * nt, dtype=np.int32).reshape(2, nt)
    got = probe_cuda.probe_chain(_t(a), body, nch, iters).numpy()
    t = np.arange(nt)
    if body == "shfl":
        src = (t // 32) * 32 + (t % 32 + iters) % 32
    else:
        src = (t + 32 * iters) % nt
    np.testing.assert_array_equal(got, a[:, src] + nch - 1)


@pytest.mark.parametrize("iters", [1, 5, 40])
@pytest.mark.parametrize("mode", INT16_MODES)
def test_int16_chains_match_jax(mode, iters):
    rng = np.random.default_rng(12)
    if mode == "i32":
        a = rng.integers(-3, 4, (2, 64)).astype(np.int32)
        lanes, dtype = a, jnp.int32
    else:
        # Whole words: the halfword chains wrap within a few iterations.
        a = rng.integers(-2 ** 31, 2 ** 31, (2, 64)).astype(np.int32)
        lanes, dtype = a.view(np.int16), jnp.int16
    got = probe_cuda.probe_int16(_t(a), mode, iters)
    want = _jax_chains(lanes, JAX_BODIES["maxadd2"], 12, iters, dtype)
    np.testing.assert_array_equal(got.numpy().view(want.dtype), want)


def _oracle_strip(subst, y_row, x_row, spec, gape):
    """oracle_align_dense on the strip's pair: rows y_row, columns x_row
    (header element included)."""
    seq_y = np.concatenate([[0], y_row]).astype(np.int32)
    return oracle_align_dense(jax_types.AlignSpec.from_name(spec), subst,
                              seq_y, np.asarray(x_row, np.int32), GAPO,
                              gape)


@pytest.mark.parametrize("nt", STRIP_ROWS)
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("spec", ["nw_lg", "nw_ag"])
def test_skeleton_strips_match_oracle(spec, K, nt):
    iters, c = 23, 3
    gape = GAPE if spec == "nw_ag" else 0
    a = np.full((2, nt), c, np.int32)
    got = probe_cuda.probe_chain(_t(a), f"skeleton_{spec}", K, iters, GAPO,
                                 gape).numpy()
    want = None
    for k in range(K):
        subst = np.full((25, 25), c + k, np.int32)
        H = _oracle_strip(subst, np.zeros(nt), np.zeros(iters + 1), spec,
                          gape)["H"]
        want = H[1:, iters] if want is None else np.maximum(want, H[1:, iters])
    np.testing.assert_array_equal(got, np.tile(want, (2, 1)))


def _strip_case(K, nt, iters, seed=13):
    return vpu_probe.strip_inputs(2, K, nt, iters, torch.device("cpu"),
                                  f"test{seed}")


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("variant,nt", [
    (v, nt) for v in ("base", "noheader", "sw") for nt in STRIP_ROWS]
    + [("onewarp", 32)])
@pytest.mark.parametrize("gap", ["linear", "affine"])
def test_fullstep_strips_match_oracle(gap, variant, nt, K):
    iters = 19
    subst, y, x, a = _strip_case(K, nt, iters)
    gape = GAPE if gap == "affine" else 0
    got = probe_cuda.probe_fullstep(subst, y, x, a, GAPO, gape, gap=gap,
                                    variant=variant)
    spec = ("sw" if variant == "sw" else "nw") + (
        "_ag" if gap == "affine" else "_lg")
    want = {"hcol": [], "ecol": [], "hrow": [], "frow": [], "best": []}
    for b in range(2):
        for k in range(K):
            m = _oracle_strip(subst.numpy(), y[b, k].numpy(), x[k].numpy(),
                              spec, gape)
            H = m["H"]
            want["hcol"].append(H[1:, iters])
            want["hrow"].append(H[nt, 1:])
            if gap == "affine":
                want["ecol"].append(m["E"][1:, iters])
                want["frow"].append(m["F"][nt, 1:])
            if variant == "sw":
                v = H[1:, 1:].max(1)
                j = H[1:, 1:].argmax(1) + 1
                i = np.arange(1, nt + 1)
                hit = v > 0
                want["best"].append(np.stack([v, i * hit, j * hit], -1))
    keys = {"hcol", "hrow"} | ({"ecol", "frow"} if gap == "affine" else set())
    if variant == "noheader":
        keys -= {"hrow", "frow"}
    if variant == "sw":
        keys |= {"best"}
    assert set(got) == keys
    for key in keys:
        np.testing.assert_array_equal(
            got[key].numpy().reshape(2 * K, *got[key].shape[2:]),
            np.stack(want[key]), err_msg=key)


@pytest.mark.parametrize("nt", STRIP_ROWS)
@pytest.mark.parametrize("gap", ["linear", "affine"])
def test_fullstep_nolookup_is_the_skeleton_with_headers(gap, nt):
    K, iters = 2, 17
    subst, y, x, a = _strip_case(K, nt, iters)
    gape = GAPE if gap == "affine" else 0
    got = probe_cuda.probe_fullstep(subst, y, x, a, GAPO, gape, gap=gap,
                                    variant="nolookup")
    body = "skeleton_nw_ag" if gap == "affine" else "skeleton_nw_lg"
    skel = probe_cuda.probe_chain(a, body, K, iters, GAPO, gape)
    torch.testing.assert_close(got["hcol"].amax(1), skel, rtol=0, atol=0)


def test_plain_fullstep_rejects_unknown_variant():
    subst, y, x, a = _strip_case(1, 32, 4)
    with pytest.raises(ValueError, match="variant"):
        fullstep_plain(subst, y, x, a, GAPO, 0, gap="linear", variant="lean")


def _launch_counts():
    return dict(probe_cuda.LAUNCHES)


def test_wrappers_launch_nothing_on_cpu_tensors():
    before = _launch_counts()
    a = _t(np.ones((1, 32)))
    for body in CHAIN_BODIES:
        probe_cuda.probe_chain(a, body, 1, 2)
    for mode in INT16_MODES:
        probe_cuda.probe_int16(a, mode, 2)
    subst, y, x, a2 = _strip_case(1, 32, 3)
    for gap in ("linear", "affine"):
        for variant in VARIANTS:
            probe_cuda.probe_fullstep(subst, y, x, a2, GAPO, GAPE, gap=gap,
                                      variant=variant)
    assert _launch_counts() == before


@pytest.mark.parametrize("bad", [
    dict(body="maxadd2", nch=3),            # no such chain count
    dict(body="skeleton_nw_lg", nch=12),    # no such strip count
    dict(body="roll_lane", nch=1),          # a TPU body
    dict(body="maxadd2", nch=1, nt=48),     # not whole warps
    dict(body="maxadd2", nch=1, nt=512),    # above the block limit
    dict(body="maxadd2", nch=1, dtype=np.int64),
    dict(body="skeleton_nw_ag", nch=1, iters=0),
    dict(body="skeleton_nw_lg", nch=2, nt=96),  # not 32·R rows, R = 2^n
])
def test_probe_chain_rejects_bad_arguments(bad):
    a = np.ones((1, bad.get("nt", 64)), bad.get("dtype", np.int32))
    with pytest.raises((ValueError, TypeError)):
        probe_cuda.probe_chain(torch.from_numpy(a), bad["body"], bad["nch"],
                               bad.get("iters", 3))


@pytest.mark.parametrize("bad", ["onewarp_wide", "K3", "a_shape", "x_rows"])
def test_probe_fullstep_rejects_bad_arguments(bad):
    K = 3 if bad == "K3" else 2
    subst, y, x, a = _strip_case(K, 64, 5)
    variant = "onewarp" if bad == "onewarp_wide" else "base"
    if bad == "a_shape":
        a = a[:, :32].contiguous()
    if bad == "x_rows":
        x = x[:1].contiguous()
    with pytest.raises(ValueError):
        probe_cuda.probe_fullstep(subst, y, x, a, GAPO, 0, variant=variant)


@pytest.mark.parametrize("bad", [
    dict(nt=48), dict(nt=96), dict(nt=160), dict(nt=512),  # not 32·R
    dict(K=3), dict(K=5), dict(K=16),                      # not in STRIP_K
    dict(nt=64, variant="onewarp"),
])
def test_probe_fullstep_rejects_strip_shapes_before_any_launch(bad,
                                                               monkeypatch):
    """A strip height outside 32·R (R in 1, 2, 4, 8) or a strip count
    outside STRIP_K raises on the CPU before the plain version (what a CPU
    tensor would run) or a kernel is reached."""
    def reached(*args, **kwargs):
        raise AssertionError("the strip's shape was not checked first")

    monkeypatch.setattr(probe_cuda, "fullstep_plain", reached)
    before = _launch_counts()
    subst, y, x, a = _strip_case(bad.get("K", 1), bad.get("nt", 32), 5)
    for gap in ("linear", "affine"):
        with pytest.raises(ValueError, match="strip"):
            probe_cuda.probe_fullstep(subst, y, x, a, GAPO, GAPE, gap=gap,
                                      variant=bad.get("variant", "base"))
    assert _launch_counts() == before
    assert probe_cuda.STRIP_ROWS == (32, 64, 128, 256)


def _run_main(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(argv, device="cpu") == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_vpu_probe_main_prints_one_object_per_probe():
    lines = _run_main(vpu_probe.main, ["all"])
    assert [d["probe"] for d in lines] == [
        "ops", "skeleton_nw_lg", "skeleton_nw_ag", "fullstep_nw_lg",
        "fullstep_nw_ag", "int16", "roofline_nw_lg", "roofline_sw_lg",
        "roofline_nw_ag", "roofline_sw_ag"]
    for d in lines:
        assert d["device"] == "cpu" and d["card"] == "cpu"
        assert "power_limit" in d
    ops = lines[0]
    assert set(ops) >= set(vpu_probe.BODY_INSNS)
    assert ops["maxadd2"]["peak_share"] is None  # no card bound on the CPU
    assert set(lines[3]) >= set(VARIANTS)
    assert set(lines[5]) >= set(INT16_MODES)
    assert lines[8]["variant"] == "base" and lines[9]["variant"] == "sw"


def test_roofline_body_reports_rows_a_lane_and_warps_a_block():
    """roofline_body sweeps the rows a lane R and the strips (warps) a
    block K, and returns the winner's R, K, rows and warps a SM (None on
    the CPU, which has no SMs); the main's roofline lines carry them."""
    r = vpu_probe.roofline_body("nw", "affine", device="cpu")
    cpu = vpu_probe.CPU
    assert r["spec"] == "nw_ag" and r["variant"] == "base"
    assert r["rows"] == 32 * r["R"] and r["rows"] in cpu.roofline_rows
    assert r["K"] in cpu.fullstep_ks and r["threads"] == 32 * r["K"]
    assert "warps_per_sm" in r and r["warps_per_sm"] is None
    assert set(r["sweep"]) == {f"R{nt // 32}_K{k}_b0"
                               for nt in cpu.roofline_rows
                               for k in cpu.fullstep_ks}
    assert r["gcups"] == max(r["sweep"].values())
    lines = _run_main(vpu_probe.main, ["roofline", "--K", "1"])
    assert [d["probe"] for d in lines] == [
        "roofline_nw_lg", "roofline_sw_lg", "roofline_nw_ag",
        "roofline_sw_ag"]
    for d in lines:
        assert d["K"] == 1 and d["rows"] == 32 * d["R"]
        assert d["rows"] in cpu.roofline_rows and "warps_per_sm" in d
        assert set(d["sweep"]) == {f"R{nt // 32}_K1_b0"
                                   for nt in cpu.roofline_rows}


def test_hot_loop_is_the_largest_innermost_loop():
    """sass_summary's hot loop: of the loops (backward branches), those
    that hold no other loop, the largest; its opcodes counted; no loop,
    no hot loop."""
    insns = [(0x00, "LDS", None), (0x10, "VIADD", None),
             (0x20, "VIMNMX", None), (0x30, "BRA", 0x10),      # inner A
             (0x40, "SHFL", None), (0x50, "VIADD", None),
             (0x60, "VIADD", None), (0x70, "LDS", None),
             (0x80, "BRA", 0x50),                              # inner B
             (0x90, "BRA", 0x00),                              # outer
             (0xa0, "BRA", 0xc0), (0xb0, "STG", None),         # forward
             (0xc0, "EXIT", None)]
    assert vpu_probe._hot_loop(insns) == {
        "insns": 4, "opcodes": {"VIADD": 2, "LDS": 1, "BRA": 1}}
    assert vpu_probe._hot_loop(insns[:3] + insns[10:]) == {}


def test_gridcost_needs_the_card():
    with pytest.raises(ValueError, match="card"):
        vpu_probe.probe_gridcost(64, device="cpu")


def test_headline_prints_one_line_and_its_cost_is_the_oracles(seq_data,
                                                              blosum62):
    (out,) = _run_main(headline.main, ["--n", "300", "--oracleN", "64"])
    assert set(out) >= {"metric", "value", "unit", "vs_baseline",
                        "body_gcups", "body_variant", "mfu", "peak_share",
                        "insns_per_cell", "card", "power_limit"}
    assert out["unit"] == "GCUPS" and out["card"] == "cpu"
    assert re.fullmatch(r"base R[1248] K\d", out["body_variant"])
    assert out["insns_per_cell"] == vpu_probe.INSNS_PER_CELL["nw_ag"] == 6
    # Host-clock rates of the plain versions: numbers, whose sign a busy
    # host may flip for the two-point body rate; the cost is what counts.
    assert out["value"] > 0 and isinstance(out["body_gcups"], float)
    assert out["peak_share"] is None
    seq = seq_data.seq_map["len23728"].seq[:65]
    nw = jax_types.AlgInput()
    nw.subst, nw.substsz = blosum62, blosum62.shape[0]
    nw.seqY = nw.seqX = seq
    nw.adjrows = nw.adjcols = len(seq)
    nw.gapo_cost, nw.gape_cost = GAPO, GAPE
    nw.spec = jax_types.AlignSpec.from_name("nw_ag")
    res = jax_types.AlgResult()
    assert jax_cpu_algs.align_cpu1_st_row(jax_types.AlgParams({}), nw, res) \
        == jax_types.Status.success
    assert out["cost"] == res.align_cost


def test_headline_rejects_a_gate_longer_than_the_pair():
    with pytest.raises(SystemExit):
        headline.main(["--n", "50", "--oracleN", "64"], device="cpu")


def test_bodyoff_fill_runs_on_the_card_only():
    from gpuseqalign_tpu_torch.ops.mlsp_cuda import mlsp_fill

    z = torch.zeros(129, dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        mlsp_fill(torch.zeros((2, 2), dtype=torch.int32), z, z, GAPO, 0, 2,
                  2, tile_h=128, tile_w=128, kind="nw", gap="linear",
                  _bodyoff=True)
