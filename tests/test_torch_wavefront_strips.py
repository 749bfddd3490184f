"""The row-strip wavefront fills' host side and a model of their order.

The strip kernel of K2 and K4 (``ops/csrc/wavefront.cu``) runs only on the
card; ``chip_smoke.py`` phase 2 holds it there against the plain fills, bit
for bit. What the CPU checks: the scratch its wrappers size and zero on
the host (``wavefront_cuda.scratch``), that the constants the host and
this file mirror match the kernel's source, and that the kernel's order of
work gives the plain fills' outputs. That order is restated here, in
``ticket_order``, ``bottom_row``, ``top_row`` and ``swept_steps``, from the
kernel's indexing (strip g is strip g % per_block of block g / per_block;
the carry pointers; the sweep of T32 steps): these functions model the
kernel, they do not run it, so a change to the kernel's order shows here
only when they are changed with it. A plain-torch model sweeps strips of
SH rows over their swept steps only, in ticket order, each taking its top
row from the carry (``hrow[b-1]`` at a block boundary, the strip's carry
row inside a block), and writes every output element once. Inputs are
made with numpy from a seed; every comparison is exact. No Pallas kernel
runs.
"""

import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.models.oracle import oracle_align_dense
from gpuseqalign_tpu.core.types import AlignSpec as JaxSpec

from gpuseqalign_tpu_torch.core.types import NEG_INF_I32
from gpuseqalign_tpu_torch.ops import wavefront, wavefront_cuda as wc
from gpuseqalign_tpu_torch.ops.wavefront_plain import (
    dense_nw_lg_plain,
    mlsp_nw_lg_plain,
)
from test_torch_wavefront import _expected

SRC = os.path.join(os.path.dirname(wc.__file__), "csrc", "wavefront.cu")
# A value no fill produces: scratch starts with it, so a read of an
# element the kernel never stores shows.
POISON = 777_777_777


def _seq(rng, n, pad_to):
    s = np.zeros(1 + pad_to, np.int32)
    s[1:n + 1] = rng.integers(0, 25, n)
    return s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# The kernel's constants this file mirrors (checked against the source).
SH = wc.STRIP_ROWS  # rows a strip, one warp
LANE_ROWS = SH // 32  # rows a lane (kLaneRows)
CHUNK = 32  # columns between two progress stores, and of a carry chunk


def ticket_order(blocks, R):
    """(block, strip of the block) of each ticket, in ticket order: the
    kernel's strip g is strip g % per_block of block g // per_block."""
    return [divmod(g, R // SH) for g in range(blocks * R // SH)]


def bottom_row(R, b, s):
    """Where strip s of block b stores its bottom row: ("hrow", b) for the
    last strip of the block, else ("carry", row of the carry scratch)."""
    per_block = R // SH
    if s == per_block - 1:
        return "hrow", b
    return "carry", b * (per_block - 1) + s


def top_row(R, b, s):
    """Where strip s of block b reads its top row: ("edge", 0) for the
    fill's first strip (H[0, j] = j*gapo), else the bottom row of the
    strip above."""
    if b == 0 and s == 0:
        return "edge", 0
    return bottom_row(R, *divmod(b * (R // SH) + s - 1, R // SH))


def swept_steps(s, cols_p):
    """The block-local steps that strip s sweeps: its live steps s*SH ..
    s*SH + SH + cols_p - 2, rounded up to whole chunks (the kernel's
    T32)."""
    q0 = s * SH
    return range(q0, q0 + -(-(SH + cols_p - 1) // CHUNK) * CHUNK)


def test_strip_rows_cut_every_row_block():
    """For every R the wrappers take, strips of SH rows cut R and give a
    warp 32*K rows; the scratch holds the ticket and a counter a strip,
    zeroed, and a carry row for each strip but the last of its block."""
    for R in range(128, wc.MAX_R + 1, 128):
        assert R % SH == 0 and SH == 32 * LANE_ROWS, R
        prog, carry = wc.scratch(3, R, 64, torch.device("cpu"))
        per_block = R // SH
        assert prog.dtype == torch.int32 and not prog.any()
        assert tuple(prog.shape) == (1 + 3 * per_block,)
        if per_block == 1:
            assert carry is None
        else:
            assert tuple(carry.shape) == (3 * (per_block - 1), 65)
            assert carry.dtype == torch.int32


@pytest.mark.parametrize("blocks,R", [
    (1, 128), (5, 128), (2, 256), (3, 256), (2, 1024), (4, 1024),
    (1, 4096), (2, 4096),
])
def test_ticket_order_and_carry_rows(blocks, R):
    """Each strip reads its top row from the row that the strip of the
    ticket before it stores (across block boundaries too), the first from
    the edge; every carry row is stored by one strip; the scratch is the
    size the kernel indexes."""
    order = ticket_order(blocks, R)
    per_block = R // SH
    assert order == [(b, s) for b in range(blocks) for s in range(per_block)]
    stored = []
    for g, (b, s) in enumerate(order):
        top = top_row(R, b, s)
        if g == 0:
            assert top == ("edge", 0)
        else:
            assert top == bottom_row(R, *order[g - 1])
            if s == 0:
                assert top == ("hrow", b - 1)
        stored.append(bottom_row(R, b, s))
    n_carry = blocks * (per_block - 1)
    assert sorted(i for k, i in stored if k == "hrow") == list(range(blocks))
    assert sorted(i for k, i in stored if k == "carry") == list(range(n_carry))
    prog, carry = wc.scratch(blocks, R, 512, torch.device("cpu"))
    assert prog.tolist() == [0] * (1 + len(order))
    if R == SH:  # K2 on its path: the carry is hrow itself
        assert n_carry == 0 and carry is None
    else:
        assert tuple(carry.shape) == (n_carry, 513)


@pytest.mark.parametrize("R,cols_p,W", [
    (128, 128, 128), (128, 23808, 512), (1024, 23808, 256), (256, 1, 128),
    (4096, 640, 512),
])
def test_swept_steps_cover_live_steps(R, cols_p, W):
    """A strip sweeps its live steps s*SH .. s*SH + SH + cols_p - 2 in whole
    chunks, within the block's padded steps, with room for the kernel's
    profile prefetch (at most 16 steps past the sweep)."""
    nspad = wc.nspad_of(R, cols_p, W)
    for s in range(R // SH):
        steps = swept_steps(s, cols_p)
        assert steps.start == s * SH and len(steps) % CHUNK == 0
        assert len(steps) - CHUNK < SH + cols_p - 1 <= len(steps)
        assert steps.stop + 16 <= nspad


def test_host_constants_match_the_kernel_source():
    """The constants the host and this file mirror are the kernel's own:
    the chunk and the rows a lane (one instance, strips of STRIP_ROWS); no
    shared memory (the flows report none) and no block barrier."""
    with open(SRC) as f:
        src = f.read()
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert f"constexpr int kLaneRows = {LANE_ROWS};" in src
    assert "constexpr int kStrip = 32 * kLaneRows;" in src
    assert "__shared__" not in src and "__syncthreads" not in src


def strip_model(pskew, gapo, cols_p, W, TW):
    """The kernel's order of work in plain numpy: strips in ticket order,
    each swept over ``swept_steps`` with its SH rows as one vector, its
    top row read from the carry (the edge for the first strip), its bottom
    row stored for the strip below, then the rest of its rows' elements
    set off the sweep. Returns (hrow, hcol, vhist) as int32 tensors in the
    plain layouts and how often each element of each was written."""
    B, nspad, sub, lanes = pskew.shape
    R = sub * lanes
    P = pskew.numpy().reshape(B, nspad, R).astype(np.int64)
    ct = -(-(nspad // W) // (TW // W))
    k_past = cols_p // TW + 1
    hrow = np.full((B, nspad + 128), POISON, np.int64)
    hcol = np.full((B, ct, R), POISON, np.int64)
    vhist = np.full((B, nspad, R), POISON, np.int64)
    carry = np.full((max(B * (R // SH - 1), 1), cols_p + 1), POISON,
                    np.int64)
    n_hrow, n_hcol, n_vhist = (np.zeros(t.shape, np.int64) for t in
                               (hrow, hcol, vhist))
    rows = {"hrow": hrow, "carry": carry}
    r = np.arange(SH)
    for b, s in ticket_order(B, R):
        q0 = s * SH
        kind, idx = top_row(R, b, s)
        top = (np.arange(cols_p + 1) * gapo if kind == "edge"
               else rows[kind][idx, :cols_p + 1].copy())
        kind, idx = bottom_row(R, b, s)
        bot = rows[kind][idx]
        i = b * R + q0 + r + 1
        v1, dg = i * gapo, (i - 1) * gapo
        sl = slice(q0, q0 + SH)
        steps = swept_steps(s, cols_p)
        up = np.empty(SH, np.int64)
        for c in steps:
            t = c - q0
            j = t - r + 1
            up[0] = top[t + 1] if t + 1 <= cols_p else 0
            up[1:] = v1[:-1]
            h = np.maximum(dg + P[b, c, sl], np.maximum(up, v1) + gapo)
            h = np.where(j <= 0, i * gapo, h)
            dg, v1 = up.copy(), h
            live = (j >= 1) & (j <= cols_p)
            vhist[b, c, sl] = np.where(live, h, NEG_INF_I32)
            n_vhist[b, c, sl] += 1
            on = live & (j % TW == 0)
            if on.any():
                hcol[b, j[on] // TW, q0 + r[on]] = h[on]
                n_hcol[b, j[on] // TW, q0 + r[on]] += 1
            jb = t - SH + 2
            if 1 <= jb <= cols_p:
                bot[jb] = h[-1]
                if kind == "hrow":
                    n_hrow[b, jb] += 1
        # Off the sweep: the rest of this strip's rows.
        for k in [0] + list(range(k_past, ct)):
            hcol[b, k, sl] = NEG_INF_I32
            n_hcol[b, k, sl] += 1
        off = [c for c in range(nspad) if c not in steps]
        vhist[b, off, sl] = NEG_INF_I32
        n_vhist[b, off, sl] += 1
        if kind == "hrow":
            hrow[b, 0] = (b + 1) * R * gapo
            hrow[b, cols_p + 1:] = NEG_INF_I32
            n_hrow[b, 0] += 1
            n_hrow[b, cols_p + 1:] += 1

    def t32(a, shape):
        return torch.from_numpy(a.astype(np.int32).reshape(shape))

    return ((t32(hrow, hrow.shape), t32(hcol, (B, ct, sub, lanes)),
             t32(vhist, pskew.shape)), (n_hrow, n_hcol, n_vhist))


# rows, cols (residues, zero-padded as the host flows pad them), R, TW, W,
# gapo.
MODEL_CASES = [
    (300, 700, 128, 128, 128, -11),    # SH = R = 128, TW = R
    (256, 1000, 128, 512, 512, -1),    # TW = 4R
    (600, 520, 256, 256, 256, 0),      # two strips a block
    (500, 1024, 256, 1024, 256, -11),  # two strips a block, TW = 4R
    (256, 512, 256, 256, 128, -1),     # one block of two strips
    (2048, 300, 1024, 1024, 256, -11),  # R 1024: 8 strips a block
    (1024, 900, 1024, 1024, 512, 0),   # R 1024, W 512, one block
    (1, 600, 128, 128, 128, -1),       # a one-row pair
    (1, 1, 128, 128, 128, -11),        # 1 x 1
]


@pytest.mark.parametrize("rows,cols,R,TW,W,gapo", MODEL_CASES)
def test_strip_order_gives_the_plain_fills(blosum62, rows, cols, R, TW, W,
                                           gapo):
    rng = np.random.default_rng(7 * rows + cols - gapo)
    rows_p, cols_p = -(-rows // R) * R, -(-cols // TW) * TW
    y, x = _seq(rng, rows, rows_p), _seq(rng, cols, cols_p)
    B, nspad = rows_p // R, wc.nspad_of(R, cols_p, W)
    pskew = wavefront._build_pskew(_t(blosum62), _t(y), _t(x), B, R, nspad)
    (hrow, hcol, vhist), counts = strip_model(pskew, gapo, cols_p, W, TW)
    for n in counts:  # every element written once
        assert (n == 1).all()
    want_h, want_c = mlsp_nw_lg_plain(pskew, gapo, cols_p=cols_p, W=W,
                                      TW=TW)
    assert torch.equal(hrow, want_h) and torch.equal(hcol, want_c)
    assert torch.equal(vhist, dense_nw_lg_plain(pskew, gapo, cols_p=cols_p))
    H = oracle_align_dense(JaxSpec.from_name("nw_lg"), blosum62, y, x,
                           gapo)["H"]
    for got, want in zip((hrow, hcol, vhist),
                         _expected(H, R, TW, W, nspad, cols_p)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gapo", [0, -1, -11])
def test_cpu_wrappers_launch_nothing(blosum62, gapo):
    """On a CPU tensor each wrapper returns its plain version's outputs
    and counts no launch; a tile width below R raises on the CPU too."""
    rng = np.random.default_rng(11 - gapo)
    R, W, TW, cols_p = 256, 256, 256, 512
    y, x = _seq(rng, 400, 512), _seq(rng, 500, cols_p)
    pskew = wavefront._build_pskew(_t(blosum62), _t(y), _t(x), 2, R,
                                   wc.nspad_of(R, cols_p, W))
    before = dict(wc.LAUNCHES)
    got = wc.mlsp_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W, TW=TW)
    want = mlsp_nw_lg_plain(pskew, gapo, cols_p=cols_p, W=W, TW=TW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = wc.dense_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W)
    assert torch.equal(got, dense_nw_lg_plain(pskew, gapo, cols_p=cols_p))
    assert wc.LAUNCHES == before
    with pytest.raises(ValueError):
        wc.mlsp_nw_lg_fill(pskew, gapo, cols_p=cols_p, W=W, TW=128)
