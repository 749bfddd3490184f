"""The strip kernel's single-pair entries, K1 (``strip_fill_pair``) and K3
(``strip_fill_dense``), on the host side, and the fact the dense fill's
design rests on.

The kernel runs only on the card. What the CPU can check: a block's
shared memory and warps (``smem_bytes``, ``max_warps``), the dense fill's
scratch (the carry is H's own row, F beside it for affine gaps alone),
and, with a plain-torch model of the dense fill's strip order, that
filling H strip by strip, each strip's top row read back from H and its
F from the carry, gives ``rowscan_dense``'s H and the JAX package's.
Inputs are made with numpy from a seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

from gpuseqalign_tpu.ops import xla_kernels

from gpuseqalign_tpu_torch.core.types import NEG_INF_I32
from gpuseqalign_tpu_torch.ops import dense_cuda, mlsp_cuda, strip_cuda
from gpuseqalign_tpu_torch.ops.dense_plain import rowscan_dense
from gpuseqalign_tpu_torch.ops.mlsp_plain import edge_col, edge_row, row_step

SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]
GAPO, GAPE = -11, -2
S = 25  # blosum62's alphabet, as the card's callers give it


def _kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


@pytest.mark.parametrize("k", strip_cuda.LANE_ROWS)
@pytest.mark.parametrize("S_", [4, 25, 32])
def test_dense_block_fits_its_shared_memory(k, S_):
    """Every strip height has a dense schedule whose staging buffers (32*K
    rows by two 32-column chunks a warp) fit in the 227 KB a block may
    opt in to, and max_warps is the most that do."""
    w = strip_cuda.max_warps(k, S_, True)
    assert 1 <= w <= strip_cuda.MAX_WARPS
    assert strip_cuda.smem_bytes(k, S_, w, True) <= strip_cuda.SMEM_MAX
    if w < strip_cuda.MAX_WARPS:
        assert strip_cuda.smem_bytes(k, S_, w + 1,
                                     True) > strip_cuda.SMEM_MAX
    stage = 4 * 32 * k * 64
    assert (strip_cuda.smem_bytes(k, S_, w, True)
            - strip_cuda.smem_bytes(k, S_, w, False)) == w * stage


@pytest.mark.parametrize("k,warps,dense,bytes_", [
    (4, 1, True, 4 * (4 * 128 + 625 + 128 * 64)),
    (4, 4, True, 4 * (4 * 128 + 625 + 4 * 128 * 64)),
    (8, 3, True, 4 * (4 * 128 + 625 + 3 * 256 * 64)),
    (1, 4, True, 4 * (4 * 128 + 625 + 4 * 32 * 64)),
    (4, 4, False, 4 * (4 * 128 + 625)),
    (8, 1, False, 4 * (4 * 128 + 625)),
])
def test_smem_bytes_counts_the_kernels_layout(k, warps, dense, bytes_):
    """Four letter rings (a block's most warps: the matrix at a fixed
    offset), the matrix and, dense, the staging buffers."""
    assert strip_cuda.smem_bytes(k, S, warps, dense) == bytes_


@pytest.mark.parametrize("k,top", [(1, 4), (2, 4), (4, 4), (8, 3)])
def test_dense_warps_a_block_by_strip_height(k, top):
    """Strips of 256 rows fit 3 warps a block, shorter ones the most a
    block takes, 4."""
    assert strip_cuda.max_warps(k, S, True) == top
    assert strip_cuda.max_warps(k, S, False) == strip_cuda.MAX_WARPS


def test_default_schedules_fit():
    """K3's default schedule fits a block; K1's (and every sparse
    schedule's) stays under the 48 KB a block has without opting in."""
    assert dense_cuda.WARPS <= strip_cuda.max_warps(dense_cuda.LANE_ROWS, S,
                                                     True)
    for k in strip_cuda.LANE_ROWS:
        assert strip_cuda.smem_bytes(
            k, S, strip_cuda.MAX_WARPS, False) <= 48 * 1024


@pytest.mark.parametrize("ns,cols,affine,words", [
    (1, 1, False, 0), (1, 1, True, 2), (186, 23728, False, 0),
    (186, 23728, True, 186 * 23729), (7, 99, True, 700),
])
def test_dense_carry_is_h_itself_and_f_for_affine_gaps(ns, cols, affine,
                                                       words):
    assert strip_cuda.dense_scratch_words(ns, cols, affine) == (1 + ns,
                                                                words)
    prog, carry = strip_cuda.alloc_dense_scratch(ns, cols, affine,
                                                 torch.device("cpu"))
    assert prog.tolist() == [0] * (1 + ns)
    assert (carry is None) == (words == 0)
    if carry is not None:
        assert carry.dtype == torch.int32 and carry.numel() == words


def _strip_model(subst, y, x, gapo, gape, sh, kind, gap):
    """The dense fill's order in plain torch: H's edge first, then strip
    after strip of ``sh`` rows over the live cells, each strip's top row
    read back from H (its row r0, the strip above's bottom row) and its F
    from the carry row of the strip above; the rows below a strip are
    still unwritten when it runs."""
    adjr, adjc = y.numel(), x.numel()
    dev = y.device
    H = torch.full((adjr, adjc), 123456789, dtype=torch.int32)
    H[0] = edge_row(adjc, gapo, gape, kind, gap, dev)
    H[1:, 0] = edge_col(torch.arange(1, adjr, dtype=torch.int32), gapo, gape,
                        kind, gap)
    offs = torch.arange(adjc, dtype=torch.int32)
    sx = subst[:, x.long()]
    col0 = H[:, 0].clone()
    ns = strip_cuda.n_strips(adjr - 1, sh)
    _, n_carry = strip_cuda.dense_scratch_words(ns, adjc - 1,
                                                gap == "affine")
    carry = torch.full((n_carry,), 7, dtype=torch.int32).view(-1, adjc)
    for s in range(ns):
        r0 = s * sh
        assert bool((H[r0 + 1:, 1:] == 123456789).all())
        hprev = H[r0].clone()
        fprev = (carry[s - 1].clone() if s and gap == "affine" else
                 torch.full((adjc,), NEG_INF_I32, dtype=torch.int32))
        for i in range(r0 + 1, min(r0 + sh, adjr - 1) + 1):
            hprev, fprev, _ = row_step(
                hprev, fprev, sx[y[i].long()], col0[i:i + 1], gapo, gape,
                offs * gapo, offs * gape, kind=kind, gap=gap)
            H[i] = hprev
        if gap == "affine":
            carry[s] = fprev
    return H


@pytest.fixture(scope="module")
def jax_dense(blosum62):
    """The JAX package's dense fill (the XLA row scan of its CPU route) of
    one 256 x 256 pair a spec: every window below is a prefix of it."""
    rng = np.random.default_rng(88)
    y = np.concatenate([[0], rng.integers(0, 24, 256)]).astype(np.int32)
    x = np.concatenate([[0], rng.integers(0, 24, 256)]).astype(np.int32)
    out = {spec: np.asarray(xla_kernels.rowscan_dense(
        blosum62, y, x, np.int32(GAPO), np.int32(GAPE), **_kind_gap(spec)))
        for spec in SPECS}
    return y, x, out


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("rows,cols,sh", [
    (200, 100, 32),   # 7 strips, the last of 8 rows
    (77, 120, 64),    # a ragged second strip
    (130, 200, 128),  # 2 strips, the last of 2 rows
    (255, 60, 32),    # 8 strips, the last of 31 rows
    (1, 90, 32),      # one row
    (64, 1, 32),      # one column
])
def test_dense_strip_order_gives_rowscan_h(blosum62, jax_dense, spec, rows,
                                           cols, sh):
    y, x, want = jax_dense
    yt = torch.from_numpy(y[:rows + 1])
    xt = torch.from_numpy(x[:cols + 1])
    subst = torch.from_numpy(blosum62)
    kw = _kind_gap(spec)
    got = _strip_model(subst, yt, xt, GAPO, GAPE, sh, **kw)
    assert torch.equal(got, rowscan_dense(subst, yt, xt, GAPO, GAPE, **kw))
    np.testing.assert_array_equal(got.numpy(),
                                  want[spec][:rows + 1, :cols + 1])


def test_cpu_wrappers_ignore_the_schedule_and_launch_nothing(blosum62):
    """On the CPU, K3's schedule hooks change nothing (the plain version
    runs) and neither single-pair wrapper counts a launch."""
    rng = np.random.default_rng(9)
    y = torch.from_numpy(np.concatenate([[0], rng.integers(0, 24, 70), [0]])
                         .astype(np.int32))
    x = torch.from_numpy(np.concatenate([[0], rng.integers(0, 24, 45)])
                         .astype(np.int32))
    subst = torch.from_numpy(blosum62)
    before = (mlsp_cuda.LAUNCHES, dense_cuda.LAUNCHES)
    want = rowscan_dense(subst, y[:71], x, GAPO, GAPE, kind="sw",
                         gap="affine")
    for k, w in ((8, 3), (1, 1), (None, None)):
        got = dense_cuda.dense_fill(subst, y, x, GAPO, GAPE, 71, 46,
                                    kind="sw", gap="affine", _lane_rows=k,
                                    _warps=w)
        assert torch.equal(got, want)
    assert (mlsp_cuda.LAUNCHES, dense_cuda.LAUNCHES) == before
