"""The single-pair flow's hand-off of K1's tile headers, on the card.

``ops/mlsp_kernels.py::align_mlsp`` lays the fill's headers out tile-major
where the fill left them and, from the card, brings them to the host in
one copy into pinned memory. On a release-sized pair (23728 x 23728) and
every spec, one align through the registry on the card: the headers' host
arrays lie in pinned memory, ``PINNED_COPIES`` grows by one, and the
matrices equal those of the same align on the CPU (the plain fill and the
same layout code); a second align on the card, with no reset between,
leaves the first input's headers as they were.

The tests skip where there is no CUDA card. This file imports no JAX; on
a machine with a card, run it without the suite's conftest, which loads
JAX:

    python -m pytest --noconftest -q tests/test_torch_mlsp_card.py
"""

import os

import numpy as np
import pytest
import torch

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (AlgParams, AlgResult, Status,
                                              make_alg_input)
from gpuseqalign_tpu_torch.io.subst import parse_subst_file
from gpuseqalign_tpu_torch.ops import mlsp_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATS = ("tileHrowMat", "tileHcolMat", "tileFrowMat", "tileEcolMat")
N = 23728
GAPO, GAPE = -11, -2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def _align(subst, y, x, spec, device):
    nw = make_alg_input(subst, y, x, GAPO, GAPE if spec.endswith("ag")
                        else 0, spec, device=device)
    res = AlgResult()
    stat = get_algorithm_map()["tpu7_pallas_mlsp"].align(
        AlgParams({"tileBy": [128], "tileBx": [512]}), nw, res)
    assert stat == Status.success
    return nw, res


@pytest.mark.parametrize("spec", ["nw_lg", "nw_ag", "sw_lg", "sw_ag"])
def test_headers_come_back_pinned(card, spec):
    subst = parse_subst_file(
        os.path.join(REPO, "resrc", "subst.json")).subst_map["blosum62"]
    rng = np.random.default_rng(17)
    y, x = (np.concatenate([[0], rng.integers(0, 20, N)]).astype(np.int32)
            for _ in range(2))
    before = mlsp_kernels.PINNED_COPIES
    nw, res = _align(subst, y, x, spec, "cuda")
    assert mlsp_kernels.PINNED_COPIES == before + 1
    held = {name: getattr(nw, name) for name in MATS
            if getattr(nw, name) is not None}
    assert len(held) == (4 if spec.endswith("ag") else 2)
    for name, mat in held.items():
        assert mat.base.is_pinned(), name

    # A second align on the card, the pair swapped, with no reset between.
    other, _ = _align(subst, x, y, spec, "cuda")
    assert mlsp_kernels.PINNED_COPIES == before + 2
    for a in held.values():
        for name in MATS:
            if getattr(other, name) is not None:
                assert not np.shares_memory(a, getattr(other, name)), name

    ref, ref_res = _align(subst, y, x, spec, "cpu")
    assert (nw.tile_hdr_mat_rows, nw.tile_hdr_mat_cols) == (
        ref.tile_hdr_mat_rows, ref.tile_hdr_mat_cols)
    for name in MATS:
        if name in held:
            np.testing.assert_array_equal(held[name], getattr(ref, name),
                                          err_msg=name)
        else:
            assert getattr(ref, name) is None, name
    assert (res.align_cost, nw.best_i, nw.best_j) == (
        ref_res.align_cost, ref.best_i, ref.best_j)
