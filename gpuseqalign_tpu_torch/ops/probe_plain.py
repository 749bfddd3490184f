"""Plain PyTorch versions of the step-body probes (``ops/csrc/probe.cu``).

Each function computes what its kernel stores, on whatever device its
tensors lie, by running the same chain: the elementwise bodies iteration
by iteration, the strips row by row through ``mlsp_plain.row_step`` (the
row body of every plain fill of the port). They are the kernels'
references on the CPU tests and on the card, at small ``iters``; they are
no yardstick of speed.

Layouts, shared with the wrappers in ``ops/probe_cuda.py``:

  chain    a (blocks, nt) int32 -> (blocks, nt): the max over nch chains,
           chain k starting at a + k
  strip    K strips a block, strip (b, k) of nt rows x iters columns with
           the analytic edge of its spec; row i (1-based) of the strip is
           thread i - 1. Scores: subst[y[b, k, i-1], x[k, j]] (lookup) or
           a[b, i-1] + k (constant along the row: the skeletons and the
           nolookup variant). Outputs hcol/ecol (blocks, K, nt) = H/E at
           column iters, hrow/frow (blocks, K, iters) = H/F of row nt, and
           for SW best (blocks, K, nt, 3) = each row's (v, i, j): the
           largest H over the row's columns, its first column, (0, 0, 0)
           when no cell is > 0
  int16    a (blocks, nt) int32 -> (blocks, nt); the int16 modes read each
           word as two int16 lanes (the low halfword first) and wrap
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.types import NEG_INF_I32
from .mlsp_plain import edge_col, edge_row, row_step

# The elementwise bodies of probe_chain, in the kernel's enum order, then
# the two skeletons.
CHAIN_BODIES = ("maxadd2", "viaddmax", "select", "shift_add2", "shfl",
                "xwarp", "skeleton_nw_lg", "skeleton_nw_ag")
# The ablation variants of probe_fullstep(_affine), in the kernel's order.
VARIANTS = ("base", "nolookup", "noheader", "onewarp", "sw")
INT16_MODES = ("i32", "i16x2", "i16x2_dpx")
INT16_CHAINS = 12


def chain_plain(a: torch.Tensor, body: str, nch: int, iters: int,
                gapo: int = -11, gape: int = -2) -> torch.Tensor:
    """What ``probe_chain`` stores for ``a`` (blocks, nt)."""
    if body.startswith("skeleton_"):
        gap = "affine" if body.endswith("_ag") else "linear"
        out = strips_plain(a, None, None, None, nch, iters, gapo,
                           gape if gap == "affine" else 0,
                           kind="nw", gap=gap, header=False)
        return out["hcol"].amax(1)
    blocks, nt = a.shape
    av = a.unsqueeze(-1)
    a7 = av + 7
    st = av + torch.arange(nch, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        if body in ("maxadd2", "viaddmax"):
            st = torch.maximum(st + av, a7)
        elif body == "select":
            st = torch.where(av > 0, st, av)
        elif body == "shift_add2":
            st = (st >> 2) + av
        elif body == "shfl":
            st = st.view(blocks, nt // 32, 32, nch).roll(-1, 2).view_as(st)
        elif body == "xwarp":
            st = st.roll(-32, 1)
        else:
            raise ValueError(f"unknown probe_chain body {body!r}")
    return st.amax(-1)


def strips_plain(a: Optional[torch.Tensor], subst: Optional[torch.Tensor],
                 y: Optional[torch.Tensor], x: Optional[torch.Tensor],
                 K: int, iters: int, gapo: int, gape: int, *, kind: str,
                 gap: str, header: bool = True) -> Dict[str, torch.Tensor]:
    """The strips of the layout above. With ``subst`` None the scores are
    a + k (``a`` (blocks, nt)); else they are looked up from ``y``
    (blocks, K, nt) and ``x`` (K, 1 + iters). ``header`` False leaves out
    the bottom rows, which the noheader variant does not store."""
    affine = gap == "affine"
    if subst is None:
        blocks, nt = a.shape
        dev = a.device
    else:
        blocks, _, nt = y.shape
        dev = y.device
        # sx[k, s, j] = subst[s, x[k, j]]
        sx = subst[:, x.long()].permute(1, 0, 2)
        kk = torch.arange(K, device=dev).view(1, K)
    B, W = blocks * K, iters + 1
    i32 = dict(dtype=torch.int32, device=dev)
    offs = torch.arange(W, **i32)
    goffs, geoffs = offs * gapo, offs * gape
    hprev = edge_row(W, gapo, gape, kind, gap, dev).expand(B, W)
    fprev = torch.full((B, W), NEG_INF_I32, **i32)
    hcol, ecol, best = [], [], []
    for i in range(1, nt + 1):
        if subst is None:
            srow = (a[:, i - 1].view(blocks, 1)
                    + torch.arange(K, **i32)).view(B, 1).expand(B, W)
        else:
            srow = sx[kk, y[:, :, i - 1].long()].view(B, W)
        first = edge_col(torch.full((B, 1), i, **i32), gapo, gape, kind, gap)
        hprev, fprev, erow = row_step(hprev, fprev, srow, first, gapo, gape,
                                      goffs, geoffs, kind=kind, gap=gap)
        hcol.append(hprev[:, iters])
        if affine:
            ecol.append(erow[:, iters])
        if kind == "sw":
            v, j = hprev[:, 1:].max(1)
            hit = (v > 0).long()
            best.append(torch.stack([v.long(), hit * i, hit * (j + 1)],
                                    -1).to(torch.int32))
    out = {"hcol": torch.stack(hcol, -1).view(blocks, K, nt)}
    if affine:
        out["ecol"] = torch.stack(ecol, -1).view(blocks, K, nt)
    if header:
        out["hrow"] = hprev[:, 1:].reshape(blocks, K, iters)
        if affine:
            out["frow"] = fprev[:, 1:].reshape(blocks, K, iters)
    if kind == "sw":
        out["best"] = torch.stack(best, 1).view(blocks, K, nt, 3)
    return out


def fullstep_plain(subst: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                   a: torch.Tensor, gapo: int, gape: int, *, gap: str,
                   variant: str) -> Dict[str, torch.Tensor]:
    """What ``probe_fullstep`` (linear ``gap``) or
    ``probe_fullstep_affine`` stores for one variant."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    K, W = x.shape
    kind = "sw" if variant == "sw" else "nw"
    if variant == "nolookup":
        return strips_plain(a, None, None, None, K, W - 1, gapo, gape,
                            kind=kind, gap=gap)
    return strips_plain(None, subst, y, x, K, W - 1, gapo, gape, kind=kind,
                        gap=gap, header=variant != "noheader")


def int16_plain(a: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """What ``probe_int16`` stores for ``a`` (blocks, nt)."""
    if mode not in INT16_MODES:
        raise ValueError(f"unknown probe_int16 mode {mode!r}")
    v = a if mode == "i32" else a.view(torch.int16)
    av = v.unsqueeze(-1)
    a7 = av + 7
    st = av + torch.arange(INT16_CHAINS, dtype=v.dtype, device=v.device)
    for _ in range(iters):
        st = torch.maximum(st + av, a7)
    return st.amax(-1).view(torch.int32)
