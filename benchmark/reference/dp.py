"""The plain reference: pairwise alignment by a row-by-row dynamic programme.

Plain PyTorch, written from the recurrences the configurations state and
from nothing of the program. Many pairs go through one loop over rows,
each pair zero-padded to the widest; a pair's cells never read a padded
cell, since a row runs left to right and a pair's rows end at its own.

- NW, linear gap: H[0][j] = j*go, H[i][0] = i*go, H[i][j] = max(H[i-1][j-1]
  + s, H[i-1][j] + go, H[i][j-1] + go); the cost is H[rows][cols].
- Affine gap (Gotoh): E[i][j] = max(E[i][j-1], H[i][j-1] + go) + ge and
  F[i][j] = max(F[i-1][j], H[i-1][j] + go) + ge, -inf on the edges they
  do not reach; H[i][j] = max(H[i-1][j-1] + s, E[i][j], F[i][j]); NW edges
  H[0][j] = go + j*ge, H[i][0] = go + i*ge, H[0][0] = 0.
- SW: every H is clamped at 0 and the edges are 0; the cost is the
  largest H and the best cell the first (i, j) in row-major order that
  holds it, (0, 0) when no cell is above 0.

A row's left-to-right chain max(cand[j], H[j-1] + g) is a running maximum
of cand[k] - k*g, plus j*g (``torch.cummax``); with go <= 0, the affine E
is the same scan over max(H[i-1][k-1] + s, F[i][k]) + go (an E that
extends an E never wins over the scan from where that E opened).

``bits`` 16 or 8 is the control: every row of H, E and F, and the
running best, is stored in that many bits with saturation, as a kernel
of that width would store it; everything else is the same code.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -(2 ** 30)
_BOUNDS = {32: None, 16: (-(2 ** 15), 2 ** 15 - 1), 8: (-(2 ** 7), 2 ** 7 - 1)}


def matrix(config: Dict) -> np.ndarray:
    """The substitution matrix of a configuration file, (S, S) int32, in
    the order of its ``letters``."""
    rows = [[int(v) for v in line.split()] for line in config["subst_rows"]]
    mat = np.array(rows, np.int32)
    n = len(config["letters"])
    if mat.shape != (n, n):
        raise ValueError(f"matrix is {mat.shape}, letters {n}")
    return mat


def align(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], subst: np.ndarray,
          *, algorithm: str, gapo: int, gape: int,
          device: "str | torch.device" = "cpu", bits: int = 32
          ) -> np.ndarray:
    """(n, 3) int64 [cost, best_i, best_j] of each pair (y, x), both with
    the header element in front; best is (0, 0) for NW."""
    kind, gap = algorithm.split("_")
    sw, affine = kind == "sw", gap == "ag"
    if affine and (gapo > 0 or gape > 0):
        raise ValueError("the affine recurrence takes gapo, gape <= 0")
    bounds = _BOUNDS[bits]

    def sat(t: torch.Tensor) -> torch.Tensor:
        return t if bounds is None else t.clamp_(*bounds)

    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    n = len(pairs)
    rows = [len(y) - 1 for y, _ in pairs]
    cols = [len(x) - 1 for _, x in pairs]
    R, C = max(rows), max(cols)
    ys = np.zeros((n, R + 1), np.int64)
    xs = np.zeros((n, C), np.int64)
    for b, (y, x) in enumerate(pairs):
        ys[b, :len(y)] = y
        xs[b, :len(x) - 1] = x[1:]
    S = subst.shape[0]
    flat = torch.from_numpy(np.ascontiguousarray(subst, np.int32)).to(dev)
    flat = flat.reshape(-1)
    ys_s = torch.from_numpy(ys * S).to(dev)
    xs_d = torch.from_numpy(xs).to(dev)
    cols_d = torch.tensor(cols, dtype=torch.int64, device=dev).view(n, 1)
    rows_d = torch.tensor(rows, dtype=torch.int64, device=dev)
    j = torch.arange(C + 1, **i32)
    go_offs, ge_offs = j * gapo, j * gape

    if sw:
        h = torch.zeros((n, C + 1), **i32)
    elif affine:
        h = (gapo + j * gape).expand(n, C + 1).clone()
        h[:, 0] = 0
    else:
        h = go_offs.expand(n, C + 1).clone()
    h = sat(h)
    f = sat(torch.full((n, C + 1), NEG_INF, **i32))
    cost = h.gather(1, cols_d).view(n).clone()
    best = torch.zeros((3, n), **i32)
    live_cols = j[1:].view(1, C) <= cols_d
    ends: Dict[int, List[int]] = {}
    for b, r in enumerate(rows):
        ends.setdefault(r, []).append(b)

    for i in range(1, R + 1):
        s = flat[ys_s[:, i:i + 1] + xs_d]
        edge = 0 if sw else gapo + i * gape if affine else i * gapo
        first = sat(torch.full((n, 1), edge, **i32))
        if not affine:
            cand = torch.maximum(h[:, :-1] + s, h[:, 1:] + gapo)
            if sw:
                cand.clamp_(min=0)
            run = torch.cat([first, cand], 1) - go_offs
            h = sat(torch.cummax(run, 1).values + go_offs)
        else:
            f = sat(torch.maximum(f, h + gapo) + gape)
            f[:, 0] = NEG_INF  # never read: v takes columns 1..C
            v = torch.maximum(h[:, :-1] + s, f[:, 1:])
            if sw:
                v.clamp_(min=0)
            run = torch.cat([first, v], 1) + gapo - ge_offs
            e = sat(torch.cummax(run, 1).values[:, :-1] + ge_offs[1:])
            hn = torch.maximum(v, e)
            h = sat(torch.cat([first, hn], 1))
        if not sw and i in ends:
            at = torch.tensor(ends[i], device=dev)
            cost[at] = h[at].gather(1, cols_d[at]).view(-1)
        if sw:
            live = torch.where(live_cols & (i <= rows_d).view(n, 1),
                               h[:, 1:], -1)
            rmax = live.amax(1)
            jmin = torch.where(live == rmax.view(n, 1), j[1:].view(1, C),
                               C + 1).amin(1)
            upd = rmax > best[0]
            best[0] = torch.where(upd, rmax, best[0])
            best[1] = torch.where(upd, i, best[1])
            best[2] = torch.where(upd, jmin, best[2])
    if sw:
        out = best
    else:
        out = torch.stack([cost, torch.zeros_like(cost),
                           torch.zeros_like(cost)])
    return out.t().cpu().numpy().astype(np.int64)
