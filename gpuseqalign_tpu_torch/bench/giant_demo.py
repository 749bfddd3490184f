"""Giant-pair demo: one 100k x 100k alignment on one card.

Port of gpuseqalign_tpu's ``bench/giant_demo.py``. The sparse (mlsp)
representation makes the 10^10-cell DP fit one card: only the tile-header
rows and columns (plus F rows and E columns for affine gaps) reach device
memory, about 90 MB at 100k against 40 GB for the dense matrix. One fill
of the single-pair sparse kernel (K1, ``ops/mlsp_cuda.mlsp_fill``) at the
card's tuned tile (``ops/tuned.py``), else 128 x 512, is timed with CUDA
events: a first fill (the kernel's build on a first call), then the
least of 2 timed fills, each after a warm-up.

Inputs are the JAX demo's: ``default_rng(0)`` draws y, then x, as letters
0..24, then a 25 x 25 substitution matrix in [-4, 10); gapo -11, gape -2.

For pairs past one card, ``parallel/giant2.py`` splits the columns into
bands over a mesh.

Usage: python -m gpuseqalign_tpu_torch.bench.giant_demo [n] [kind_gap]

``main(argv, device=None)`` runs on the card and raises without one;
``device="cpu"`` runs the plain fill, timed on the host clock.
``run_demo`` returns the fill's outputs with the inputs, so a caller can
hold them against another fill.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..ops import tuned
from ..utils.device import card_info, resolve_device, synchronize
from .headline import _padded
from .vpu_probe import elapsed_s

GAPO, GAPE = -11, -2
LETTERS = 25
TILE_H, TILE_W = 128, 512


def demo_inputs(n: int):
    """(y, x, subst) of the JAX demo: header-prefixed int32 letters of n
    residues each and a 25 x 25 int32 matrix, in its order of draws."""
    rng = np.random.default_rng(0)
    y = np.zeros(1 + n, np.int32)
    y[1:] = rng.integers(0, LETTERS, n)
    x = np.zeros(1 + n, np.int32)
    x[1:] = rng.integers(0, LETTERS, n)
    subst = rng.integers(-4, 10, size=(LETTERS, LETTERS)).astype(np.int32)
    return y, x, subst


def run_demo(n: int, spec_name: str,
             device: Optional[Union[str, torch.device]] = None) -> Dict:
    """One n x n fill of ``spec_name`` on ``device``: a first fill (whose
    seconds include the kernel's build on a first call), then the least
    of 2 timed fills, each after a warm-up. Returns the tile, ms, GCUPS, the outputs' bytes,
    the padded inputs on the device and the last fill's outputs."""
    from ..core.types import AlignSpec
    from ..ops.mlsp_cuda import mlsp_fill

    dev = resolve_device(device)
    spec = AlignSpec.from_name(spec_name)
    kind, gap = spec.kind.value, spec.gap.value
    th, tw = tuned.tuned_tile(spec.name, dev, (TILE_H, TILE_W))
    y_np, x_np, subst_np = demo_inputs(n)
    subst = torch.from_numpy(subst_np).to(dev)
    y, x = _padded(y_np, th, dev), _padded(x_np, tw, dev)
    kw = dict(gapo=GAPO, gape=GAPE, adjr=n + 1, adjc=n + 1, tile_h=th,
              tile_w=tw, kind=kind, gap=gap)

    def fill():
        return mlsp_fill(subst, y, x, **kw)

    t0 = time.perf_counter()
    out = fill()
    synchronize(dev)
    first_s = time.perf_counter() - t0
    t = min(elapsed_s(fill, dev, 1) for _ in range(2))
    return dict(spec=spec, n=n, tile=(th, tw), ms=t * 1e3,
                gcups=n * n / t / 1e9, first_s=first_s,
                out_bytes=sum(v.numel() * v.element_size()
                              for v in out.values()),
                inputs=dict(subst=subst, y=y, x=x), headers=out, fill_kw=kw)


def demo_line(r: Dict) -> str:
    """The JAX demo's result line."""
    n, spec = r["n"], r["spec"]
    return (f"{spec.kind.value}_{spec.gap.value} {n}x{n}: {r['ms']:.0f} ms  "
            f"{r['gcups']:.1f} GCUPS  sparse output {r['out_bytes'] / 1e6:.0f} MB (dense would be "
            f"{n * n * 4 / 1e9:.0f} GB)")


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 100_000
    spec_name = argv[1] if len(argv) > 1 else "nw_ag"
    dev = resolve_device(device)
    card, power = card_info(dev)
    print(f"card: {card}, power limit {power}")
    r = run_demo(n, spec_name, dev)
    print(f"tile {r['tile'][0]}x{r['tile'][1]}; first fill, build "
          f"included: {r['first_s']:.1f}s", file=sys.stderr)
    print(demo_line(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
