"""Parameter autotuner on the card: the reference's param_optimize workflow
(ref: README.md:114-115: run the full parameter grid per algorithm on a
5000x5000 pair and keep the best), the tile sweeps of the sparse fill and
of the giant engine, and the card's tuned cache they write.

Port of gpuseqalign_tpu's ``bench/autotune.py``.

- ``tune``: every parameter combination of a grid, timed on the
  ``align.calc`` lap (median of ``samples`` runs after one warm-up) and
  gated on the first algorithm's align_cost; the output has the shape of
  ``resrc/param_best.json`` (single-value lists, plus ``_gcups``), so the
  CLI takes it unchanged.
- ``tune_v2``: the single-pair sparse fill's tile (K1,
  ``ops/mlsp_cuda.mlsp_fill``). Each tile is first gated: through the
  registry's ``tpu7_pallas_mlsp`` it must give ``cpu1_st_row``'s cost on a
  problem two strips of the kernel's schedule and two tile rows tall, so
  the carry between strips runs. Then ``m_iters`` fills of the pair are
  timed with CUDA events after a warm-up, the least of 3 turns.
- ``tune_banded``: the same for the giant engine's tile (K7 through
  ``align_giant2`` at D = 1; the ``banded`` sub-entry).
- ``save_defaults``: merges an entry into ``resrc/tuned/<card>.json``, the
  cache ``ops/tuned.py`` reads on the card.

The strip kernels' schedule constants (strip_cuda.PAIR_WARPS,
dense_cuda.LANE_ROWS and WARPS, tiny_cuda.WARPS,
batch.TINY_MIN_PAIRS_PER_SM) stay constants and are not swept.

Usage:
    python -m gpuseqalign_tpu_torch.bench.autotune \\
        --algParamPath resrc/param_optimize.json \\
        --seqPath resrc/seq_generated.fa --pair len5000 len5000 \\
        --out logs/param_tuned.json
    python -m gpuseqalign_tpu_torch.bench.autotune --save-defaults \\
        --seqPath resrc/seq_generated.fa --pair len23728 len23728 \\
        --algKind nw_ag --gapeCost -2 [--bandedRows 100000]

``main(argv, device=None)`` runs on the card and raises without one;
``device="cpu"`` times the plain versions on the host clock, for tests
(``--save-defaults`` needs the card, whose name names the cache).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.registry import get_algorithm_map
from ..core.types import (
    AlgParams,
    AlgResult,
    AlignSpec,
    Status,
    make_alg_input,
)
from ..ops import tuned
from ..utils.device import resolve_device
from .headline import _padded
from .vpu_probe import elapsed_s

Device = Optional[Union[str, torch.device]]

# K1's tile grid: tile heights set the strip height (32 to 256 rows) and
# header rows, tile widths the header columns. It holds the literal
# default, 128 x 512.
DEFAULT_V2_GRID = {"tileBy": [32, 64, 128, 256, 512],
                   "tileBx": [128, 256, 512, 1024, 2048]}
# K7's tile grid: the giant engine takes multiples of 128.
DEFAULT_BANDED_GRID = {"tileBy": [128, 256, 512],
                       "tileBx": [128, 256, 512]}
# Seed of the oracle gate problems, and of --bandedRows' sequence.
GATE_SEED = 12345
BANDED_SEED = 20261016
GATE_COLS = 2048


def tune(
    alg_params: Dict[str, Dict[str, List[int]]],
    subst: np.ndarray,
    seqY: np.ndarray,
    seqX: np.ndarray,
    gapo: int,
    gape: int = 0,
    spec: Optional[AlignSpec] = None,
    samples: int = 3,
    verbose: bool = False,
    device: Device = None,
) -> Dict[str, Dict[str, List[int]]]:
    """Returns {alg_name: {param: [best_value]}} (+ measured GCUPS under
    the key "_gcups"). The first algorithm sets the expected align_cost;
    combinations that fail or mismatch are skipped."""
    dev = resolve_device(device)
    alg_map = get_algorithm_map()
    spec = spec or AlignSpec()
    nw = make_alg_input(subst, seqY, seqX, gapo, gape, spec.name,
                        device=str(dev))
    cells = (nw.adjrows - 1) * (nw.adjcols - 1)

    expected_cost = None
    best: Dict[str, Dict[str, List[int]]] = {}
    for name, grid in alg_params.items():
        alg = alg_map[name]
        params = AlgParams(grid)
        best_t = None
        best_combo = None
        while params.has_curr():
            combo = params.copy_current()
            ts = []
            ok = True
            for rep in range(1 + samples):  # first is warmup
                nw.reset_cycle()
                res = AlgResult()
                stat = alg.align(params, nw, res)
                if stat != Status.success:
                    ok = False
                    break
                if expected_cost is None:
                    expected_cost = res.align_cost
                elif res.align_cost != expected_cost:
                    ok = False
                    break
                if rep:
                    ts.append(res.sw_align.get_or_default("align.calc") / 1e3)
            if ok and ts:
                t = float(np.median(ts))
                if verbose:
                    print(f"  {name} {combo}: {cells / t / 1e9:.2f} GCUPS",
                          file=sys.stderr)
                if best_t is None or t < best_t:
                    best_t, best_combo = t, combo
            params.next()
        if best_combo is not None:
            entry = {k: [v] for k, v in best_combo.items()}
            entry["_gcups"] = [round(cells / best_t / 1e9, 3)]
            best[name] = entry
        elif verbose:
            print(f"  {name}: no valid combination", file=sys.stderr)
    return best


def _fill_ms(fill: Callable[[], object], dev: torch.device, m_iters: int,
             turns: int = 3) -> float:
    """ms of one fill: ``m_iters`` fills between two CUDA events (the host
    clock on the CPU) after a warm-up; the least of ``turns`` turns."""
    return min(elapsed_s(fill, dev, m_iters) for _ in range(turns)) * 1e3


class _Gate:
    """Oracle gate problems, keyed by (rows, cols): random letters from a
    fixed seed and ``cpu1_st_row``'s cost; a tile passes when the registry
    name gives the same cost on the device."""

    def __init__(self, subst: np.ndarray, spec: AlignSpec, gapo: int,
                 gape: int, dev: torch.device) -> None:
        self.subst, self.spec, self.gapo, self.gape = subst, spec, gapo, gape
        self.dev = dev
        self.rng = np.random.default_rng(GATE_SEED)
        self.cache: Dict = {}

    def problem(self, gr: int, gc: int):
        if (gr, gc) not in self.cache:
            from ..models.cpu_algs import align_cpu1_st_row

            sz = self.subst.shape[0]
            y = np.zeros(1 + gr, np.int32)
            x = np.zeros(1 + gc, np.int32)
            y[1:] = self.rng.integers(0, sz, gr)
            x[1:] = self.rng.integers(0, sz, gc)
            nwo = make_alg_input(self.subst, y, x, self.gapo, self.gape,
                                 self.spec.name, device="cpu")
            reso = AlgResult()
            if align_cpu1_st_row(AlgParams({}), nwo, reso) != Status.success:
                raise RuntimeError("oracle failed")
            self.cache[(gr, gc)] = (y, x, reso.align_cost)
        return self.cache[(gr, gc)]

    def passes(self, alg_name: str, tile_h: int, tile_w: int,
               gr: int, gc: int) -> bool:
        y, x, want = self.problem(gr, gc)
        nwc = make_alg_input(self.subst, y, x, self.gapo, self.gape,
                             self.spec.name, device=str(self.dev))
        resc = AlgResult()
        stat = get_algorithm_map()[alg_name].align(
            AlgParams({"tileBy": [tile_h], "tileBx": [tile_w]}), nwc, resc)
        return stat == Status.success and resc.align_cost == want


def tune_v2(
    subst: np.ndarray,
    seq: np.ndarray,
    spec: AlignSpec,
    gapo: int,
    gape: int,
    grid: Optional[Dict[str, List[int]]] = None,
    m_iters: int = 4,
    verbose: bool = False,
    device: Device = None,
) -> Dict[str, int]:
    """K1's tile for ``spec``: every (tileBy, tileBx) of ``grid`` gated on
    the oracle, then ``m_iters`` fills of ``seq`` against itself timed
    (CUDA events, the least of 3 turns after a warm-up). Returns
    {"tileBy", "tileBx", "_gcups"}; raises when no tile passes its gate."""
    from ..ops import mlsp_cuda, strip_cuda

    dev = resolve_device(device)
    n = len(seq) - 1
    kind, gap = spec.kind.value, spec.gap.value
    gate = _Gate(subst, spec, gapo, gape, dev)
    subst_d = torch.from_numpy(np.ascontiguousarray(subst, np.int32)).to(dev)
    grid = dict(grid or DEFAULT_V2_GRID)
    best = None
    for th in grid["tileBy"]:
        for tw in grid["tileBx"]:
            tag = f"tile {th}x{tw}"
            # Two strips and two tile rows: the carry between strips runs,
            # through the headers or the scratch as the schedule says.
            gr = 2 * max(strip_cuda.schedule(th, tw).rows, th)
            if not gate.passes("tpu7_pallas_mlsp", th, tw, gr,
                               min(n, GATE_COLS)):
                if verbose:
                    print(f"  {tag}: GATE FAIL", file=sys.stderr)
                continue
            y, x = _padded(seq, th, dev), _padded(seq, tw, dev)
            ms = _fill_ms(lambda: mlsp_cuda.mlsp_fill(
                subst_d, y, x, gapo, gape, n + 1, n + 1, tile_h=th,
                tile_w=tw, kind=kind, gap=gap), dev, m_iters)
            g = n * n / (ms * 1e-3) / 1e9
            if verbose:
                print(f"  {tag}: {ms:.4f} ms, {g:.2f} GCUPS", file=sys.stderr)
            if best is None or g > best["_gcups"]:
                best = {"tileBy": th, "tileBx": tw, "_gcups": round(g, 3)}
            del y, x
    if best is None:
        raise RuntimeError("no tile passed its gate")
    return best


def tune_banded(
    subst: np.ndarray,
    seq: np.ndarray,
    spec: AlignSpec,
    gapo: int,
    gape: int,
    grid: Optional[Dict[str, List[int]]] = None,
    m_iters: int = 4,
    verbose: bool = False,
    device: Device = None,
) -> Dict[str, int]:
    """The giant engine's tile (R, TW) for ``spec`` at D = 1: every tile of
    ``grid`` gated on the oracle through the registry's
    ``tpu9_giant_mlsp``, then the engine's fill (``giant2_fill``, one K7
    call) of ``seq`` against itself timed as in ``tune_v2``. Returns the
    ``banded`` sub-entry {"tileBy", "tileBx", "_at_rows", "_gcups"}."""
    from ..ops import strip_cuda
    from ..parallel.giant2 import band_geometry, giant2_fill
    from ..parallel.mesh import default_mesh

    dev = resolve_device(device)
    n = len(seq) - 1
    kind, gap = spec.kind.value, spec.gap.value
    gate = _Gate(subst, spec, gapo, gape, dev)
    subst_d = torch.from_numpy(np.ascontiguousarray(subst, np.int32)).to(dev)
    mesh = default_mesh(dev)
    grid = dict(grid or DEFAULT_BANDED_GRID)
    best = None
    for R in grid["tileBy"]:
        for TW in grid["tileBx"]:
            tag = f"tile {R}x{TW}"
            gr = 2 * max(strip_cuda.strip_rows(R), R)
            if not gate.passes("tpu9_giant_mlsp", R, TW, gr,
                               min(n, GATE_COLS)):
                if verbose:
                    print(f"  banded {tag}: GATE FAIL", file=sys.stderr)
                continue
            geo = band_geometry(AlgParams({"tileBy": [R], "tileBx": [TW]}),
                                [n], [n], 1)
            _, _, bc, BL = geo
            y = _padded(seq, BL * R, dev)
            x = _padded(seq, bc, dev)
            ms = _fill_ms(lambda: giant2_fill(
                subst_d, [y], [x], gapo, gape, [n + 1], [n + 1], mesh=mesh,
                R=R, TW=TW, band_cols=bc, BL=BL, kind=kind, gap=gap),
                dev, m_iters)
            g = n * n / (ms * 1e-3) / 1e9
            if verbose:
                print(f"  banded {tag}: {ms:.4f} ms, {g:.2f} GCUPS",
                      file=sys.stderr)
            if best is None or g > best["_gcups"]:
                best = {"tileBy": R, "tileBx": TW, "_at_rows": n,
                        "_gcups": round(g, 3)}
            del y, x
    if best is None:
        raise RuntimeError("no banded tile passed its gate")
    return best


def save_defaults(entry: Dict, spec_name: str,
                  root: Optional[str] = None) -> str:
    """Merge a tuned entry into ``<root>/<card>.json`` (default root
    ``resrc/tuned``), the cache ``ops/tuned.py`` reads; <card> is the
    current CUDA device's. Returns the path written."""
    name = tuned.cache_name(torch.device("cuda"))
    path = tuned.cache_path(name, root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = tuned.read_cache(name, root)
    # Merge into the spec's entry, never replace it: the sparse fill's
    # sweep must not wipe the giant engine's ``banded`` sub-entry (the JAX
    # package lost one exactly this way).
    data[spec_name] = {**data.get(spec_name, {}), **entry}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def random_seq(n: int, substsz: int, seed: int = BANDED_SEED) -> np.ndarray:
    """A header-prefixed sequence of ``n`` random letters."""
    rng = np.random.default_rng(seed)
    return np.concatenate([[0], rng.integers(0, substsz, n)]).astype(np.int32)


def main(argv: Optional[List[str]] = None, device: Device = None) -> int:
    import argparse

    from ..io.fasta import parse_seq_file
    from ..io.params import parse_alg_params_file
    from ..io.subst import parse_subst_file

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algParamPath", default="")
    ap.add_argument("--seqPath", required=True)
    ap.add_argument("--substPath", default="./resrc/subst.json")
    ap.add_argument("--substName", default="blosum62")
    ap.add_argument("--pair", nargs=2, required=True,
                    metavar=("SEQY_ID", "SEQX_ID"))
    ap.add_argument("--gapoCost", type=int, default=-11)
    ap.add_argument("--gapeCost", type=int, default=0)
    ap.add_argument("--algKind", default="nw_lg")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument(
        "--save-defaults", action="store_true",
        help="sweep the sparse fill's tile (tune_v2) on the card and merge "
             "it into resrc/tuned/<card>.json (the cache ops/tuned.py "
             "reads); --algParamPath is then optional")
    ap.add_argument(
        "--bandedRows", type=int, default=0,
        help="with --save-defaults, also sweep the giant engine's tile "
             "(tune_banded) on a random pair of this many residues and "
             "save it as the spec's banded sub-entry")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    subst_data = parse_subst_file(args.substPath)
    subst = subst_data.subst_map[args.substName]
    seq_data = parse_seq_file(args.seqPath, subst_data.letter_map)
    seqY = seq_data.seq_map[args.pair[0]].seq
    seqX = seq_data.seq_map[args.pair[1]].seq

    if args.save_defaults:
        spec = AlignSpec.from_name(args.algKind)
        t0 = time.time()
        entry = tune_v2(subst, seqY, spec, args.gapoCost, args.gapeCost,
                        verbose=True, device=dev)
        path = save_defaults(entry, spec.name)
        if args.bandedRows:
            band = tune_banded(
                subst, random_seq(args.bandedRows, subst.shape[0]), spec,
                args.gapoCost, args.gapeCost, verbose=True, device=dev)
            save_defaults({"banded": band}, spec.name)
            entry = {**entry, "banded": band}
        print(json.dumps({spec.name: entry}))
        print(f"wrote {path} in {time.time() - t0:.1f}s", file=sys.stderr)
        return 0

    if not args.algParamPath:
        ap.error("--algParamPath is required without --save-defaults")
    grids = parse_alg_params_file(args.algParamPath)

    t0 = time.time()
    out = tune(
        grids, subst, seqY, seqX, args.gapoCost, args.gapeCost,
        spec=AlignSpec.from_name(args.algKind), samples=args.samples,
        verbose=True, device=dev,
    )
    text = json.dumps(out, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text)
    print(f"tuned in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
