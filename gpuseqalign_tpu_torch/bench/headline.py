"""Headline benchmark: NW affine-gap GCUPS of the sparse fill (K1) on one
card (BASELINE.json's first metric, "GCUPS/chip on NW affine-gap"; the
counterpart of the repository's root ``bench.py``).

Problem: the reference's release workload, one len23728 x len23728 pair
(``resrc/pair_release.txt``: len23728 against itself) with blosum62, gapo
-11 and gape -2, filled by ``ops/mlsp_cuda.py::mlsp_fill`` (K1) at the card's
tuned nw_ag tile (``ops/tuned.py``, as the root ``bench.py`` reads its
TPU's), else 128 x 512. After one warm-up fill, the mean of five fills
is timed with CUDA events; GCUPS = rows * cols / that time.

Correctness gate: ``models/cpu_algs.align_cpu1_st_row`` (the oracle) on
the ``--oracleN`` prefix of the pair gives the cost that K1, through the
registry's ``tpu7_pallas_mlsp`` at the same tile, must reproduce, or the
run raises; its speed on this host gives ``vs_baseline``. In the same
process ``vpu_probe.roofline_body("nw", "affine")`` measures the fastest
faithful nw_ag step body (the fills' warp row strip, at its best rows a
lane R and strips a block K, which ``body_variant`` names), and ``mfu`` =
value / body_gcups. A failed probe or gate fails the run: nothing
recorded stands in for a measurement.

Prints ONE JSON line: metric, value, unit, vs_baseline, body_gcups,
body_variant, mfu, peak_share (value over the card's instruction issue
rate, ``vpu_probe.ISSUE_INSNS_PER_S``, for nw_ag: its 9 operations a
cell issue as ``insns_per_cell``, 6 int32 instructions on sm_90a, as in
``vpu_probe.INSNS_PER_CELL``), card,
power_limit, the tile, and the gate's cost.

Usage: python -m gpuseqalign_tpu_torch.bench.headline [--n N] [--oracleN N].
``main(argv, device=None)`` runs on the card and raises
without one; ``device="cpu"`` runs the plain fill, timed on the host
clock, and labels the output "cpu".
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch

from ..ops import tuned
from ..utils.device import card_info, resolve_device
from .vpu_probe import (INSNS_PER_CELL, ISSUE_INSNS_PER_S, elapsed_s,
                        roofline_body)

RESRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "resrc")
PAIR = "len23728"
KIND, GAP, SPEC = "nw", "affine", "nw_ag"
GAPO, GAPE = -11, -2
TILE_H, TILE_W = 128, 512
M_FILLS = 5  # timed fills after the warm-up


def _padded(seq: np.ndarray, tile: int, dev: torch.device) -> torch.Tensor:
    n = len(seq) - 1
    out = np.zeros(1 + -(-n // tile) * tile, np.int32)
    out[:len(seq)] = seq
    return torch.from_numpy(out).to(dev)


def _gate(subst: np.ndarray, seq: np.ndarray, dev: torch.device,
          tile: tuple):
    """(cost, oracle seconds): cpu1_st_row on ``seq`` against itself, and
    K1 through the registry at the benched ``tile``, which must agree."""
    from ..core.registry import get_algorithm_map
    from ..core.types import AlgParams, AlgResult, Status, make_alg_input
    from ..models.cpu_algs import align_cpu1_st_row

    nwo = make_alg_input(subst, seq, seq, GAPO, GAPE, SPEC, device="cpu")
    reso = AlgResult()
    t0 = time.perf_counter()
    stat = align_cpu1_st_row(AlgParams({}), nwo, reso)
    t_oracle = time.perf_counter() - t0
    if stat != Status.success:
        raise RuntimeError(f"oracle failed: {stat!r}")
    nwc = make_alg_input(subst, seq, seq, GAPO, GAPE, SPEC,
                         device=str(dev))
    resc = AlgResult()
    stat = get_algorithm_map()["tpu7_pallas_mlsp"].align(
        AlgParams({"tileBy": [tile[0]], "tileBx": [tile[1]]}), nwc, resc)
    if stat != Status.success or resc.align_cost != reso.align_cost:
        raise RuntimeError(f"bench kernel mismatch: {stat!r} "
                           f"{resc.align_cost} vs oracle {reso.align_cost}")
    return reso.align_cost, t_oracle


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    import argparse

    from ..io.fasta import parse_seq_file
    from ..io.subst import parse_subst_file
    from ..ops.mlsp_cuda import mlsp_fill

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=23728,
                    help="residues of the pair: a prefix of len23728")
    ap.add_argument("--oracleN", type=int, default=4096,
                    help="residues of the gate's prefix")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    subst_data = parse_subst_file(os.path.join(RESRC, "subst.json"))
    subst = subst_data.subst_map["blosum62"]
    full = parse_seq_file(os.path.join(RESRC, "seq_generated.fa"),
                          subst_data.letter_map).seq_map[PAIR].seq
    if not 1 <= args.oracleN <= args.n <= len(full) - 1:
        ap.error(f"need 1 <= --oracleN <= --n <= {len(full) - 1}")
    seq = np.asarray(full[:1 + args.n], np.int32)
    n = args.n

    th, tw = tuned.tuned_tile(SPEC, dev, (TILE_H, TILE_W))
    subst_d = torch.from_numpy(np.ascontiguousarray(subst, np.int32)).to(dev)
    y, x = _padded(seq, th, dev), _padded(seq, tw, dev)
    kw = dict(gapo=GAPO, gape=GAPE, adjr=n + 1, adjc=n + 1, tile_h=th,
              tile_w=tw, kind=KIND, gap=GAP)
    t = elapsed_s(lambda: mlsp_fill(subst_d, y, x, **kw), dev, M_FILLS)
    gcups = n * n / t / 1e9

    cost, t_oracle = _gate(subst, seq[:1 + args.oracleN], dev, (th, tw))
    oracle_gcups = args.oracleN ** 2 / t_oracle / 1e9
    body = roofline_body(KIND, GAP, device=dev)
    card, power = card_info(dev)
    out = {
        "metric": f"GCUPS {SPEC} mlsp_fill {n}x{n} ({card})",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / oracle_gcups,
        "body_gcups": body["gcups"],
        "body_variant": f"{body['variant']} R{body['R']} K{body['K']}",
        "mfu": gcups / body["gcups"],
        "peak_share": (gcups * 1e9 * INSNS_PER_CELL[SPEC]
                       / ISSUE_INSNS_PER_S if dev.type == "cuda" else None),
        "insns_per_cell": INSNS_PER_CELL[SPEC],
        "card": card,
        "power_limit": power,
        "n": n,
        "tile": f"{th}x{tw}",
        "oracle_n": args.oracleN,
        "cost": cost,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
