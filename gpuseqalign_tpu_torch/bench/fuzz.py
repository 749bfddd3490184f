"""Randomized differential fuzzer: every algorithm must agree bit-exactly.

Port of gpuseqalign_tpu's ``bench/fuzz.py``. All DP is int32, so every
algorithm of the registry must give the same align cost, score hash, edit
transcript and trace hash for the same input, on the card as on the CPU.
Seeded random cases (substitution matrices, gap costs, spec, degenerate
and awkward shapes, tile parameters) are run through the registry and
checked against the first algorithm, as the CLI checks every algorithm
against the first (errstep 5); every ``--batchEvery``-th case also sends
a random set of pairs through the batch engine and holds each cost
against the dense oracle (``models/oracle.py``).

A seed and a case number give the JAX fuzz's inputs field for field
(``_gen_case`` draws what it draws, in its order, from the same streams).
The port's own draws come from streams 2 and up, so they shift none of
those fields:

- stream 2: in about half the cases ``tpu7_pallas_mlsp`` takes its tile
  from a wider ladder (``TPU7_TILES``) with sides of 1, 2, 3 and odd
  sides, where the single-pair strip kernel (K1) carries between strips
  through scratch;
- stream 3: in the batch cases, an int quantum of ``ODD_QUANTA`` in about
  a third (the batched fill, K5, then gets tiles of odd powers of two from
  ``bucket_scores``' gcd), and in about a quarter a "wide" bucket of 2 to
  3 pairs per SM of the card (132 SMs on the CPU), which
  ``parallel/batch.fill_route`` sends to the tiny-pair fill (K6) on a
  card; the other batch cases' 1 to 8 pairs go to K5 there.

The JAX TPU levers (``giantFlags``, ``v2Flags``) are drawn to keep the
streams aligned, then passed and ignored, as the port ignores TPU-only
keys. The JAX fuzz's guard against XLA:CPU's mmaps has no counterpart.

Usage:
    python -m gpuseqalign_tpu_torch.bench.fuzz [--seconds 300] [--cases 0]
        [--seed 0] [--algs a,b,...] [--includeGiant] [--devices N]
        [--batchEvery 5]

``main(argv, device=None)`` runs on the card and raises without one; pass
``device="cpu"`` to fuzz the kernels' plain versions. An exception in an
algorithm is recorded as a failure. Exit 0 = no disagreements; 1 = at
least one, each printed as one repro line (seed, case, algorithm, spec,
shape, tiles, the first field that differs).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device

# The JAX fuzz's ladders, unchanged (pairs are drawn with replacement).
SIZES = [0, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377]
TILES = [16, 32, 64, 128]
SPECS = ["nw_lg", "nw_ag", "sw_lg", "sw_ag"]

DEFAULT_ALGS = [
    "cpu1_st_row",
    "cpu2_st_diag",
    "cpu4_mt_diagrow",
    "tpu1_xla_diag",
    "tpu2_xla_rowscan",
    "tpu3_pallas_dense",
    "tpu7_pallas_mlsp",
]

# tpu7's tile ladder of stream 2: sides of 1-3 (every hit of the sparse
# traceback's tile-corner fault had one) and sides that no strip height
# of K1 divides.
TPU7_TILES = [1, 2, 3, 5, 7, 16, 32, 48, 64, 128, 256, 512]
# Int quanta of stream 3, besides the JAX "pow2" and 64.
ODD_QUANTA = [7, 24, 40]
# SMs a wide bucket is sized for on the CPU (an H100 SXM's count).
CPU_SMS = 132


def _case_rng(seed: int, case: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream, case]))


def _gen_case(seed: int, case: int) -> dict:
    """The JAX fuzz's case (same draws, same order), plus ``tpu7Tiles``
    from stream 2."""
    rng = _case_rng(seed, case)
    substsz = int(rng.integers(2, 26))
    subst = rng.integers(-10, 13, (substsz, substsz)).astype(np.int32)
    spec = SPECS[int(rng.integers(0, len(SPECS)))]
    affine = spec.endswith("ag")
    gapo = int(rng.integers(-15, 0))  # <= -1
    gape = int(rng.integers(-4, 1)) if affine else 0  # <= 0
    rows = SIZES[int(rng.integers(0, len(SIZES)))]
    cols = SIZES[int(rng.integers(0, len(SIZES)))]

    def seq(n):
        s = np.zeros(1 + n, np.int32)
        if n:
            s[1:] = rng.integers(0, substsz, n)
        return s

    case_d = {
        "subst": subst,
        "substsz": substsz,
        "spec": spec,
        "gapo": gapo,
        "gape": gape,
        "y": seq(rows),
        "x": seq(cols),
        "tileBy": TILES[int(rng.integers(0, len(TILES)))],
        "tileBx": TILES[int(rng.integers(0, len(TILES)))],
        "blocksz": TILES[int(rng.integers(0, len(TILES)))],
        "giantBy": 128 * int(rng.integers(1, 3)),
        "giantBx": 128 * int(rng.integers(1, 3)),
        "giantK": int(rng.integers(1, 3)),
        "giantFlags": {
            k: [1]
            for k in ("packedx", "packedef", "rematHdr")
            if int(rng.integers(0, 2))
        },
        "v2Flags": {
            k: [1]
            for k in ("packedx", "packedef", "rematHdr", "noBc",
                      "subProw")
            if int(rng.integers(0, 2))
        },
    }
    rng2 = _case_rng(seed, case, stream=2)
    case_d["tpu7Tiles"] = (case_d["tileBy"], case_d["tileBx"])
    if int(rng2.integers(0, 2)):
        case_d["tpu7Tiles"] = (
            TPU7_TILES[int(rng2.integers(0, len(TPU7_TILES)))],
            TPU7_TILES[int(rng2.integers(0, len(TPU7_TILES)))])
    return case_d


def _tiles(alg_name: str, case: dict) -> tuple:
    """The (tileBy, tileBx, blocksz or kChains) an algorithm runs at."""
    if alg_name == "tpu9_giant_mlsp":
        return case["giantBy"], case["giantBx"], case["giantK"]
    if alg_name == "tpu7_pallas_mlsp":
        return (*case["tpu7Tiles"], case["blocksz"])
    return case["tileBy"], case["tileBx"], case["blocksz"]


def _run_alg(alg, alg_name: str, case: dict,
             device: Union[str, torch.device] = "cpu"):
    """Run align + hash + trace for one algorithm on ``device``; returns
    the result tuple (cost, score_hash, transcript, trace_hash) or an
    error string."""
    from ..core.types import AlgParams, AlgResult, Status, make_alg_input

    nw = make_alg_input(case["subst"], case["y"], case["x"], case["gapo"],
                        case["gape"], case["spec"], device=str(device))
    res = AlgResult()
    by, bx, third = _tiles(alg_name, case)
    if alg_name == "tpu9_giant_mlsp":
        params = AlgParams({"tileBy": [by], "tileBx": [bx],
                            "kChains": [third], **case["giantFlags"]})
    else:
        params = AlgParams({
            "tileBy": [by], "tileBx": [bx], "blocksz": [third],
            **(case["v2Flags"] if alg_name == "tpu7_pallas_mlsp" else {}),
        })
    try:
        stat = alg.align(params, nw, res)
        if stat != Status.success:
            return f"align {stat!r}"
        stat = alg.hash(nw, res)
        if stat != Status.success:
            return f"hash {stat!r}"
        stat = alg.trace(nw, res, False)
        if stat != Status.success:
            return f"trace {stat!r}"
    except Exception as e:  # noqa: BLE001 — a fuzzer records, not raises
        return f"raised {type(e).__name__}: {e}"
    return (res.align_cost, res.score_hash, res.edit_trace, res.trace_hash)


def _bucket_key(n: int, quantum: "int | str") -> int:
    """A sequence of n residues' padded size in ``bucket_pairs``."""
    from ..parallel.batch import bucket_pairs

    pair = (np.zeros(1 + n, np.int32), np.zeros(1, np.int32))
    return next(iter(bucket_pairs([pair], quantum)))[0]


def _gen_batch_case(seed: int, case: int, sms: int) -> dict:
    """The JAX fuzz's batch case (stream 1), then stream 3's quantum and,
    in about a quarter of the cases, a wide bucket of 2*sms to 3*sms
    live pairs whose sizes share one bucket."""
    from ..core.types import AlignSpec

    rng = _case_rng(seed, case, stream=1)
    substsz = int(rng.integers(2, 26))
    subst = rng.integers(-10, 13, (substsz, substsz)).astype(np.int32)
    spec = AlignSpec.from_name(SPECS[int(rng.integers(0, len(SPECS)))])
    gapo = int(rng.integers(-15, 0))
    gape = int(rng.integers(-4, 1)) if spec.gap.value == "affine" else 0
    n_pairs = int(rng.integers(1, 9))

    def seq(r, n):
        s = np.zeros(1 + n, np.int32)
        if n:
            s[1:] = r.integers(0, substsz, n)
        return s

    pairs = []
    for _ in range(n_pairs):
        r = SIZES[int(rng.integers(0, len(SIZES)))]
        c = SIZES[int(rng.integers(0, len(SIZES)))]
        pairs.append((seq(rng, r), seq(rng, c)))
    quantum = "pow2" if rng.integers(0, 2) else 64

    rng3 = _case_rng(seed, case, stream=3)
    if int(rng3.integers(0, 3)) == 0:
        quantum = ODD_QUANTA[int(rng3.integers(0, len(ODD_QUANTA)))]
    wide = int(rng3.integers(0, 4)) == 0
    if wide:
        live = [s for s in SIZES if s]

        def size_class():
            key = _bucket_key(live[int(rng3.integers(0, len(live)))],
                              quantum)
            return [s for s in live if _bucket_key(s, quantum) == key]

        rows_c, cols_c = size_class(), size_class()
        n_wide = int(rng3.integers(2 * sms, 3 * sms + 1))
        pairs = [
            (seq(rng3, rows_c[int(rng3.integers(0, len(rows_c)))]),
             seq(rng3, cols_c[int(rng3.integers(0, len(cols_c)))]))
            for _ in range(n_wide)
        ]
    return dict(spec=spec, subst=subst, gapo=gapo, gape=gape, pairs=pairs,
                quantum=quantum, wide=wide)


def batch_routes(bc: dict, sms: Optional[int]) -> List[str]:
    """The kernel ``fill_route`` gives each bucket of a batch case that
    reaches one (its pairs with no empty sequence), on a card of ``sms``
    SMs."""
    from ..parallel.batch import bucket_pairs, fill_route

    out = []
    for (rows_p, _), idxs in bucket_pairs(bc["pairs"], bc["quantum"]).items():
        live = [k for k in idxs
                if min(len(a) for a in bc["pairs"][k]) >= 2]
        if live:
            out.append(fill_route(rows_p, len(live), sms))
    return out


def _run_batch_case(seed: int, case: int,
                    device: Union[str, torch.device] = "cpu",
                    sms: int = CPU_SMS) -> "str | None":
    """Fuzz the batch engine on ``device``: the case's pairs through
    align_pairs_batched, each cost checked against the dense oracle.
    Returns an error string or None."""
    from ..models.oracle import align_cost_of, oracle_align_dense
    from ..parallel.batch import align_pairs_batched

    bc = _gen_batch_case(seed, case, sms)
    spec, quantum = bc["spec"], bc["quantum"]
    try:
        out = align_pairs_batched(spec, bc["subst"], bc["pairs"], bc["gapo"],
                                  bc["gape"], quantum=quantum, device=device)
    except Exception as e:  # noqa: BLE001
        return f"batch raised {type(e).__name__}: {e}"
    for k, (y, x) in enumerate(bc["pairs"]):
        want = align_cost_of(spec, oracle_align_dense(
            spec, bc["subst"], y, x, bc["gapo"], bc["gape"]))
        if int(out.costs[k]) != want:
            return (f"{spec.name} pair {k} of {len(bc['pairs'])} "
                    f"({len(y) - 1}x{len(x) - 1}, quantum={quantum}, "
                    f"substsz={bc['subst'].shape[0]}, gapo={bc['gapo']} "
                    f"gape={bc['gape']}) field=cost: {int(out.costs[k])} "
                    f"vs oracle {want}")
    return None


def _short(v) -> str:
    r = repr(v)
    return r if len(r) <= 60 else r[:57] + "..."


def _repro(seed: int, case: int, c: dict, name: str, base_name: str,
           got, base) -> str:
    """One line that re-derives a hit: the case's seed and number, and
    what differs."""
    head = (f"FAIL seed={seed} case={case} alg={name} {c['spec']} "
            f"{len(c['y']) - 1}x{len(c['x']) - 1} gapo={c['gapo']} "
            f"gape={c['gape']} substsz={c['substsz']} "
            f"tiles={_tiles(name, c)}")
    if isinstance(got, str):
        return f"{head} field=status: {got}"
    if isinstance(base, str):
        return f"{head} field=status: baseline {base_name} -> {base}"
    k = next(i for i in range(4) if got[i] != base[i])
    lab = ("cost", "score_hash", "transcript", "trace_hash")[k]
    return (f"{head} field={lab}: {name}={_short(got[k])} "
            f"{base_name}={_short(base[k])}")


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    import argparse

    from ..core.registry import get_algorithm_map, mlsp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0,
                    help="time budget (0 = unlimited, use --cases)")
    ap.add_argument("--cases", type=int, default=0,
                    help="case budget (0 = unlimited, use --seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--algs", default=",".join(DEFAULT_ALGS))
    ap.add_argument("--includeGiant", action="store_true",
                    help="also run tpu9_giant_mlsp")
    ap.add_argument("--devices", type=int, default=0,
                    help="bands of --includeGiant's engine, all on the one "
                         "device (0 = 1)")
    ap.add_argument("--batchEvery", type=int, default=5,
                    help="every Nth case additionally fuzzes the batch "
                         "engine (align_pairs_batched vs the oracle; "
                         "0 = never)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    alg_map = get_algorithm_map()
    names = [a for a in args.algs.split(",") if a]
    if args.includeGiant and "tpu9_giant_mlsp" not in names:
        names.append("tpu9_giant_mlsp")
    unknown = [a for a in names if a not in alg_map]
    if unknown:
        ap.error(f"unknown algorithms: {unknown}")
    algs = {name: alg_map[name] for name in names}
    if args.devices > 1 and "tpu9_giant_mlsp" in algs:
        from ..parallel import make_mesh
        from ..parallel.giant2 import align_giant2

        mesh = make_mesh(devices=[dev] * args.devices, axis_name="sp")
        algs["tpu9_giant_mlsp"] = mlsp(
            lambda pr, nw, res: align_giant2(pr, nw, res, mesh=mesh))
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else CPU_SMS)

    deadline = time.time() + args.seconds if args.seconds else None
    n_fail = 0
    case = 0
    t0 = time.time()
    while True:
        if deadline and time.time() >= deadline:
            break
        if args.cases and case >= args.cases:
            break
        if args.batchEvery and case % args.batchEvery == 0:
            err = _run_batch_case(args.seed, case, dev, sms)
            if err:
                n_fail += 1
                print(f"FAIL seed={args.seed} case={case} alg=batch {err}")
        c = _gen_case(args.seed, case)
        results = {name: _run_alg(alg, name, c, dev)
                   for name, alg in algs.items()}
        base_name = names[0]
        base = results[base_name]
        if isinstance(base, str):
            n_fail += 1
            print(_repro(args.seed, case, c, base_name, base_name, base,
                         base))
        else:
            for name in names[1:]:
                if results[name] != base:
                    n_fail += 1
                    print(_repro(args.seed, case, c, name, base_name,
                                 results[name], base))
        case += 1
        if case % 50 == 0:
            rate = case / (time.time() - t0)
            print(f"[fuzz] {case} cases, {n_fail} failures, "
                  f"{rate:.1f} cases/s", flush=True)

    print(f"[fuzz] DONE: {case} cases, {n_fail} failures "
          f"in {time.time() - t0:.0f}s (seed {args.seed})", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
