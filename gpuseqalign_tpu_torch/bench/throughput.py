"""Batch throughput benchmark: aligned pairs/s on CUDA cards.

Aligns every pair of a pair file (or of a seeded synthetic set) through the
batch engine (``parallel/batch.py``: shape-bucketed, one kernel per
bucket; over a mesh of --devices entries when given) and reports pairs/s
and aggregate GCUPS (live cells) over the median of --repeat timed
windows, beside the best window and every window's time. Costs are
verified against the CPU oracle for --verify sampled pairs. Each timed
window ends with a synchronise of the devices; a warm-up call first builds
the kernels, so nvcc is never timed.

--giantStream routes the pair list through the giant-pair engine instead,
as one pipelined stream (``parallel/giant2.align_giant2_stream``) over a
mesh of --devices bands; --giantSequential is its baseline, one
``align_giant2`` call per pair on the same mesh. The stream pads every
pair to the widest band to pay the band pipeline's fill and drain once,
so with one band (the default), which has no pipeline, --giantStream
takes one call a pair too.

Usage:
    python -m gpuseqalign_tpu_torch.bench.throughput \\
        --seqPath resrc/seq_generated.fa --seqPairPath resrc/pair_generated_1.txt \\
        [--algKind nw_lg] [--quantum pow2] [--verify 5] \\
        [--jsonPath out.json] [--devices N] \\
        [--giantStream | --giantSequential]

``main(argv, device=None)`` runs on the cards and raises without one; pass
``device="cpu"`` to run the kernels' plain versions on the CPU (a mesh of
--devices entries then names the CPU that many times).
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device, synchronize

# Seed of --synthPairs, shared with gpuseqalign_tpu's benchmark so that
# both draw the same pairs.
SYNTH_SEED = 20260817

Pairs = List[Tuple[np.ndarray, np.ndarray]]


def synth_pairs(n_pairs: int, lmin: int, lmax: int, substsz: int) -> Pairs:
    """``n_pairs`` seeded random pairs, lengths uniform in [lmin, lmax]."""
    rng = np.random.default_rng(SYNTH_SEED)
    pairs = []
    for _ in range(n_pairs):
        r = int(rng.integers(lmin, lmax + 1))
        c = int(rng.integers(lmin, lmax + 1))
        y = np.zeros(1 + r, np.int32)
        y[1:] = rng.integers(0, substsz, r)
        x = np.zeros(1 + c, np.int32)
        x[1:] = rng.integers(0, substsz, c)
        pairs.append((y, x))
    return pairs


def file_pairs(seq_path: str, pair_path: str, letter_map) -> Pairs:
    """The pairs of a pair file (all-vs-first when ``pair_path`` is empty),
    each sequence with its header element."""
    from ..bench.driver import vector_substring_with_header
    from ..io.fasta import parse_seq_file
    from ..io.pairs import default_pairs, parse_seq_pair_file

    seq_data = parse_seq_file(seq_path, letter_map)
    if pair_path:
        pair_list = parse_seq_pair_file(pair_path, seq_data.seq_map)
    else:
        pair_list = default_pairs(seq_data.seq_map)
    return [
        (vector_substring_with_header(seq_data.seq_map[p.seqY_id].seq,
                                      p.seqY_range),
         vector_substring_with_header(seq_data.seq_map[p.seqX_id].seq,
                                      p.seqX_range))
        for p in pair_list
    ]


def live_cells(pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> int:
    return sum((len(y) - 1) * (len(x) - 1) for y, x in pairs)


def _verify(args, spec, subst, pairs, costs, idxs) -> int:
    """Mismatches of ``costs`` against the CPU oracle on ``idxs``."""
    from ..models.oracle import align_cost_of, oracle_align_dense

    n_bad = 0
    for i in idxs:
        y, x = pairs[i]
        mats = oracle_align_dense(spec, subst, y, x, args.gapoCost,
                                  args.gapeCost)
        want = align_cost_of(spec, mats)
        if costs[i] != want:
            n_bad += 1
            print(f"MISMATCH pair {i}: {costs[i]} vs oracle {want}",
                  file=sys.stderr)
    return n_bad


def _run_streaming(args, spec, subst, letter_map, dev) -> int:
    """Streaming all-vs-first throughput: constant host memory.

    The first record is the shared X (ref default pairing,
    src/cmd_parser.cpp:467-499 aligns every sequence with the first);
    subsequent records are chunked and aligned per chunk.
    """
    from ..io.fasta import iter_seq_file
    from ..parallel import align_pairs_batched

    if dev.type == "cuda":
        from ..ops import build

        build.build_all(["strip_fill", "mlsp_tiny"])
    first = None
    chunk: Pairs = []
    n_pairs = cells = n_bad = n_verified = 0
    # Timed window = the align calls only: the O(n^2) CPU-oracle
    # verification and the FASTA parse must not deflate the reported
    # pairs/s.
    t = 0.0

    mesh = _mesh(args.devices, dev, "pairs") if args.devices else None

    def run_chunk(pairs):
        nonlocal t
        t0 = time.perf_counter()
        out = align_pairs_batched(
            spec, subst, pairs, args.gapoCost, args.gapeCost,
            quantum=args.quantum, device=None if mesh else dev, mesh=mesh)
        for d in mesh.devices if mesh else (dev,):
            synchronize(d)
        t += time.perf_counter() - t0
        return out

    for seq in iter_seq_file(args.seqPath, letter_map):
        if first is None:
            first = seq
            continue
        chunk.append((seq.seq, first.seq))
        if len(chunk) >= args.stream:
            out = run_chunk(chunk)
            if args.verify and n_verified < args.verify:
                n_bad += _verify(args, spec, subst, chunk, out.costs, [0])
                n_verified += 1
            n_pairs += len(chunk)
            cells += live_cells(chunk)
            chunk = []
    if chunk:
        run_chunk(chunk)
        n_pairs += len(chunk)
        cells += live_cells(chunk)
    print(
        f"{args.algKind} (streamed, chunk={args.stream}): {n_pairs} pairs "
        f"in {t * 1e3:.1f} ms align time -> {n_pairs / t:.1f} pairs/s, "
        f"{cells / t / 1e9:.2f} GCUPS agg"
        + (f", {n_bad} verify mismatches" if n_bad else ", verify ok")
    )
    return 1 if n_bad else 0


def _mesh(n: int, dev: torch.device, axis_name: str):
    """A mesh of n entries: the first n cards, or the CPU n times."""
    from ..parallel import make_mesh

    if dev.type == "cpu":
        return make_mesh(devices=[dev] * n, axis_name=axis_name)
    return make_mesh(n, axis_name=axis_name)


def _run_giant_stream(args, spec, subst, pairs, dev,
                      sequential: bool = False) -> int:
    """The pair list through the giant-pair engine on a mesh of
    --devices bands: one pipelined stream (``align_giant2_stream``) when
    the mesh has D > 1 bands, else (or when ``sequential``) one
    ``align_giant2`` call per pair. Pairs/s over the median of --repeat
    windows, each ending with a synchronise."""
    from ..core.types import AlgParams, AlgResult, Status, make_alg_input
    from ..parallel import align_giant2, align_giant2_stream

    mesh = _mesh(args.devices or 1, dev, "sp")
    inputs = [make_alg_input(subst, y, x, args.gapoCost, args.gapeCost,
                             args.algKind, device=str(dev))
              for y, x in pairs]
    params = AlgParams({})
    stream = not sequential and mesh.size > 1

    def run():
        results = [AlgResult() for _ in inputs]
        if not stream:
            stats = [align_giant2(params, nw, res, mesh=mesh)
                     for nw, res in zip(inputs, results)]
        else:
            stats = align_giant2_stream(params, inputs, results, mesh=mesh)
        if any(s != Status.success for s in stats):
            raise RuntimeError(f"giant statuses: {stats}")
        return results

    results = run()  # warm-up: builds and loads the kernel
    ts = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        results = run()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    costs = np.array([r.align_cost for r in results], np.int32)
    n_bad = 0
    if args.verify:
        idxs = np.linspace(0, len(pairs) - 1, min(args.verify, len(pairs)))
        n_bad = _verify(args, spec, subst, pairs, costs,
                        sorted({int(v) for v in idxs}))
    cells = live_cells(pairs)
    mode = "giant stream" if stream else "giant sequential"
    print(
        f"{args.algKind} ({mode}, D={mesh.size}): {len(pairs)} pairs in "
        f"{t * 1e3:.1f} ms (median of {len(ts)}; best {min(ts) * 1e3:.1f} "
        f"ms; windows " + ", ".join(f"{v * 1e3:.1f}" for v in ts)
        + f" ms) -> {len(pairs) / t:.1f} pairs/s, {cells / t / 1e9:.2f} "
        f"GCUPS agg" + (f", {n_bad} verify mismatches" if n_bad
                        else ", verify ok")
    )
    if args.jsonPath:
        with open(args.jsonPath, "w") as f:
            json.dump({
                "alg_kind": args.algKind, "device": str(dev), "mode": mode,
                "bands": mesh.size, "pairs": len(pairs), "live_cells": cells,
                "seconds": t, "seconds_best": min(ts), "seconds_all": ts,
                "pairs_per_s": len(pairs) / t, "gcups": cells / t / 1e9,
                "verify_mismatches": n_bad, "costs": costs.tolist(),
                "best_i": [nw.best_i for nw in inputs],
                "best_j": [nw.best_j for nw in inputs],
            }, f)
    return 1 if n_bad else 0


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    import argparse

    from ..core.types import AlignSpec
    from ..io.subst import parse_subst_file
    from ..parallel import align_pairs_batched

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seqPath", required=True)
    ap.add_argument("--seqPairPath", default="")
    ap.add_argument("--substPath", default="./resrc/subst.json")
    ap.add_argument("--substName", default="blosum62")
    ap.add_argument("--gapoCost", type=int, default=-11)
    ap.add_argument("--gapeCost", type=int, default=-2)
    ap.add_argument("--algKind", default="nw_lg")
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh size: the batch engine shares each bucket "
                         "over the first N cards (0 = one device); the "
                         "giant engine runs N bands (0 = 1)")
    ap.add_argument("--quantum", default="pow2",
                    help='int (linear padding) or "pow2" (geometric)')
    ap.add_argument("--repeat", type=int, default=5,
                    help="timed windows; pairs/s is over their median")
    ap.add_argument("--verify", type=int, default=5,
                    help="verify N sampled pairs against the CPU oracle")
    ap.add_argument("--stream", type=int, default=0, metavar="CHUNK",
                    help="stream the FASTA (io.fasta.iter_seq_file) and "
                         "align all-vs-first pairs in chunks of CHUNK — "
                         "O(chunk) host memory for corpora larger than "
                         "RAM; incompatible with --seqPairPath")
    ap.add_argument("--synthPairs", default="", metavar="N,LMIN,LMAX",
                    help="benchmark N seeded random pairs with lengths "
                         "uniform in [LMIN, LMAX] instead of a pair "
                         "file — the many-small-pairs workload of the "
                         "tiny-pair kernel")
    ap.add_argument("--giantStream", action="store_true",
                    help="route the pair list through ONE pipelined "
                         "giant-pair fill (align_giant2_stream) on a "
                         "--devices band mesh instead of the batch engine, "
                         "for streams of pairs too large to batch; with "
                         "one band, one align_giant2 call per pair")
    ap.add_argument("--giantSequential", action="store_true",
                    help="baseline of --giantStream: one align_giant2 call "
                         "per pair on the same mesh")
    ap.add_argument("--jsonPath", default="",
                    help="also write the timing and every pair's cost, "
                         "best_i and best_j to this JSON file")
    args = ap.parse_args(argv)
    if args.quantum != "pow2":
        args.quantum = int(args.quantum)
    dev = resolve_device(device)

    spec = AlignSpec.from_name(args.algKind)
    subst_data = parse_subst_file(args.substPath)
    subst = subst_data.subst_map[args.substName]

    if args.stream:
        if args.seqPairPath:
            ap.error("--stream only supports default all-vs-first pairing")
        return _run_streaming(args, spec, subst, subst_data.letter_map, dev)

    if args.synthPairs:
        n_pairs, lmin, lmax = (int(v) for v in args.synthPairs.split(","))
        pairs = synth_pairs(n_pairs, lmin, lmax, subst.shape[0])
    else:
        pairs = file_pairs(args.seqPath, args.seqPairPath,
                           subst_data.letter_map)
    cells = live_cells(pairs)
    if args.giantStream or args.giantSequential:
        return _run_giant_stream(args, spec, subst, pairs, dev,
                                 sequential=args.giantSequential)
    mesh = _mesh(args.devices, dev, "pairs") if args.devices else None

    def run():
        out = align_pairs_batched(
            spec, subst, pairs, args.gapoCost, args.gapeCost,
            quantum=args.quantum, device=None if mesh else dev, mesh=mesh)
        for d in mesh.devices if mesh else (dev,):
            synchronize(d)
        return out

    out = run()  # warm-up: builds and loads the kernels
    ts = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        out = run()
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))

    n_bad = 0
    if args.verify:
        idxs = np.linspace(0, len(pairs) - 1, min(args.verify, len(pairs)))
        n_bad = _verify(args, spec, subst, pairs, out.costs,
                        sorted({int(v) for v in idxs}))

    print(
        f"{args.algKind}: {len(pairs)} pairs in {t * 1e3:.1f} ms (median of "
        f"{len(ts)}; best {min(ts) * 1e3:.1f} ms; windows "
        + ", ".join(f"{v * 1e3:.1f}" for v in ts)
        + f" ms) -> {len(pairs) / t:.1f} pairs/s, {cells / t / 1e9:.2f} "
        f"GCUPS agg, {out.n_buckets} shape buckets"
        + (f", {n_bad} verify mismatches" if n_bad else ", verify ok")
    )
    if args.jsonPath:
        with open(args.jsonPath, "w") as f:
            json.dump({
                "alg_kind": args.algKind, "device": str(dev),
                "pairs": len(pairs), "live_cells": cells, "seconds": t,
                "seconds_best": min(ts), "seconds_all": ts,
                "pairs_per_s": len(pairs) / t,
                "gcups": cells / t / 1e9, "n_buckets": out.n_buckets,
                "verify_mismatches": n_bad,
                "costs": out.costs.tolist(), "best_i": out.best_i.tolist(),
                "best_j": out.best_j.tolist(),
            }, f)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
