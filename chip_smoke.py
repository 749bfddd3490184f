#!/usr/bin/env python3
"""Smoke run of gpuseqalign_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py [--phases build,kernels,cli,full,throughput,giant,probe,tools,scaling,dbsearch]

Run from the root of a checkout on a machine with one NVIDIA H100 (CUDA
toolkit with nvcc; the kernels are built from the checkout's sources).
Phases, each of which makes the script exit non-zero if it fails:

  1. build      every kernel under gpuseqalign_tpu_torch/ops/csrc, one
                nvcc per source, started together
  2. kernels    each kernel against its plain PyTorch version on the card,
                all four specs, several shapes: bit-exact (int32, no
                tolerance). mlsp_fill (K1, the strip kernel's pair entry:
                tiles from 1x1, 3x5, tile_w < 32 and tile_h 16 to 288x40,
                the 1x600 / 600x1 tile-corner pairs, one call of 201
                strips; each case 3 times),
                mlsp_fill_batch (K5, the strip kernel: a bucket of pairs
                with headers and cost-only, ragged live regions, tile_h
                128, 16 and 1, a tall bucket of 201 strips, each case 3
                times; also held pair by pair against mlsp_fill),
                mlsp_tiny (K6, cost-only, small pairs: one warp a pair,
                its row strips in turn; every case at 1-4 warps a block,
                3 times each: ragged live rows, pairs one
                row taller than a strip, 1-row and 1-column partners, SW
                ties across lane and strip boundaries, a bucket that fills
                every SM 8 times beside a one-pair bucket, a 1000 x 20000
                bucket whose carry rows go to global scratch; then the
                engine's route by launch counters: the one-pair bucket
                through mlsp_fill_batch, the full one through mlsp_tiny),
                dense_fill (K3, the
                strip kernel's dense entry: the full H of one pair against
                rowscan_dense, ragged strips and chunks, a pair of 202
                strips, other strip heights and warps a block on two
                shapes; each case 3 times),
                banded_pass (K7, the strip kernel: chains of
                passes over column bands, each band's halo from the band to
                its left, the SW clamp, 1x1 and 5x300, one call of several
                passes' rows, one call of 200 strips, each
                chain 3 times; chains of D > 1 bands also through
                giant2_fill on D streams of the one card) and the v1
                wavefront fills mlsp_nw_lg_fill (K2) and dense_nw_lg_fill
                (K4, nw_lg only; the row-strip kernel of wavefront.cu),
                every output element, on profiles of slices of the release
                sequence: R 128/256/1024/2048/4096, TW from R to 2R (and
                512), W 128/256/512, gapo -11/-1/0, a pair shorter than a
                row block, one tile column, one row, 1x1, one call of 200
                strips; each case 3 times; then banded_pass timed against
                its plain version on the whole band of a 23728 x 23728
                pair (D = 1), every spec
  3. cli        the single-pair paths: bench.cli.main on the card for
                nw_lg, nw_ag, sw_lg, sw_ag with cpu1_st_row as the
                reference, the sparse names and the dense ones (tpu1, tpu2,
                tpu3, a Gpu3-6 alias), score hash and traceback, and
                resrc/param_best.json whole (all 13 reference names) for
                nw_lg; err_step must be 0 in every row and both single-pair
                kernels must have launched
  4. full size  resrc/pair_release.txt (23728 x 23728) through the CLI for
                nw_lg (cpu1_st_row, tpu7_pallas_mlsp, tpu3_pallas_dense,
                tpu9_giant_mlsp),
                then each single-pair kernel against its plain version at
                that size for every spec, timed with CUDA events, with its
                launches a fill: K1's pair entry in turns with the batch
                entry's route (mlsp_fill_batch with headers, one pair), K3
                at its default schedule and swept over strip heights and
                warps a block; tests/test_torch_mlsp_card.py (the
                tile headers' hand-off: pinned, counted, equal to the CPU
                align's, every spec); then the
                pair through the v1 flows (wavefront.align_mlsp at 128x512,
                wavefront.align_dense at R 1024) in the registry's sparse
                and dense bundles, cost, score hash and trace hash equal
                to cpu1_st_row's, one launch a fill, with laps and peak
                device memory, and K2 and K4 timed against their plain
                versions at that size (launches a fill, bound, share of
                bound)
  5. launches   the single-pair paths' runs went through their kernels,
                the v1 flows through K2 and K4, one launch a fill
  6. throughput the batch path: bench.throughput.main on the card for
                resrc/pair_generated_1.txt (all four specs, pow2 buckets,
                oracle check of 5 pairs) and 16384 synthetic pairs of
                300-500 residues (all four specs); every pair's cost and
                best cell held against scores_batch_plain on the card,
                bucket by bucket; pairs/s over the median of 5 windows,
                with every window; each kernel's CUDA-event time per
                bucket (by the engine's route, parallel/batch.fill_route)
                and its bound over the live cells; every kernel the route
                gives a bucket must have launched in the run. Then
                mlsp_fill_batch timed against its plain version, mlsp_tiny's
                schedule sweep (warps a block, beside K5 and the engine's
                pick) over bucket sizes, and a torch.profiler
                trace of three synth_16384 nw_ag windows (device idle share,
                host time of each step of the engine)
  7. giant      the giant-pair engine: tpu9_giant_mlsp beside cpu1_st_row
                through the CLI (the cli phase's pairs, every spec); a
                100000 x 100000 pair (numpy, fixed seed) through
                align_giant2 at D = 1 for every spec, its layout held
                against mlsp_fill's (K1) at the same tile, nw_ag's sparse
                trace against tpu7_pallas_mlsp's, the fill timed with CUDA
                events and held against banded_pass_plain; D = 2 and 4
                bands on the one card (23728^2 every spec, 100000^2 nw_ag;
                a band's K7 call holds C passes, pick_call_passes) held
                against D = 1, each D's fill ms, C, calls and launches
                (D x calls); --giantStream
                and --giantSequential on pair_generated_1 nw_ag (one band:
                both one call a pair), then align_giant2_stream against
                align_giant2 on two bands of the one card; the batch
                engine on a two-entry mesh against no mesh;
                align_pairs_multihost in two processes on the one card;
                and align_giant2 on the release pair (nw_ag) over a mesh
                that spans two gloo processes on the one card (D = 4, two
                bands a process, the halo through pinned host memory),
                both ranks' cost, hashes and transcript equal to D = 1's
  8. probe      the step-body probes (K8a-d, ops/csrc/probe.cu): every
                probe entry, body, variant, strip count and rows a lane
                (strips of 32 to 256 rows; 1, 33, 45 and 64 columns, a
                part chunk of 32 steps and whole ones) against its plain
                version, bit-exact; the skeleton and fullstep strips, 256
                rows among them, against the oracle on the same letters;
                then bench.vpu_probe's ops, skeleton K sweeps, fullstep
                variants, int16, roofline_body for the four specs (the
                warp strip swept over rows a lane, strips a block and
                blocks a SM) and
                probe_gridcost (K1 at 23728^2 and one strip alone, nw_lg
                and nw_ag: body, machinery, a strip step, the lag), the
                compiler's resources and SASS opcodes of each probe
                kernel and the opcodes of each strip kernel's hot loop
                (logs/chip_smoke/probe_sass.json; the strip kernels'
                SASS in probe_sass_strips.txt.gz), and bench.headline
                once (nw_ag at 23728^2, its JSON line); every probe
                kernel must have launched, and each is then timed
                against its plain version on one card-sized call (K8b
                and K8c also at the grids their earlier thread-a-row
                design was timed at); every fill's GCUPS beside
                its spec's body (body_shares, and body_over_fill: the
                fills faster than their body, logged, not failed)
  9. tools      the user's tools on the card: bench.fuzz (a fixed seed,
                --includeGiant; its cases hold a tpu7 tile side <= 3,
                batch buckets that fill_route sends to K5 and to K6, and
                the giant engine in every case) must report 0 failures
                with K1, K3, K5, K6 and K7 launched; tune_v2 and
                tune_banded (nw_ag) on reduced grids, every tile gated on
                the oracle, each tile's ms and the winner printed, the
                entries saved under a temporary root and read back; and
                giant_demo's 100000^2 nw_ag fill, its first tile-header
                row held against the plain fill of the same rows
 10. scaling    bench.scaling_report at its full sizes on the card: the
                batch engine on one card, on a two-entry mesh and in two
                gloo processes (pair_generated_1), the 100000^2 giant pair
                at D = 1 and 4 beside the call model, and a stream at
                D = 4 against one call a pair; every row from a fresh
                subprocess, naming what it ran on, logged
 11. dbsearch   the database search (parallel/dbsearch.py) on the traffic
                of the benchmark's cell swissprot_search.dbsearch (its
                five queries against its 65 536 subjects, one fixed seed)
                and on a database of homologs (each query's own copy,
                copies with 10% and 30% of the residues replaced, a block
                deleted, a block inserted, among random subjects; a
                464-residue query and a 7000-residue one, whose self score
                passes 32 767): load_db once (DB_LOADS + 1), every query
                through search_db with the launch counters zeroed just
                before, K5 and K6 launched as fill_route gives each bucket,
                SEARCH_H2D_BYTES the queries' bytes and the matrix once;
                then every bucket of the database at its full size, for
                every query, through tiny_scores (K6) and mlsp_fill_batch
                (K5) at row stride 0 against scores_batch_plain on the
                same inputs, and the search's answers for the bucket's
                subjects against the same, bit-exact

With every phase run (the default), the line before the last is a JSON
object describing every kernel and the last line is the contract line
{"ok": true, "device": {...}}. Outputs go to logs/chip_smoke/ inside the
checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RESRC = os.path.join(HERE, "resrc")
OUT = os.path.join(HERE, "logs", "chip_smoke")
SPECS = ("nw_lg", "nw_ag", "sw_lg", "sw_ag")
PHASES = ("build", "kernels", "cli", "full", "throughput", "giant",
          "probe", "tools", "scaling", "dbsearch")
GAPO = -11
GAPE = {"nw_lg": 0, "sw_lg": 0, "nw_ag": -2, "sw_ag": -2}

# H100 SXM peak (NVIDIA data sheet): 3.35 TB/s HBM3. The operations
# peak is ``bench.vpu_probe.ISSUE_INSNS_PER_S``, the card's instruction
# issue rate.
HBM_BYTES_PER_S = 3.35e12
# The dense single-pair names the CLI phase adds to the sparse ones.
DENSE_PARAMS = {"tpu1_xla_diag": {}, "tpu2_xla_rowscan": {},
                "tpu3_pallas_dense": {},
                "NwAlign_Gpu5_Coop_DiagDiag": {"tileAx": [52]}}
# The reference's release pair (len23728 x len23728), bench.py's size.
RELEASE_PAIRS = os.path.join(RESRC, "pair_release.txt")
FULL_N = 23728
# The release pair's sequence, and K2/K4's grid of row blocks R with the
# tile widths TW held at each (TW >= R; 512 where it is).
RELEASE_SEQ = "len23728"
WAVEFRONT_GRID = ((128, (128, 256, 512)), (256, (256, 512)),
                  (1024, (1024, 2048)), (2048, (2048, 4096)))
# The batch path's runs: (name, throughput arguments, specs).
SEQS = os.path.join(RESRC, "seq_generated.fa")
THROUGHPUT_RUNS = (
    ("pair_generated_1",
     ["--seqPairPath", os.path.join(RESRC, "pair_generated_1.txt")], SPECS),
    ("synth_16384", ["--synthPairs", "16384,300,500"], SPECS),
)
# The giant pair of BASELINE.json's config 5 (100k x 100k), made with
# numpy from a fixed seed over the blosum62 alphabet.
GIANT_N = 100000
GIANT_SEED = 20261016
# Runs of every K5/K7 case against its plain version: their strips run
# concurrently, so a race shows as a rare mismatch, not a crash.
REPEATS = 3
# K7's cases against its plain version: rows, cols (residues), R, TW,
# band_cols, D bands, BL row blocks a call.
BANDED_CASES = (
    (200, 120, 128, 128, 128, 1, 2),    # one pass, band_cols = TW
    (700, 1000, 128, 128, 384, 3, 2),   # 3 passes x 3 bands, real halos;
                                        # SW clamp on bands 0 and 1
    (700, 1000, 128, 128, 384, 3, 6),   # one call of 3 passes' rows
    (600, 700, 256, 128, 384, 2, 1),    # R = 256
    (300, 500, 128, 256, 512, 1, 3),    # TW = 256
    (1, 1, 128, 128, 128, 2, 2),        # 1 x 1 (band 1 all padding)
    (5, 300, 128, 128, 256, 2, 1),      # 5 x 300
    (25600, 300, 128, 128, 384, 1, 200),  # tall: one call of 200 strips
)
# The database search's phase: the benchmark cell whose traffic it runs,
# a seed of its own, and the homolog database's queries (residues) and
# random subjects (the cell's first lengths).
DBSEARCH_CELL = ("swissprot_search", "dbsearch")
DBSEARCH_SEED = 3000000419
DBSEARCH_HOMOLOG_QUERIES = (464, 7000)
DBSEARCH_HOMOLOG_RANDOM = 1000



def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def read_tsv(path: str):
    with open(path) as f:
        lines = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    return [dict(zip(lines[0], row)) for row in lines[1:]]


def padded_inputs(torch, subst, rows, cols, th, tw, seed):
    """Random header-prefixed sequences, zero-padded to tile multiples,
    on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    trows, tcols = max(1, -(-rows // th)), max(1, -(-cols // tw))
    y = np.zeros(1 + trows * th, np.int32)
    x = np.zeros(1 + tcols * tw, np.int32)
    y[1:rows + 1] = rng.integers(0, subst.shape[0], rows)
    x[1:cols + 1] = rng.integers(0, subst.shape[0], cols)
    return torch.from_numpy(y).cuda(), torch.from_numpy(x).cuda()


def random_pairs(sizes, S, seed):
    """Header-prefixed random pairs of the given residue counts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(np.concatenate([[0], rng.integers(0, S, r)]).astype(np.int32),
             np.concatenate([[0], rng.integers(0, S, c)]).astype(np.int32))
            for r, c in sizes]


def kind_gap(spec):
    kind, gap = spec.split("_")
    return dict(kind=kind, gap="affine" if gap == "ag" else "linear")


def fill_args(spec, rows, cols, th, tw):
    return dict(gapo=GAPO, gape=GAPE[spec], adjr=rows + 1, adjc=cols + 1,
                tile_h=th, tile_w=tw, **kind_gap(spec))


def max_abs_diff(torch, a, b) -> int:
    if a.keys() != b.keys():
        fail(f"output keys differ: {sorted(a)} vs {sorted(b)}")
    err = 0
    for k in a:
        if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype:
            fail(f"{k}: shape/dtype {a[k].shape}/{a[k].dtype} vs "
                 f"{b[k].shape}/{b[k].dtype}")
        err = max(err, int((a[k].long() - b[k].long()).abs().max()))
    return err


def cuda_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cell_insns(spec: str) -> int:
    """int32 instructions a DP cell of ``spec`` issues on sm_90a, the unit
    of every operations bound here: the recurrence's operations with each
    add that feeds a max fused into one DPX VIADDMNMX
    (``bench.vpu_probe.INSNS_PER_CELL``: 3, 4, 6, 7)."""
    from gpuseqalign_tpu_torch.bench.vpu_probe import INSNS_PER_CELL

    return INSNS_PER_CELL[spec]


def bound(nbytes: float, ops: float, peak: float = None) -> tuple:
    """(ms, "operations"|"bytes"): the larger of the two least times;
    ``ops`` counts int32 instructions issued, at ``peak`` a second (by
    default the card's issue rate)."""
    from gpuseqalign_tpu_torch.bench.vpu_probe import ISSUE_INSNS_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (peak or ISSUE_INSNS_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes")


def header_words(spec, rows_p, cols_p, th, tw) -> int:
    """Words of tile headers one pair's sparse fill writes."""
    trows, tcols = rows_p // th, cols_p // tw
    words = trows * (1 + cols_p) + trows * th * tcols
    words *= 2 if spec.endswith("ag") else 1
    return words + (3 * trows * tcols if spec.startswith("sw") else 0)


def bound_ms(spec, rows_p, cols_p, th, tw, S) -> tuple:
    """Least time for the single-pair fill. Bytes: each input read once,
    each output written once; operations: the int32 instructions of the
    recurrence over every cell the fill computes."""
    nbytes = 4 * (S * S + rows_p + cols_p + 2
                  + header_words(spec, rows_p, cols_p, th, tw))
    return bound(nbytes, cell_insns(spec) * rows_p * cols_p)


def live_cells(pairs, idxs) -> int:
    """Cells of the pairs' own DP matrices, sum of (adjr-1)(adjc-1)."""
    return sum((len(pairs[k][0]) - 1) * (len(pairs[k][1]) - 1) for k in idxs)


def bucket_work(spec, pairs, idxs, rows_p, cols_p, S, headers=False
                ) -> tuple:
    """(bytes, int32 instructions) of one call on a bucket: inputs
    (sequences, lengths) read once; outputs written once: cost and best,
    plus the tile headers of every pair when the call returns them.
    Operations: the recurrence over the cells the outputs need, the live
    cells for cost and best, every padded cell for the headers (their
    padded region is part of their layout)."""
    b = len(idxs)
    out_words = 4 * b
    cells = live_cells(pairs, idxs)
    if headers:
        th, tw = math.gcd(rows_p, 128), math.gcd(cols_p, 512)
        out_words += b * header_words(spec, rows_p, cols_p, th, tw)
        cells = b * rows_p * cols_p
    nbytes = 4 * (S * S + b * (rows_p + cols_p + 4) + out_words)
    return nbytes, cell_insns(spec) * cells


def run_cli(main, spec, params, pair_lines, name):
    """bench.cli.main on the card; ``params`` is a dict of algorithm
    parameters or the path of a parameter file."""
    os.makedirs(OUT, exist_ok=True)
    param_path = os.path.join(OUT, f"{name}_params.json")
    pair_path = os.path.join(OUT, f"{name}_pairs.txt")
    tsv = os.path.join(OUT, f"{name}.tsv")
    if isinstance(params, str):
        param_path = params
    else:
        with open(param_path, "w") as f:
            json.dump(params, f)
    with open(pair_path, "w") as f:
        f.write("\n".join(pair_lines) + "\n")
    argv = [
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--algParamPath", param_path,
        "--seqPath", SEQS,
        "--seqPairPath", pair_path,
        "--resPath", tsv,
        "--algKind", spec, "--gapoCost", str(GAPO),
        "--gapeCost", str(GAPE[spec]),
        "--fCalcScoreHash", "--fCalcTrace",
    ]
    rc = main(argv)
    rows = read_tsv(tsv) if os.path.exists(tsv) else []
    if rc != 0:
        fail(f"cli {name}: exit {rc}")
    bad = [(r["alg_name"], r["seqY_id"], r["seqX_id"], r["err_step"],
            r["error_msg"]) for r in rows if r["err_step"] != "0"]
    if not rows or bad:
        fail(f"cli {name}: err_step != 0 in {bad or 'no rows'}")
    return rows


def check_single_kernel(torch, subst, subst_np) -> int:
    """mlsp_fill (K1, strip_fill_pair) against mlsp_fill_plain, each case
    REPEATS times; returns the number of cases."""
    from gpuseqalign_tpu_torch.ops import mlsp_cuda
    from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain

    shapes = [  # rows, cols, tile_h, tile_w
        (2000, 3000, 128, 512),
        (777, 2049, 64, 76),
        (300, 700, 288, 40),  # tile taller than a strip: carry scratch
        (64, 13000, 32, 13000),
        (1, 1, 128, 512),
        (50, 1, 128, 512),    # adjc == 2
        (97, 300, 1, 1),      # tile 1 x 1: strips of 32 rows
        (400, 350, 3, 5),     # tile 3 x 5: carry scratch
        (500, 800, 128, 20),  # tile_w < 32
        (600, 500, 16, 64),   # tile_h 16
        (1, 600, 128, 512),   # the tile-corner pairs (ROADMAP Queue 3)
        (600, 1, 512, 128),
        (6430, 300, 32, 128),  # one call of 201 strips of 32 rows
    ]
    for spec in SPECS:
        for i, (rows, cols, th, tw) in enumerate(shapes):
            y, x = padded_inputs(torch, subst_np, rows, cols, th, tw, i)
            kw = fill_args(spec, rows, cols, th, tw)
            want = mlsp_fill_plain(subst, y, x, **kw)
            for rep in range(REPEATS):
                got = mlsp_cuda.mlsp_fill(subst, y, x, **kw)
                torch.cuda.synchronize()
                err = max_abs_diff(torch, got, want)
                if err:
                    fail(f"kernel != plain: {spec} {rows}x{cols} tile "
                         f"{th}x{tw} run {rep}, max |diff| {err}")
    return len(SPECS) * len(shapes)


def rows_max_abs_diff(torch, a, b, chunk=1024) -> int:
    """max |a - b| of two int32 matrices, a block of rows at a time."""
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype {tuple(a.shape)}/{a.dtype} vs "
             f"{tuple(b.shape)}/{b.dtype}")
    err = 0
    for r in range(0, a.shape[0], chunk):
        d = a[r:r + chunk].long() - b[r:r + chunk].long()
        err = max(err, int(d.abs().max()))
    return err


def dense_bound_ms(spec, adjr, adjc, S) -> tuple:
    """Least time for the dense fill of one pair. Bytes: the inputs read
    once (subst, y, x) and H (adjr, adjc) written once; operations: the
    int32 instructions of the recurrence over the live cells."""
    nbytes = 4 * (S * S + adjr + adjc + adjr * adjc)
    return bound(nbytes, cell_insns(spec) * (adjr - 1) * (adjc - 1))


# K3's schedules besides the default, held against rowscan_dense in the
# kernels phase: (rows a lane, warps a block).
DENSE_SCHEDULES = ((1, 4), (2, 2), (8, 3), (4, 4), (1, 1))


def check_dense_kernel(torch, subst, subst_np) -> int:
    """dense_fill (K3, strip_fill_dense) against the (adjr, adjc) window of
    rowscan_dense over the same padded inputs, bit-exact, each case
    REPEATS times, at the default schedule and, on two shapes, at
    DENSE_SCHEDULES; returns the number of cases."""
    from gpuseqalign_tpu_torch.ops import dense_cuda
    from gpuseqalign_tpu_torch.ops.dense_plain import rowscan_dense

    shapes = [  # residues of y and x
        (1000, 1000), (700, 2100), (2100, 700),  # square, both rectangles
        (1, 3000), (3000, 1), (1, 1),            # 1 x N, N x 1, 1 x 1
        (777, 513), (129, 1025), (300, 37),      # ragged strips and chunks
        (0, 50), (50, 0),                        # an empty side: no launch
        (6450, 200),                             # 202 strips of 32 rows
    ]
    n = 0
    for spec in SPECS:
        for i, (rows, cols) in enumerate(shapes):
            # Padded past the true lengths, as the host flow pads them.
            y, x = padded_inputs(torch, subst_np, rows, cols, 128, 128, i)
            adjr, adjc = rows + 1, cols + 1
            kw = kind_gap(spec)
            want = rowscan_dense(subst, y, x, GAPO, GAPE[spec],
                                 **kw)[:adjr, :adjc]
            scheds = [{}]
            if rows == 6450:
                scheds = [dict(_lane_rows=1)]
            if (rows, cols) in ((1000, 1000), (777, 513)):
                scheds += [dict(_lane_rows=k, _warps=w)
                           for k, w in DENSE_SCHEDULES]
            for sched, rep in itertools.product(scheds, range(REPEATS)):
                got = dense_cuda.dense_fill(subst, y, x, GAPO, GAPE[spec],
                                            adjr, adjc, **kw, **sched)
                torch.cuda.synchronize()
                err = rows_max_abs_diff(torch, got, want)
                if err:
                    fail(f"dense_fill != rowscan_dense: {spec} {rows}x{cols}"
                         f" {sched or 'default'} run {rep}, max |diff| {err}")
            n += len(scheds)
    return n


def sweep_dense(torch, subst, subst_np, n, S) -> dict:
    """dense_fill's CUDA-event time (every spec at n x n, mean of 2 after
    a warm-up) against its schedule: rows a lane and warps a block (where
    the staging buffers fit); each schedule's H held against the
    default's. Returns {spec: {schedule: ms}}."""
    from gpuseqalign_tpu_torch.ops import dense_cuda, strip_cuda

    y, x = padded_inputs(torch, subst_np, n, n, 128, 128, 300)
    out = {}
    for spec in SPECS:
        kw = dict(kind_gap(spec), adjr=n + 1, adjc=n + 1)
        want = dense_cuda.dense_fill(subst, y, x, GAPO, GAPE[spec], **kw)
        times = {}
        for k in strip_cuda.LANE_ROWS:
            top = strip_cuda.max_warps(k, S, True)
            for w in (1, 2, 4):
                if w > top:
                    continue

                def fill(k=k, w=w):
                    return dense_cuda.dense_fill(
                        subst, y, x, GAPO, GAPE[spec], **kw, _lane_rows=k,
                        _warps=w)

                got = fill()
                if not torch.equal(got, want):
                    fail(f"dense_fill K {k} warps {w} != the default "
                         f"schedule: {spec}")
                del got
                times[f"K{k}_w{w}"] = cuda_ms(torch, fill, 2)
        del want
        best = min(times, key=times.get)
        log(f"phase full-size dense_fill sweep {spec} {n}x{n}: ms by "
            f"schedule " + ", ".join(f"{k}: {v:.3f}"
                                     for k, v in times.items())
            + f"; fastest {best}")
        out[spec] = times
    return out


def release_seq():
    """len23728 of resrc/seq_generated.fa as letters, header-prefixed
    (numpy int32), the sequence of the release pair."""
    import numpy as np

    from gpuseqalign_tpu_torch.io.fasta import parse_seq_file
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file

    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    seq = parse_seq_file(SEQS, letters).seq_map[RELEASE_SEQ].seq
    return np.asarray(seq, np.int32)


def wavefront_cases() -> list:
    """K2's and K4's cases against their plain versions: rows, cols
    (residues), R, TW, W, gapo. Every R, TW and W of WAVEFRONT_GRID that
    the kernel takes (TW % W == 0), on three row blocks of a pair that
    pads its last block and its second tile column; then the edge shapes."""
    gaps = (-11, -1, 0)
    cases = []
    for R, TWs in WAVEFRONT_GRID:
        for TW in TWs:
            for W in (128, 256, 512):
                if TW % W == 0:
                    cases.append((2 * R + R // 2, 2 * TW - 100, R, TW, W,
                                  gaps[len(cases) % 3]))
    return cases + [
        (100, 1000, 128, 512, 512, -11),   # shorter than one row block
        (700, 300, 256, 512, 512, -1),     # a single tile column
        (1, 2000, 128, 512, 512, 0),       # a 1-row pair
        (1, 1, 128, 128, 128, -11),        # 1 x 1
        (5000, 4500, 4096, 4096, 512, -1),  # R 4096: 32 strips a block
        (25600, 300, 1024, 1024, 256, -11),  # one call of 200 strips
    ]


def wavefront_pskew(torch, subst, y_np, x_np, R, col_mult, W):
    """(pskew, cols_p) of header-prefixed letters padded to R rows and to
    col_mult columns, on the card."""
    from gpuseqalign_tpu_torch.ops import wavefront, wavefront_cuda

    rows_p = -(-(len(y_np) - 1) // R) * R
    cols_p = -(-(len(x_np) - 1) // col_mult) * col_mult
    y = torch.zeros(1 + rows_p, dtype=torch.int32, device="cuda")
    x = torch.zeros(1 + cols_p, dtype=torch.int32, device="cuda")
    y[:len(y_np)] = torch.from_numpy(y_np).cuda()
    x[:len(x_np)] = torch.from_numpy(x_np).cuda()
    nspad = wavefront_cuda.nspad_of(R, cols_p, W)
    return (wavefront._build_pskew(subst, y, x, rows_p // R, R, nspad),
            cols_p)


def outputs_max_abs_diff(torch, got, want) -> int:
    """max |a - b| over two tuples of int32 tensors of the same shapes,
    whole arrays."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"shape/dtype {tuple(a.shape)}/{a.dtype} vs "
                 f"{tuple(b.shape)}/{b.dtype}")
        err = max(err, rows_max_abs_diff(torch, a.view(a.shape[0], -1),
                                         b.view(b.shape[0], -1), chunk=1))
    return err


def check_wavefront_kernels(torch, subst, seq) -> int:
    """K2 (mlsp_nw_lg_fill) and K4 (dense_nw_lg_fill) against their plain
    versions on the card, every element of every output bit-exact, on
    wavefront_cases() with profiles of slices of the release sequence,
    each REPEATS times (the strips of a fill run concurrently, so a race
    shows as a rare mismatch); returns the number of cases."""
    import numpy as np

    from gpuseqalign_tpu_torch.ops import wavefront_cuda as wc
    from gpuseqalign_tpu_torch.ops.wavefront_plain import (
        dense_nw_lg_plain,
        mlsp_nw_lg_plain,
    )

    cases = wavefront_cases()
    for i, (rows, cols, R, TW, W, g) in enumerate(cases):
        y_np = np.concatenate([[0], seq[1 + 97 * i:1 + 97 * i + rows]])
        x_np = np.concatenate([[0], seq[5001 + 89 * i:5001 + 89 * i + cols]])
        pskew, cols_p = wavefront_pskew(torch, subst, y_np.astype(np.int32),
                                        x_np.astype(np.int32), R, TW, W)
        kw = dict(cols_p=cols_p, W=W)
        plain = {"mlsp_nw_lg_fill": mlsp_nw_lg_plain(pskew, g, TW=TW, **kw),
                 "dense_nw_lg_fill": (dense_nw_lg_plain(pskew, g,
                                                        cols_p=cols_p),)}
        for rep in range(REPEATS):
            for name, got in (
                    ("mlsp_nw_lg_fill",
                     wc.mlsp_nw_lg_fill(pskew, g, TW=TW, **kw)),
                    ("dense_nw_lg_fill",
                     (wc.dense_nw_lg_fill(pskew, g, **kw),))):
                torch.cuda.synchronize()
                err = outputs_max_abs_diff(torch, got, plain[name])
                if err:
                    fail(f"{name} != plain: {rows}x{cols} R {R} TW {TW} W "
                         f"{W} gapo {g}, run {rep + 1}, max |diff| {err}")
                del got
        del pskew, plain
    return len(cases)


def full_wavefront(torch, subst, subst_np, seq, ref_row, S) -> dict:
    """The release pair through the v1 flows (wavefront.align_mlsp at
    128x512, wavefront.align_dense at _choose_r's R) in the registry's
    sparse and dense bundles: align, score hash and trace must equal
    cpu1_st_row's row; each kernel's launches in its flow (counts set to 0
    just before; one a fill), the align.* laps and the peak device memory
    of the align. Then each kernel at that size against its plain version:
    CUDA-event ms (mean of 3 after a warm-up), launches a fill, the plain
    version's ms (one call), max |diff| over whole arrays, bound and share
    of bound."""
    from gpuseqalign_tpu_torch.core.registry import dense, mlsp
    from gpuseqalign_tpu_torch.core.types import (
        AlgParams,
        AlgResult,
        make_alg_input,
    )
    from gpuseqalign_tpu_torch.ops import wavefront
    from gpuseqalign_tpu_torch.ops import wavefront_cuda as wc
    from gpuseqalign_tpu_torch.ops.wavefront_plain import (
        dense_nw_lg_plain,
        mlsp_nw_lg_plain,
    )

    n = len(seq) - 1
    R_dense = wavefront._choose_r(n, 0)
    flows = (
        ("wavefront_mlsp", mlsp(wavefront.align_mlsp),
         {"tileBy": [128], "tileBx": [512]}, 128, 512, 512),
        ("wavefront_dense", dense(wavefront.align_dense), {}, R_dense, None,
         256),
    )
    want = tuple(ref_row[k] for k in ("align_cost", "score_hash",
                                      "trace_hash"))
    out = {}
    for name, alg, params, R, TW, W in flows:
        nw = make_alg_input(subst_np, seq, seq, GAPO, 0, "nw_lg")
        res = AlgResult()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wc.LAUNCHES.update(dict.fromkeys(wc.LAUNCHES, 0))
        t0 = time.perf_counter()
        stats = [alg.align(AlgParams(params), nw, res)]
        launches = wc.LAUNCHES[name]
        peak = torch.cuda.max_memory_allocated()
        stats += [alg.hash(nw, res), alg.trace(nw, res, False)]
        wall = time.perf_counter() - t0
        got = (str(res.align_cost), f"{res.score_hash & 0xFFFFFFFF:08x}",
               f"{res.trace_hash & 0xFFFFFFFF:08x}")
        if any(int(st) for st in stats) or got != want:
            fail(f"{name} flow at {n}x{n}: status {stats}, (cost, score "
                 f"hash, trace hash) {got}, cpu1_st_row {want}")
        if launches != 1:
            fail(f"{name} flow at {n}x{n}: {launches} kernel launches, "
                 f"expected one a fill")
        laps = {lap: res.sw_align.get_or_default(lap) for lap in (
            "align.alloc", "align.cpy_dev", "align.calc", "align.cpy_host")}
        laps["hash.calc"] = res.sw_hash.get_or_default("hash.calc")
        laps["trace.calc"] = res.sw_trace.get_or_default("trace.calc")
        log(f"phase full-size v1 flow {name} {n}x{n} R {R}"
            + (f" TW {TW}" if TW else "") + f": cost {got[0]}, score hash "
            f"{got[1]}, trace hash {got[2]} equal to cpu1_st_row; {launches} "
            f"launches; peak device memory of the align "
            f"{peak / 2**30:.3f} GiB; wall {wall:.2f} s; laps ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in laps.items()))
        del nw, res
        torch.cuda.empty_cache()

        pskew, cols_p = wavefront_pskew(torch, subst, seq, seq, R, TW or 128,
                                        W)
        kw = dict(cols_p=cols_p, W=W)
        if TW:
            def fill():
                return wc.mlsp_nw_lg_fill(pskew, GAPO, TW=TW, **kw)

            def plain():
                return mlsp_nw_lg_plain(pskew, GAPO, TW=TW, **kw)
        else:
            def fill():
                return (wc.dense_nw_lg_fill(pskew, GAPO, **kw),)

            def plain():
                return (dense_nw_lg_plain(pskew, GAPO, cols_p=cols_p),)
        fill()  # warm-up
        ms = cuda_ms(torch, fill, 3)
        before = wc.LAUNCHES[name]
        got_t = fill()
        per_fill = wc.LAUNCHES[name] - before
        if per_fill != 1:
            fail(f"{name} at {n}x{n}: {per_fill} launches a fill")
        want_t = []
        plain_ms = cuda_ms(torch, lambda: want_t.extend(plain()), 1)
        err = outputs_max_abs_diff(torch, got_t, want_t)
        if err:
            fail(f"{name} != plain at {n}x{n}: max |diff| {err}")
        rows_p = pskew.shape[0] * R
        nbytes = 4 * (pskew.numel() + sum(t.numel() for t in got_t))
        b_ms, b_by = bound(nbytes, cell_insns("nw_lg") * rows_p * cols_p)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by, launches=launches,
                         launches_per_fill=per_fill,
                         gcups=n * n / (ms * 1e-3) / 1e9, peak_bytes=peak,
                         laps=laps, R=R, TW=TW, W=W)
        log(f"phase full-size {name} {n}x{n} R {R}"
            + (f" TW {TW}" if TW else "") + f" W {W} ({pskew.shape[0]} row "
            f"blocks, {pskew.shape[1]} steps): kernel {ms:.3f} ms "
            f"({out[name]['gcups']:.3f} GCUPS, {per_fill} launch a fill), "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.2f}% of it, bit-exact")
        del pskew, got_t, want_t
        torch.cuda.empty_cache()
    return out


def check_batch_kernels(torch, subst) -> int:
    """mlsp_fill_batch against mlsp_fill_batch_plain (and pair by pair
    against mlsp_fill), mlsp_tiny against scores_batch_plain; returns the
    number of cases. Every mlsp_fill_batch case runs the call with headers
    and the cost-only call, each REPEATS times (the strips of a call run
    concurrently, so a missing fence shows as a rare one-cell mismatch)."""
    from gpuseqalign_tpu_torch.ops import batch_cuda, mlsp_cuda
    from gpuseqalign_tpu_torch.ops.batch_plain import (
        mlsp_fill_batch_plain,
        scores_batch_plain,
    )
    from gpuseqalign_tpu_torch.parallel.batch import stack_bucket

    dev = torch.device("cuda")
    S = subst.shape[0]
    fill_buckets = [  # rows_p, cols_p, residue counts of the pairs
        (1024, 2048, [(1024, 2048), (1, 1500), (900, 1), (1000, 1800),
                      (513, 2047)]),
        (1200, 1200, [(1200, 1200), (1100, 700), (1, 1000), (1050, 1)]),
        # tile_h 16 (strips of 32 rows), ragged live regions
        (1200, 1200, [(1199, 37), (37, 1199), (33, 1200), (1168, 1167),
                      (65, 64)]),
        # tile_h 1, tile_w 1 (gcd of odd sizes)
        (1025, 777, [(1025, 777), (1000, 1), (31, 700), (999, 776)]),
        # tall: 6416 = 16 x 401 rows, 201 strips of 32 rows
        (6416, 300, [(6416, 300), (6400, 299), (6000, 17)]),
    ]
    n = 0
    cap = batch_cuda.HEADER_CAP_WORDS
    for spec in SPECS:
        for k, (rows_p, cols_p, sizes) in enumerate(fill_buckets):
            pairs = random_pairs(sizes, S, 10 + k)
            ys, xs, adjrs, adjcs = stack_bucket(pairs, range(len(pairs)),
                                                rows_p, cols_p, dev)
            kw = dict(tile_h=math.gcd(rows_p, 128),
                      tile_w=math.gcd(cols_p, 512), **kind_gap(spec))
            args = (subst, ys, xs, GAPO, GAPE[spec], adjrs, adjcs)
            want = mlsp_fill_batch_plain(*args, **kw)
            # Whole bucket in one group, then in groups of two pairs.
            pair_words = sum(want[k][0].numel() for k in
                             ("hrows", "hcols", "frows", "ecols") if k in want)
            for group_cap, headers, rep in itertools.product(
                    (cap, 2 * pair_words), (True, False), range(REPEATS)):
                batch_cuda.HEADER_CAP_WORDS = group_cap
                got = batch_cuda.mlsp_fill_batch(*args, headers=headers, **kw)
                torch.cuda.synchronize()
                err = max_abs_diff(torch, got, {k: want[k] for k in got})
                if err:
                    fail(f"mlsp_fill_batch != plain: {spec} bucket "
                         f"{rows_p}x{cols_p} cap {group_cap} headers "
                         f"{headers} run {rep}: max |diff| {err}")
            batch_cuda.HEADER_CAP_WORDS = cap
            got = batch_cuda.mlsp_fill_batch(*args, headers=True, **kw)
            for p, (y, x) in enumerate(pairs):
                one = mlsp_cuda.mlsp_fill(
                    subst, ys[p].contiguous(), xs[p].contiguous(),
                    GAPO, GAPE[spec], len(y), len(x), **kw)
                for name, t in one.items():
                    if not torch.equal(got[name][p], t):
                        fail(f"mlsp_fill_batch != mlsp_fill: {spec} pair "
                             f"{p} of bucket {rows_p}x{cols_p}, {name}")
            n += 1
    return n + check_tiny_kernel(torch, subst)


def tie_pair(subst_np, rows, cols, start, col):
    """A pair for SW ties: one sequence all of a filler letter but for runs
    of 12 copies of the letter that scores highest against itself, ending
    at rows start, start + 16, ... <= rows; the other all of a second
    filler but for one run ending at column col. Every score but that
    letter against itself is negative, so the best local score (12 times
    its self-score) is reached at (row, col) for every run's end row: a
    tie the kernel must break to the smallest row, start."""
    import numpy as np

    S = subst_np.shape[0]
    w = int(np.argmax(subst_np.diagonal()))
    fy, fx = next((a, b) for a in range(S) for b in range(S)
                  if subst_np[a, b] < 0 and subst_np[a, w] < 0
                  and subst_np[w, b] < 0)
    y = np.full(1 + rows, fy, np.int32)
    x = np.full(1 + cols, fx, np.int32)
    y[0] = x[0] = 0
    for end in range(start, rows + 1, 16):
        y[end - 11:end + 1] = w
    x[col - 11:col + 1] = w
    return y, x


def tiny_cases(S, subst_np) -> list:
    """K6's cases: (label, rows_p, cols_p, pairs)."""
    cases = [(f"{r}x{c}", r, c, random_pairs(sizes, S, 20 + k))
             for k, (r, c, sizes) in enumerate((
                 (200, 300, [(200, 300), (1, 1), (150, 1), (1, 250),
                             (37, 299)]),
                 (512, 512, [(512, 512), (300, 400), (1, 1), (480, 1),
                             (257, 511), (511, 2)] * 8),
                 # Live rows a multiple of no strip height; a pair one row
                 # taller than a strip of 256 rows (257: two of 160) and
                 # one of 33 rows (a strip of 64, 31 dead); 1-row and
                 # 1-column partners.
                 (512, 512, [(449, 300), (257, 301), (129, 512), (33, 40),
                             (97, 95), (1, 511), (511, 1), (2, 2), (1, 1)]),
                 (1000, 20000, [(1000, 20000), (999, 1), (1, 1),
                                (640, 15000)]),
             ))]
    # SW ties across lane and strip boundaries: runs every 16 rows from
    # row 16, 96, 128 or 160, so the best value recurs in many lanes and,
    # in the pairs of 480, 288 and 257 rows (two strips of 256, 160 and 160
    # rows), in both strips; from row 160 in a pair of 288 or 257 rows the
    # first run ends on the first strip's last row.
    cases.append(("ties", 512, 512, [
        tie_pair(subst_np, rows, 400, start, 200)
        for rows in (480, 288, 257, 200) for start in (16, 96, 128, 160)]))
    # A bucket that fills every SM of an H100 several times (1100 pairs,
    # 8 a SM) beside a one-pair bucket.
    rng_sizes = [(int(a), int(b)) for a, b in
                 zip(range(300, 500), range(500, 300, -1))] * 6
    cases.append(("many", 512, 512, random_pairs(rng_sizes[:1100], S, 30)))
    cases.append(("one", 512, 512, random_pairs([(400, 450)], S, 31)))
    return cases


def check_tiny_kernel(torch, subst) -> int:
    """mlsp_tiny (K6) against scores_batch_plain on every case of
    tiny_cases, every spec, at every block the wrapper takes (1 to
    MAX_WARPS warps), each REPEATS times; then the engine's route by launch
    counters: the one-pair bucket through the batched fill (K5), the
    bucket that fills the card through K6, both equal to the plain
    version. Returns the number of cases."""
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.ops import batch_cuda, tiny_cuda
    from gpuseqalign_tpu_torch.ops.batch_plain import scores_batch_plain
    from gpuseqalign_tpu_torch.parallel.batch import (
        bucket_scores,
        fill_route,
        stack_bucket,
    )

    dev = torch.device("cuda")
    S = subst.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = range(1, tiny_cuda.MAX_WARPS + 1)
    n = 0
    routes = {}
    for label, rows_p, cols_p, pairs in tiny_cases(S, subst.cpu().numpy()):
        ys, xs, adjrs, adjcs = stack_bucket(pairs, range(len(pairs)),
                                            rows_p, cols_p, dev)
        for spec in SPECS:
            args = (subst, ys, xs, GAPO, GAPE[spec], adjrs, adjcs)
            want = scores_batch_plain(subst, ys, xs, adjrs, adjcs, GAPO,
                                      GAPE[spec], **kind_gap(spec))
            for warps, rep in itertools.product(blocks, range(REPEATS)):
                got = batch_cuda.tiny_scores(*args, _warps=warps,
                                             **kind_gap(spec))
                torch.cuda.synchronize()
                for name, g, w in zip(("cost", "best_i", "best_j"), got,
                                      want):
                    if not torch.equal(g, w):
                        fail(f"mlsp_tiny != plain: {spec} case {label} "
                             f"({rows_p}x{cols_p}) {warps} warps a block "
                             f"run {rep}, {name}")
            n += 1
            if label not in ("many", "one"):
                continue
            # Pairs with an empty sequence never reach bucket_scores.
            f0, t0 = batch_cuda.FILL_LAUNCHES, batch_cuda.TINY_LAUNCHES
            got = bucket_scores(AlignSpec.from_name(spec), *args[:3],
                                adjrs, adjcs, GAPO, GAPE[spec])
            torch.cuda.synchronize()
            launched = (batch_cuda.FILL_LAUNCHES - f0,
                        batch_cuda.TINY_LAUNCHES - t0)
            route = fill_route(rows_p, len(pairs), sms)
            if launched != {"fill": (1, 0), "tiny": (0, 1)}[route]:
                fail(f"bucket_scores {spec} case {label}: route {route} "
                     f"but launches (K5, K6) {launched}")
            if not torch.equal(got, torch.stack(want)):
                fail(f"bucket_scores != plain: {spec} case {label}")
            routes[label] = route
    if routes != {"many": "tiny", "one": "fill"}:
        fail(f"the engine's routes of the K6 buckets: {routes}")
    log(f"phase kernels: mlsp_tiny cases bit-exact at {list(blocks)} warps "
        f"a block, {REPEATS} times each; routes by launch counters "
        f"{routes}")
    return n


def phase_throughput(torch, subst, S) -> dict:
    """Drive bench.throughput.main for every run of THROUGHPUT_RUNS, then
    hold each pair's outputs against scores_batch_plain on the card and
    time each bucket's kernel. Returns per-run summaries."""
    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import batch_cuda
    from gpuseqalign_tpu_torch.ops.batch_plain import scores_batch_plain
    from gpuseqalign_tpu_torch.parallel.batch import (
        bucket_pairs,
        bucket_scores,
        fill_route,
        stack_bucket,
    )
    from gpuseqalign_tpu_torch.core.types import AlignSpec

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    os.makedirs(OUT, exist_ok=True)
    runs = {}
    for name, extra, specs in THROUGHPUT_RUNS:
        if name == "pair_generated_1":
            pairs = throughput.file_pairs(SEQS, extra[1], letters)
        else:
            pairs = throughput.synth_pairs(
                *(int(v) for v in extra[1].split(",")), S)
        t0 = time.perf_counter()
        buckets = bucket_pairs(pairs, "pow2")
        t_bucket = time.perf_counter() - t0
        t0 = time.perf_counter()
        for key, idxs in buckets.items():
            stack_bucket(pairs, idxs, *key, dev)
        torch.cuda.synchronize()
        t_stack = time.perf_counter() - t0
        log(f"phase throughput {name}: host wall ms of the engine's steps: "
            f"bucket_pairs {t_bucket * 1e3:.3f}, stack_bucket (every "
            f"bucket, to the card) {t_stack * 1e3:.3f}")
        for spec in specs:
            tag = f"{name}_{spec}"
            out_json = os.path.join(OUT, f"throughput_{tag}.json")
            argv = ["--seqPath", SEQS, "--substPath",
                    os.path.join(RESRC, "subst.json"), *extra,
                    "--algKind", spec, "--gapoCost", str(GAPO),
                    "--gapeCost", str(GAPE[spec]), "--quantum", "pow2",
                    "--verify", "5", "--repeat", "5",
                    "--jsonPath", out_json]
            batch_cuda.FILL_LAUNCHES = batch_cuda.TINY_LAUNCHES = 0
            rc = throughput.main(argv)
            launches = {"mlsp_fill_batch": batch_cuda.FILL_LAUNCHES,
                        "mlsp_tiny": batch_cuda.TINY_LAUNCHES}
            if rc != 0:
                fail(f"throughput {tag}: exit {rc}")
            with open(out_json) as f:
                res = json.load(f)
            got = torch.tensor([res["costs"], res["best_i"], res["best_j"]],
                               dtype=torch.int32)

            per = {k: dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                           padded_ops=0, buckets=0, max_abs_err=0)
                   for k in launches}
            aspec = AlignSpec.from_name(spec)
            for (rows_p, cols_p), idxs in buckets.items():
                kernel = ("mlsp_fill_batch"
                          if fill_route(rows_p, len(idxs), sms) == "fill"
                          else "mlsp_tiny")
                ys, xs, adjrs, adjcs = stack_bucket(pairs, idxs, rows_p,
                                                    cols_p, dev)
                plain = []
                plain_ms = cuda_ms(torch, lambda: plain.append(
                    scores_batch_plain(subst, ys, xs, adjrs, adjcs, GAPO,
                                       GAPE[spec], **kind_gap(spec))), 1)
                want = torch.stack(plain[0]).cpu()
                err = int((got[:, idxs].long() - want.long()).abs().max())
                per[kernel]["max_abs_err"] = max(per[kernel]["max_abs_err"],
                                                 err)
                if err:
                    fail(f"throughput {tag}: bucket {rows_p}x{cols_p} "
                         f"differs from scores_batch_plain by {err}")

                def call():
                    bucket_scores(aspec, subst, ys, xs, adjrs, adjcs, GAPO,
                                  GAPE[spec])

                call()
                ms = cuda_ms(torch, call, 3)
                nbytes, ops = bucket_work(spec, pairs, idxs, rows_p, cols_p,
                                          S)
                e = per[kernel]
                e["ms"] += ms
                e["plain_ms"] += plain_ms
                e["bytes"] += nbytes
                e["ops"] += ops
                e["padded_ops"] += cell_insns(spec) * len(idxs) * rows_p \
                    * cols_p
                e["buckets"] += 1
            if any(e["buckets"] and launches[k] <= 0 for k, e in per.items()):
                fail(f"throughput {tag}: a kernel the engine routes a bucket "
                     f"to never launched: {launches}")
            for k, e in per.items():
                e["launches"] = launches[k]
                e["bound_ms"], e["bound_by"] = bound(e["bytes"], e["ops"])
                e["padded_bound_ms"] = bound(e["bytes"], e["padded_ops"])[0]
            runs[tag] = dict(pairs_per_s=res["pairs_per_s"],
                             gcups=res["gcups"], n_buckets=res["n_buckets"],
                             seconds=res["seconds"], kernels=per)
            log(f"phase throughput {tag}: {res['pairs']} pairs, "
                f"{res['n_buckets']} buckets, {res['pairs_per_s']:.1f} "
                f"pairs/s, {res['gcups']:.3f} GCUPS (live cells) over the "
                f"median window {res['seconds'] * 1e3:.3f} ms (best "
                f"{res['seconds_best'] * 1e3:.3f}; windows "
                + ", ".join(f"{v * 1e3:.3f}" for v in res["seconds_all"])
                + " ms); every pair bit-exact against scores_batch_plain")
            for k, e in per.items():
                if e["buckets"]:
                    log(f"  {k}: {e['buckets']} buckets, {e['launches']} "
                        f"launches in the run, kernel {e['ms']:.3f} ms, "
                        f"bound over live cells {e['bound_ms']:.4f} ms "
                        f"({e['bound_by']}; over padded cells "
                        f"{e['padded_bound_ms']:.4f} ms), scores_batch_plain "
                        f"{e['plain_ms']:.1f} ms")
    return runs


def time_fill_batch(torch, subst, S) -> dict:
    """mlsp_fill_batch on the K5 buckets of pair_generated_1 (nw_ag), held
    against mlsp_fill_batch_plain on the same inputs: CUDA-event ms of the
    engine's cost-only call and of the call that also returns the headers
    (mean of 3 after a warm-up), of the plain version (one call), max
    |diff| over every output, and each call's bound."""
    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import batch_cuda
    from gpuseqalign_tpu_torch.ops.batch_plain import mlsp_fill_batch_plain
    from gpuseqalign_tpu_torch.parallel.batch import (
        TILE_FILL_MIN_ROWS,
        bucket_pairs,
        stack_bucket,
    )

    spec = "nw_ag"
    dev = torch.device("cuda")
    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    pairs = throughput.file_pairs(SEQS, THROUGHPUT_RUNS[0][1][1], letters)
    r = dict(ms=0.0, headers_ms=0.0, plain_ms=0.0, max_abs_err=0,
             launches=0, calls=0)
    work = [0, 0, 0, 0]  # bytes, ops: cost only; bytes, ops: with headers
    for (rows_p, cols_p), idxs in bucket_pairs(pairs, "pow2").items():
        if rows_p < TILE_FILL_MIN_ROWS:
            continue
        ys, xs, adjrs, adjcs = stack_bucket(pairs, idxs, rows_p, cols_p, dev)
        kw = dict(tile_h=math.gcd(rows_p, 128), tile_w=math.gcd(cols_p, 512),
                  **kind_gap(spec))
        args = (subst, ys, xs, GAPO, GAPE[spec], adjrs, adjcs)
        want = {}
        r["plain_ms"] += cuda_ms(torch, lambda: want.update(
            mlsp_fill_batch_plain(*args, **kw)), 1)
        for key, headers in (("ms", False), ("headers_ms", True)):
            before = batch_cuda.FILL_LAUNCHES
            got = batch_cuda.mlsp_fill_batch(*args, headers=headers, **kw)
            if not headers:
                r["launches"] += batch_cuda.FILL_LAUNCHES - before
                r["calls"] += 1
            r[key] += cuda_ms(torch, lambda: batch_cuda.mlsp_fill_batch(
                *args, headers=headers, **kw), 3)
            r["max_abs_err"] = max(r["max_abs_err"], max_abs_diff(
                torch, got, {k: want[k] for k in got}))
            w = bucket_work(spec, pairs, idxs, rows_p, cols_p, S, headers)
            k = 2 if headers else 0
            work[k] += w[0]
            work[k + 1] += w[1]
        del got, want
    if r["max_abs_err"]:
        fail(f"mlsp_fill_batch != mlsp_fill_batch_plain on pair_generated_1 "
             f"{spec}: max |diff| {r['max_abs_err']}")
    r["ops"] = work[1]
    r["bound_ms"], r["bound_by"] = bound(work[0], work[1])
    r["headers_bound_ms"], by = bound(work[2], work[3])
    log(f"phase throughput: mlsp_fill_batch on the pair_generated_1 {spec} "
        f"K5 buckets, bit-exact against mlsp_fill_batch_plain "
        f"({r['plain_ms']:.1f} ms): cost only {r['ms']:.3f} ms, "
        f"{r['launches']} launches in {r['calls']} calls (bound over live "
        f"cells {r['bound_ms']:.4f} ms, {r['bound_by']}, "
        f"{100 * r['bound_ms'] / r['ms']:.2f}% of it; body share in the "
        f"probe phase), with headers {r['headers_ms']:.3f} ms (bound over "
        f"padded cells {r['headers_bound_ms']:.4f} ms, {by})")
    return r


def sweep_tiny_schedule(torch, subst, S) -> list:
    """mlsp_tiny's CUDA-event time (nw_ag, mean of 6 in two turns after a
    warm-up) at each block size (1 to MAX_WARPS warps) beside the batched
    fill's cost-only call (K5) and the engine's pick (bucket_scores, with
    its route), on the first n pairs of the synthetic run's 512 x 512 bucket
    for n from one pair to 16384 (0.01 to 124 pairs per SM) and on each of
    pair_generated_1's buckets of fewer than TILE_FILL_MIN_ROWS rows (one
    or two pairs each, up to 512 x 16384). Returns one dict a point."""
    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import batch_cuda, tiny_cuda
    from gpuseqalign_tpu_torch.parallel.batch import (
        TILE_FILL_MIN_ROWS,
        bucket_pairs,
        bucket_scores,
        fill_route,
        stack_bucket,
    )

    spec = "nw_ag"
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    synth = throughput.synth_pairs(16384, 300, 500, S)
    synth_idxs = bucket_pairs(synth, "pow2")[(512, 512)]
    cases = [(synth, synth_idxs[:n], (512, 512))
             for n in (1, 33, 132, 264, 528, 1056, 2112, 4224, 16384)]
    wide = throughput.file_pairs(SEQS, THROUGHPUT_RUNS[0][1][1], letters)
    cases += [(wide, idxs, key) for key, idxs in
              sorted(bucket_pairs(wide, "pow2").items())
              if key[0] < TILE_FILL_MIN_ROWS]
    out = []
    for pairs, idxs, key in cases:
        ys, xs, adjrs, adjcs = stack_bucket(pairs, idxs, *key, dev)
        args = (subst, ys, xs, GAPO, GAPE[spec], adjrs, adjcs)
        calls = {w: (lambda w=w: batch_cuda.tiny_scores(
            *args, _warps=w, **kind_gap(spec)))
            for w in range(1, tiny_cuda.MAX_WARPS + 1)}
        calls["K5"] = lambda: batch_cuda.mlsp_fill_batch(
            *args, tile_h=math.gcd(key[0], 128),
            tile_w=math.gcd(key[1], 512), **kind_gap(spec))
        calls["pick"] = lambda: bucket_scores(
            AlignSpec.from_name(spec), subst, ys, xs, adjrs, adjcs, GAPO,
            GAPE[spec])
        for call in calls.values():
            call()
        # In turns, forward then backward: the first call timed after the
        # bucket is stacked read slower in some runs.
        times = dict.fromkeys(calls, 0.0)
        for name in [*calls, *reversed(calls)]:
            times[name] += cuda_ms(torch, calls[name], 3) / 2
        route = fill_route(key[0], len(idxs), sms)
        out.append(dict(bucket=key, pairs=len(idxs),
                        live_cells=live_cells(pairs, idxs), route=route,
                        ms=times))
        log(f"phase throughput: schedule sweep {spec} bucket "
            f"{key[0]}x{key[1]} of {len(idxs)} pairs "
            f"({len(idxs) / sms:.2f} per SM), ms of mlsp_tiny by warps a "
            f"block: "
            + ", ".join(f"{k}: {v:.4f}" for k, v in times.items()
                        if k not in ("K5", "pick"))
            + f"; K5 cost-only {times['K5']:.4f}; the engine's pick "
            f"({route}, mlsp_tiny at {tiny_cuda.WARPS}) "
            f"{times['pick']:.4f}")
    return out


def _union_ms(intervals, lo, hi) -> float:
    """Length in ms of the union of (start, end) microsecond intervals
    clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total / 1e3


def trace_synth_windows(torch, subst_np, S, n_windows=3) -> list:
    """torch.profiler trace of n_windows of align_pairs_batched on the
    synth_16384 nw_ag pairs, each as throughput.main times it (a call and
    a synchronise). Per window: its length, the device's busy time (the
    union of kernels, copies and sets) and idle share, K6's device time,
    and the host time of each ``batch.*`` span of the engine."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.parallel import align_pairs_batched

    spec = "nw_ag"
    pairs = throughput.synth_pairs(16384, 300, 500, S)

    def window():
        align_pairs_batched(AlignSpec.from_name(spec), subst_np, pairs, GAPO,
                            GAPE[spec], quantum="pow2")
        torch.cuda.synchronize()

    window()  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_windows):
            with record_function("window"):
                window()
    path = os.path.join(OUT, "trace_synth_16384_nw_ag.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["name"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    out = []
    for w in sorted((e for e in spans if e["name"] == "window"),
                    key=lambda e: float(e["ts"])):
        lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        inside = [(a, b, n) for a, b, n in device if a < hi and b > lo]
        busy = _union_ms([(a, b) for a, b, _ in inside], lo, hi)
        k6 = _union_ms([(a, b) for a, b, n in inside if "mlsp_tiny" in n],
                       lo, hi)
        host = {}
        for e in spans:
            if (e["name"].startswith("batch.") and lo <= float(e["ts"])
                    and float(e["ts"]) < hi):
                host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
        r = dict(window_ms=(hi - lo) / 1e3, device_busy_ms=busy,
                 idle_share=1 - busy / ((hi - lo) / 1e3) if hi > lo else None,
                 k6_ms=k6, device_events=len(inside), host_ms=host)
        out.append(r)
        log("phase throughput: traced synth_16384 nw_ag window: "
            + json.dumps(r))
    if not device:
        log("phase throughput: the trace holds no device events: device "
            "busy time and idle share not measured")
    return out


def cli_pairs() -> list:
    """The pair subset of the CLI runs: four verify pairs and pair_debug's
    degenerate and substring pairs."""
    with open(os.path.join(RESRC, "pair_debug.txt")) as f:
        debug = [line.strip() for line in f if line.strip()]
    pairs = ["len1 len1", "len31 len33", "len196 len256",
             "len512[2:] len728[:726]"]
    return pairs + [p for p in debug if p.split()[0] in ("len1", "len2")
                    or "[" in p]


def band_chain(torch, fill, subst, y, x, spec, rows, cols, R, TW,
               band_cols, D, BL) -> list:
    """A pair of rows x cols residues (y, x on the card, zero-padded to
    whole calls and bands) filled as D column bands in calls of BL row
    blocks, each call through ``fill`` (K7's wrapper or its plain
    version): band 0's halo is the matrix's left column, band k's the
    right edge (corner, H, E) of band k-1's call over the same rows.
    Returns every call's outputs, band by band."""
    from gpuseqalign_tpu_torch.core.types import NEG_INF_I32
    from gpuseqalign_tpu_torch.ops.mlsp_plain import edge_col, edge_row

    kw = kind_gap(spec)
    affine = kw["gap"] == "affine"
    g, ge = GAPO, GAPE[spec]
    dev = y.device
    rows_p = y.numel() - 1
    jtE = band_cols // TW

    def ninf(k):
        return torch.full((k,), NEG_INF_I32, dtype=torch.int32, device=dev)

    hdr = edge_row(D * band_cols + 1, g, ge, kw["kind"], kw["gap"], dev)
    col = edge_col(torch.arange(rows_p + 1, dtype=torch.int32, device=dev),
                   g, ge, kw["kind"], kw["gap"])
    col[0] = 0
    outs, halos = [], None
    for k in range(D):
        c0 = k * band_cols
        prev = hdr[c0:c0 + band_cols + 1]
        prevF = ninf(band_cols + 1) if affine else None
        edges = []
        for p in range(rows_p // (BL * R)):
            r0 = p * BL * R
            if k == 0:
                haloH = col[r0:r0 + BL * R + 1]
                haloE = ninf(BL * R) if affine else None
            else:
                haloH, haloE = halos[p]
            out = fill(subst, y[r0:r0 + BL * R + 1],
                       x[c0:c0 + band_cols + 1], g, ge, prev, prevF, haloH,
                       haloE, rows + 1 - r0, cols + 1 - c0, tile_h=R,
                       tile_w=TW, **kw)
            outs.append(out)
            edges.append((
                torch.cat([prev[band_cols:],
                           out["hcols"][:, :, jtE].reshape(-1)]),
                out["ecols"][:, :, jtE].reshape(-1).contiguous()
                if affine else None))
            prev = out["hrows"][-1]
            prevF = out["frows"][-1] if affine else None
        halos = edges
    return outs


def check_banded_kernel(torch, subst, subst_np) -> int:
    """banded_pass (K7) against banded_pass_plain on the card, bit-exact,
    on BANDED_CASES (each chain REPEATS times; those of D > 1 bands also
    through giant2_fill on D entries of the one card, the bands' passes
    concurrent on D streams), and the SW band clamp case; returns the
    number of cases."""
    from gpuseqalign_tpu_torch.ops.banded_cuda import banded_pass
    from gpuseqalign_tpu_torch.ops.banded_plain import banded_pass_plain

    n = 0
    for spec in SPECS:
        for i, (rows, cols, R, TW, bc, D, BL) in enumerate(BANDED_CASES):
            y, x = padded_inputs(torch, subst_np, rows, cols, BL * R, D * bc,
                                 400 + i)
            args = (subst, y, x, spec, rows, cols, R, TW, bc, D, BL)
            want = band_chain(torch, banded_pass_plain, *args)
            for rep in range(REPEATS):
                got = band_chain(torch, banded_pass, *args)
                torch.cuda.synchronize()
                for c, (a, b) in enumerate(zip(got, want)):
                    err = max_abs_diff(torch, a, b)
                    if err:
                        fail(f"banded_pass != plain: {spec} {rows}x{cols} R "
                             f"{R} TW {TW} band_cols {bc} D {D} BL {BL}, "
                             f"call {c}, run {rep}: max |diff| {err}")
                if D > 1:
                    banded_streams(torch, subst, y, x, spec, rows, cols, R,
                                   TW, bc, D, BL, want, rep)
            n += 1
    # The SW clamp (the TPU kernel's regression): a band left of the
    # pair's last column, row letters 0, band letters never 0, so every
    # true cell scores <= 0.
    import numpy as np

    s8 = np.full((8, 8), -3, np.int32)
    np.fill_diagonal(s8, 10)
    x8 = np.concatenate([[0], np.random.default_rng(7).integers(1, 8, 128)])
    zeros = torch.zeros(129, dtype=torch.int32, device="cuda")
    args = (torch.from_numpy(s8).cuda(), zeros,
            torch.from_numpy(x8.astype(np.int32)).cuda(), -4, 0, zeros,
            None, zeros, None, 121, 300)
    kw = dict(tile_h=128, tile_w=128, kind="sw", gap="linear")
    got = banded_pass(*args, **kw)
    want = banded_pass_plain(*args, **kw)
    if max_abs_diff(torch, got, want) or got["best"].tolist() != [0, 0, 0]:
        fail(f"banded_pass SW clamp: best {got['best'].tolist()}, plain "
             f"{want['best'].tolist()}")
    return n + 1


def banded_streams(torch, subst, y, x, spec, rows, cols, R, TW, bc, D, BL,
                   want, rep) -> None:
    """giant2_fill on a mesh of D entries of the one card (each band's
    calls on its own stream, halos after CUDA events), at calls of one
    pass and at the engine's call height (pick_call_passes), against
    band_chain's plain calls ``want`` (one a pass): every grid pass by
    pass, and each call's SW best cell against the first maximum of its
    passes'; ``rep`` numbers the run."""
    from gpuseqalign_tpu_torch.ops.mlsp_cuda import tile_best
    from gpuseqalign_tpu_torch.parallel import giant2_fill, make_mesh, schedule

    mesh = make_mesh(devices=["cuda:0"] * D, axis_name="sp")
    n_pass = (y.numel() - 1) // (BL * R)
    with call_passes(1):
        plans = [schedule(D, R, TW, bc, BL, [n_pass])]
    plans += [schedule(D, R, TW, bc, BL, [n_pass])]
    for plan in sorted(set(plans), key=lambda p: p.C):
        C = plan.C
        bands = giant2_fill(subst, [y], [x], GAPO, GAPE[spec], [rows + 1],
                            [cols + 1], mesh=mesh, plan=plan,
                            **kind_gap(spec))[0]
        torch.cuda.synchronize()
        where = (f"{spec} {rows}x{cols} R {R} TW {TW} band_cols {bc} D {D} "
                 f"BL {BL}, calls of {C} passes")
        for k, grid in enumerate(bands):
            for p in range(n_pass):
                b0, w = p * BL, want[k * n_pass + p]
                for name, t in w.items():
                    if name == "best":
                        continue
                    g = grid[name][b0:b0 + BL + (name in ("hrows", "frows"))]
                    if not torch.equal(g, t):
                        fail(f"giant2_fill != plain: {where}, band {k} pass "
                             f"{p} {name}, run {rep}")
            calls = range(0, n_pass, C) if "best" in grid else ()
            for c, p0 in enumerate(calls):
                # The call's passes' bests in the call's frame.
                cand = torch.stack([
                    want[k * n_pass + p]["best"] + torch.tensor(
                        [0, (p - p0) * BL * R, 0], dtype=torch.int32,
                        device="cuda")
                    for p in range(p0, min(p0 + C, n_pass))])
                g = grid["best"][c].clone()  # the pair's frame
                g[1] -= p0 * BL * R
                g[2] -= k * bc
                if not torch.equal(g, tile_best(cand.view(1, -1, 3),
                                                 bc + 1)[0]):
                    fail(f"giant2_fill != plain: {where}, band {k} call {c}"
                         f" best, run {rep}")


@contextlib.contextmanager
def call_passes(C):
    """The giant engine's call height forced to C passes inside the block
    (``giant2.pick_call_passes`` patched, as the tests force it)."""
    from gpuseqalign_tpu_torch.parallel import giant2

    real = giant2.pick_call_passes
    giant2.pick_call_passes = lambda *a, **k: C
    try:
        yield
    finally:
        giant2.pick_call_passes = real


def engine_plan(spec, n_rows, n_cols, D, pr=None):
    """The giant engine's plan (``fill_plan``) on the card for an n_rows x
    n_cols pair on D bands: ``pr``'s tile, else, for a ``spec``, the
    card's tuned cache's (ops/tuned.py), else 128 x 128."""
    import torch

    from gpuseqalign_tpu_torch.core.types import AlgParams, AlignSpec
    from gpuseqalign_tpu_torch.parallel import fill_plan

    if spec is None:
        return fill_plan(pr or AlgParams({}), [n_rows], [n_cols], D)
    return fill_plan(pr or AlgParams({}), [n_rows], [n_cols], D,
                     AlignSpec.from_name(spec), torch.device("cuda"))


def time_banded(torch, subst, subst_np, n, S) -> dict:
    """K7 on the whole band of an n x n pair at D = 1 (the engine's
    geometry and its one call), every spec: CUDA-event ms (mean of 3
    after a warm-up), its plain version's (one call), max |diff| over
    every output, launches, GCUPS and bound."""
    from gpuseqalign_tpu_torch.ops import banded_cuda
    from gpuseqalign_tpu_torch.ops.banded_cuda import banded_pass
    from gpuseqalign_tpu_torch.ops.banded_plain import banded_pass_plain

    out = {}
    for i, spec in enumerate(SPECS):
        plan = engine_plan(spec, n, n, 1)
        R, TW, bc, BL = plan.R, plan.TW, plan.band_cols, plan.BL
        rows_p = plan.n_pass[0] * BL * R
        y, x = padded_inputs(torch, subst_np, n, n, rows_p, bc, 500 + i)
        args = (subst, y, x, spec, n, n, R, TW, bc, 1, rows_p // R)
        band_chain(torch, banded_pass, *args)  # warm-up
        ms = cuda_ms(torch, lambda: band_chain(torch, banded_pass, *args), 3)
        banded_cuda.LAUNCHES = 0
        got = band_chain(torch, banded_pass, *args)
        launches = banded_cuda.LAUNCHES
        want = []
        plain_ms = cuda_ms(torch, lambda: want.extend(
            band_chain(torch, banded_pass_plain, *args)), 1)
        err = max_abs_diff(torch, got[0], want[0])
        if err:
            fail(f"banded_pass != plain at {n}x{n} {spec}: max |diff| {err}")
        b_ms, b_by = bound_ms(spec, rows_p, bc, R, TW, S)
        out[spec] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by,
                         gcups=n * n / (ms * 1e-3) / 1e9,
                         launches_per_fill=launches)
        log(f"phase kernels: banded_pass {spec} {n}x{n} D 1 (band "
            f"{rows_p}x{bc}, tile {R}x{TW}): kernel {ms:.3f} ms "
            f"({out[spec]['gcups']:.3f} GCUPS, {launches} launches a "
            f"call), plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / ms:.2f}% of it; body share in the probe phase), "
            f"bit-exact")
        del got, want
    return out


def giant_inputs(torch, y_np, x_np, n_rows, n_cols, D, pr=None, spec=None):
    """The engine's plan for an n_rows x n_cols pair on D bands (at
    ``spec``'s tuned tile on the card when a spec is given, else at the
    literal one) and the pair zero-padded to it, on the card: (plan, y,
    x)."""
    plan = engine_plan(spec, n_rows, n_cols, D, pr)
    y, x = plan.pad(y_np, x_np)
    return plan, y.cuda(), x.cuda()


def giant_pair(S, n):
    import numpy as np

    rng = np.random.default_rng(GIANT_SEED)
    return (np.concatenate([[0], rng.integers(0, S, n)]).astype(np.int32),
            np.concatenate([[0], rng.integers(0, S, n)]).astype(np.int32))


def same_shared_tiles(a, rows_a, cols_a, b, rows_b, cols_b) -> bool:
    """Two tile-major sparse mats equal on the tiles both layouts have."""
    tr, tc = min(rows_a, rows_b), min(cols_a, cols_b)
    return bool((a.reshape(rows_a, cols_a, -1)[:tr, :tc]
                 == b.reshape(rows_b, cols_b, -1)[:tr, :tc]).all())


def giant_full(torch, subst, subst_np, S) -> dict:
    """The 100000 x 100000 pair through align_giant2 at D = 1 for every
    spec (the main path of the giant phase), its sparse layout held
    against tpu7_pallas_mlsp's (K1) at the engine's tile (the card's
    tuned one, else 128 x 128) on every tile both have, the cost and best cell too, and for nw_ag the sparse
    trace of both; then the fill alone timed with CUDA events and its
    every output held bit-exactly against banded_pass_plain's on the same
    inputs on the card. Returns per spec and the K7 launches of the
    align_giant2 calls."""
    from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
    from gpuseqalign_tpu_torch.core.types import (
        AlgParams,
        AlgResult,
        make_alg_input,
    )
    from gpuseqalign_tpu_torch.ops import banded_cuda
    from gpuseqalign_tpu_torch.ops.banded_plain import banded_pass_plain
    from gpuseqalign_tpu_torch.parallel import giant2_fill, make_mesh
    from gpuseqalign_tpu_torch.parallel.giant2 import align_giant2

    n = GIANT_N
    y_np, x_np = giant_pair(S, n)
    one = make_mesh(devices=["cuda:0"], axis_name="sp")
    algs = get_algorithm_map()
    mats = ("tileHrowMat", "tileHcolMat", "tileFrowMat", "tileEcolMat")
    out, launches = {}, 0
    for spec in SPECS:
        nw = make_alg_input(subst_np, y_np, x_np, GAPO, GAPE[spec], spec)
        res = AlgResult()
        banded_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        stat = align_giant2(AlgParams({}), nw, res, mesh=one)
        wall = time.perf_counter() - t0
        n_launch = banded_cuda.LAUNCHES
        launches += n_launch
        if stat != 0 or n_launch <= 0:
            fail(f"giant {n}x{n} {spec}: status {stat}, {n_launch} K7 "
                 f"launches")
        ref = make_alg_input(subst_np, y_np, x_np, GAPO, GAPE[spec], spec)
        rres = AlgResult()
        t0 = time.perf_counter()
        R, TW = nw.tile_hcol_len - 1, nw.tile_hrow_len - 1
        if algs["tpu7_pallas_mlsp"].align(
                AlgParams({"tileBy": [R], "tileBx": [TW]}), ref, rres):
            fail(f"tpu7_pallas_mlsp {n}x{n} {spec} failed")
        k1_wall = time.perf_counter() - t0
        shape_g = (nw.tile_hdr_mat_rows, nw.tile_hdr_mat_cols)
        shape_k1 = (ref.tile_hdr_mat_rows, ref.tile_hdr_mat_cols)
        for m in mats:
            a, b = getattr(nw, m), getattr(ref, m)
            if (a is None) != (b is None) or (
                    a is not None
                    and not same_shared_tiles(a, *shape_g, b, *shape_k1)):
                fail(f"giant {n}x{n} {spec}: {m} differs from K1's")
        if (res.align_cost, nw.best_i, nw.best_j) != (
                rres.align_cost, ref.best_i, ref.best_j):
            fail(f"giant {n}x{n} {spec}: cost/best {res.align_cost} "
                 f"{nw.best_i} {nw.best_j} vs K1 {rres.align_cost} "
                 f"{ref.best_i} {ref.best_j}")
        trace = ""
        if spec == "nw_ag":
            t0 = time.perf_counter()
            for alg, a_nw, a_res in (("tpu9_giant_mlsp", nw, res),
                                     ("tpu7_pallas_mlsp", ref, rres)):
                if algs[alg].trace(a_nw, a_res, False):
                    fail(f"{alg} {n}x{n} {spec}: trace failed")
            if (res.edit_trace != rres.edit_trace
                    or res.align_cost != rres.align_cost):
                fail(f"giant {n}x{n} {spec}: transcript differs from "
                     f"tpu7_pallas_mlsp's")
            trace = (f"; sparse trace of both {time.perf_counter() - t0:.1f}"
                     f" s, transcripts ({len(res.edit_trace)} characters) "
                     f"equal")
        laps = res.sw_align.laps()
        del nw, ref, res, rres
        plan, y, x = giant_inputs(torch, y_np, x_np, n, n, 1, spec=spec)
        R, TW, bc, BL = plan.R, plan.TW, plan.band_cols, plan.BL
        rows_p = plan.n_pass[0] * BL * R

        def fill():
            return giant2_fill(subst, [y], [x], GAPO, GAPE[spec], [n + 1],
                               [n + 1], mesh=one, plan=plan,
                               **kind_gap(spec))

        ms = cuda_ms(torch, fill, 2)
        got = dict(fill()[0][0])
        if "best" in got:
            got["best"] = got["best"][0]  # one call, at the pair's origin
        want = []
        plain_ms = cuda_ms(torch, lambda: want.extend(band_chain(
            torch, banded_pass_plain, subst, y, x, spec, n, n, R, TW, bc, 1,
            rows_p // R)), 1)
        err = max_abs_diff(torch, got, want[0])
        if err:
            fail(f"giant {n}x{n} {spec}: the fill != banded_pass_plain, "
                 f"max |diff| {err}")
        del got, want
        b_ms, b_by = bound_ms(spec, rows_p, bc, R, TW, S)
        out[spec] = dict(ms=ms, gcups=n * n / (ms * 1e-3) / 1e9,
                         launches=n_launch, bound_ms=b_ms, bound_by=b_by,
                         plain_ms=plain_ms, max_abs_err=err, wall_s=wall,
                         laps=laps)
        log(f"phase giant {n}x{n} {spec} D 1 (band {rows_p}x{bc}, tile "
            f"{R}x{TW}, BL {BL}): fill {ms:.3f} ms ({out[spec]['gcups']:.3f}"
            f" GCUPS), {n_launch} launches, bound {b_ms:.4f} ms ({b_by}), "
            f"bit-exact against banded_pass_plain (plain {plain_ms:.1f} ms); "
            f"align_giant2 {wall:.2f} s, laps ms "
            + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
            + f"; layout {shape_g[0]}x{shape_g[1]} tiles equal to K1's "
            f"{shape_k1[0]}x{shape_k1[1]} on the shared ones, cost and best "
            f"cell equal (tpu7 {k1_wall:.2f} s)" + trace)
    return dict(specs=out, launches=launches)


def giant_bands(torch, subst, S, n, specs, Ds) -> dict:
    """An n x n pair through giant2_fill on the one card at D = 1 and at
    each D of Ds (D bands on D streams, halos by device-local copies,
    calls of C passes by pick_call_passes), every spec of specs: the
    gathered layout of each D equal to D = 1's on the tiles both have;
    the fill's CUDA-event ms (mean of 3 after a warm-up), C, the calls a
    band and the launches, which must be D x calls."""
    from gpuseqalign_tpu_torch.ops import banded_cuda
    from gpuseqalign_tpu_torch.parallel import giant2_fill, make_mesh
    from gpuseqalign_tpu_torch.parallel.giant2 import gather_bands

    y_np, x_np = giant_pair(S, n)
    out = {}
    for spec in specs:
        base = None
        for D in (1,) + tuple(Ds):
            mesh = make_mesh(devices=["cuda:0"] * D, axis_name="sp")
            plan, y, x = giant_inputs(torch, y_np, x_np, n, n, D)
            bc, BL, C, calls = plan.band_cols, plan.BL, plan.C, plan.calls
            n_pass = plan.n_pass[0]
            rows_p = n_pass * BL * plan.R

            def fill():
                return giant2_fill(subst, [y], [x], GAPO, GAPE[spec],
                                   [n + 1], [n + 1], mesh=mesh, plan=plan,
                                   **kind_gap(spec))

            fill()  # warm-up
            ms = cuda_ms(torch, fill, 3)
            banded_cuda.LAUNCHES = 0
            bands = fill()[0]
            n_launch = banded_cuda.LAUNCHES
            if n_launch != D * calls:
                fail(f"giant {n}x{n} {spec} D {D}: {n_launch} launches, "
                     f"not D x {calls} calls")
            g = gather_bands([{k: v.cpu().numpy() for k, v in b.items()}
                              for b in bands], band_cols=bc,
                             tile_w=plan.TW)
            del bands
            if base is None:
                base, base_ms = g, ms
            else:
                for k, a in g.items():
                    b = base[k]
                    sl = tuple(slice(0, min(p, q))
                               for p, q in zip(a.shape, b.shape))
                    if not (a[sl] == b[sl]).all():
                        fail(f"giant {n}x{n} {spec} D {D}: {k} differs "
                             f"from D 1")
            out[f"{spec}_D{D}"] = dict(ms=ms, launches=n_launch, C=C,
                                       calls=calls, BL=BL, band_cols=bc,
                                       n_pass=n_pass)
            log(f"phase giant {n}x{n} {spec} D {D} on one card (band "
                f"{rows_p}x{bc}, BL {BL}, {n_pass} passes, calls of C {C} "
                f"passes, {calls} calls a band): fill {ms:.3f} ms "
                f"({n * n / (ms * 1e-3) / 1e9:.3f} GCUPS), {n_launch} "
                f"launches (D x calls)"
                + ("" if D == 1 else
                   f", {ms / base_ms:.3f}x D 1's, layout equal to D 1's"))
            del g
    return out


MULTIHOST_WORKER = """
import json, sys
sys.path.insert(0, sys.argv[3])
from gpuseqalign_tpu_torch.bench.throughput import synth_pairs
from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.io.subst import parse_subst_file
from gpuseqalign_tpu_torch.parallel import (
    align_pairs_multihost, distributed_init)
distributed_init("localhost:" + sys.argv[2], 2, int(sys.argv[1]))
subst = parse_subst_file(sys.argv[4]).subst_map["blosum62"]
pairs = synth_pairs(512, 100, 1500, subst.shape[0])
out = align_pairs_multihost(AlignSpec.from_name("sw_ag"), subst, pairs,
                            -11, -2, quantum="pow2", device="cuda:0")
print(json.dumps([out.costs.tolist(), out.best_i.tolist(),
                  out.best_j.tolist()]))
import torch.distributed
torch.distributed.destroy_process_group()
"""


def run_multihost(torch, subst_np, S) -> float:
    """align_pairs_multihost in two processes (gloo), both ranks on
    cuda:0: each rank's result equal to align_pairs_batched here.
    Returns the wall seconds of the two processes."""
    import socket

    from gpuseqalign_tpu_torch.bench.throughput import synth_pairs
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.parallel import align_pairs_batched

    os.makedirs(OUT, exist_ok=True)
    worker = os.path.join(OUT, "multihost_worker.py")
    with open(worker, "w") as f:
        f.write(MULTIHOST_WORKER)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(port), HERE,
         os.path.join(RESRC, "subst.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"multihost worker exit {proc.returncode}: {stderr}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    pairs = synth_pairs(512, 100, 1500, S)
    want = align_pairs_batched(AlignSpec.from_name("sw_ag"), subst_np, pairs,
                               GAPO, GAPE["sw_ag"], quantum="pow2")
    expect = [want.costs.tolist(), want.best_i.tolist(), want.best_j.tolist()]
    if outs != [expect, expect]:
        fail("align_pairs_multihost (2 processes) != align_pairs_batched")
    return wall


GIANT_PROCS_WORKER = """
import json, sys, time
sys.path.insert(0, sys.argv[3])
import numpy as np
import torch
import torch.distributed as dist
from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (
    AlgParams, AlgResult, make_alg_input)
from gpuseqalign_tpu_torch.io.fasta import parse_seq_file
from gpuseqalign_tpu_torch.io.subst import parse_subst_file
from gpuseqalign_tpu_torch.ops import banded_cuda
from gpuseqalign_tpu_torch.parallel import (
    align_giant2, distributed_init, make_mesh)
rank = int(sys.argv[1])
distributed_init("localhost:" + sys.argv[2], 2, rank)
mesh = make_mesh(devices=["cuda:0", "cuda:0"], axis_name="sp",
                 span_processes=True)
subst_file = parse_subst_file(sys.argv[4])
seq = np.asarray(parse_seq_file(sys.argv[5], subst_file.letter_map)
                 .seq_map[sys.argv[6]].seq, np.int32)
nw = make_alg_input(subst_file.subst_map["blosum62"], seq, seq, -11, -2,
                    "nw_ag")
res = AlgResult()
alg = get_algorithm_map()["tpu9_giant_mlsp"]
t0 = time.perf_counter()
stat = align_giant2(AlgParams({}), nw, res, mesh=mesh)
align_s = time.perf_counter() - t0
stats = [int(stat), int(alg.hash(nw, res)), int(alg.trace(nw, res, False))]
print(json.dumps({"rank": rank, "size": mesh.size, "stats": stats,
                  "cost": int(res.align_cost),
                  "score_hash": int(res.score_hash),
                  "trace_hash": int(res.trace_hash),
                  "edit_trace": res.edit_trace, "align_s": align_s,
                  "launches": banded_cuda.LAUNCHES,
                  "laps": res.sw_align.laps()}))
dist.destroy_process_group()
"""


def run_giant_procs(torch, subst_np, seq) -> dict:
    """align_giant2 on the release pair (nw_ag) over a mesh that spans two
    gloo processes, both on cuda:0, two bands each (D = 4): the halo of
    each call crosses the process edge through pinned host memory, and
    both ranks get every band. Each rank's statuses, cost, score hash,
    trace hash and transcript must equal align_giant2's at D = 1 here. A
    worker's exit other than 0 fails the run. Returns the two processes'
    wall seconds and each rank's numbers."""
    import socket

    from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
    from gpuseqalign_tpu_torch.core.types import (
        AlgParams,
        AlgResult,
        make_alg_input,
    )
    from gpuseqalign_tpu_torch.parallel import align_giant2

    os.makedirs(OUT, exist_ok=True)
    worker = os.path.join(OUT, "giant_procs_worker.py")
    with open(worker, "w") as f:
        f.write(GIANT_PROCS_WORKER)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), str(port), HERE,
         os.path.join(RESRC, "subst.json"), SEQS, RELEASE_SEQ],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"giant procs worker exit {proc.returncode}: "
                     f"{stderr[-3000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    alg = get_algorithm_map()["tpu9_giant_mlsp"]
    nw = make_alg_input(subst_np, seq, seq, GAPO, GAPE["nw_ag"], "nw_ag")
    res = AlgResult()
    stats = [int(align_giant2(AlgParams({}), nw, res)),
             int(alg.hash(nw, res)), int(alg.trace(nw, res, False))]
    want = dict(stats=stats, cost=int(res.align_cost),
                score_hash=int(res.score_hash),
                trace_hash=int(res.trace_hash), edit_trace=res.edit_trace)
    if stats != [0, 0, 0]:
        fail(f"giant release pair D 1: statuses {stats}")
    for out in outs:
        got = {k: out[k] for k in want}
        if out["size"] != 4 or got != want:
            bad = [k for k in want if got[k] != want[k]]
            fail(f"giant release pair over two processes, rank "
                 f"{out['rank']}: {bad} differ from D 1's")
    log(f"phase giant: align_giant2 on the release pair {FULL_N}^2 nw_ag "
        f"over two gloo processes on cuda:0 (D 4, 2 bands a process; card "
        f"{card_line()}): both ranks' cost {want['cost']}, score hash, trace"
        f" hash and transcript ({len(want['edit_trace'])} characters) equal"
        f" to D 1's; wall {wall:.1f} s for both processes, align_giant2 "
        + " / ".join(f"{o['align_s']:.2f}" for o in outs)
        + " s (rank 0 / 1), K7 launches "
        + " / ".join(str(o["launches"]) for o in outs) + "; laps ms "
        + " | ".join(", ".join(f"{k} {v:.1f}" for k, v in o["laps"].items())
                     for o in outs))
    return dict(wall_s=wall, ranks=[{k: o[k] for k in ("align_s", "launches",
                                                       "laps")}
                                    for o in outs])


def giant_stream_two_bands(torch, subst_np, want) -> dict:
    """pair_generated_1 nw_ag on two bands of the one card, where the
    stream has a band pipeline to fill: align_giant2_stream against one
    align_giant2 call a pair, windows alternating (sequential, stream,
    stream, sequential, ...), each mode's every cost and best cell equal
    to ``want`` (the D = 1 --giantSequential run's JSON). Returns the
    median window of each mode."""
    import numpy as np

    from gpuseqalign_tpu_torch.bench.throughput import file_pairs
    from gpuseqalign_tpu_torch.core.types import (
        AlgParams,
        AlgResult,
        make_alg_input,
    )
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import banded_cuda
    from gpuseqalign_tpu_torch.parallel import (
        align_giant2,
        align_giant2_stream,
        make_mesh,
    )

    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    pairs = file_pairs(SEQS, THROUGHPUT_RUNS[0][1][1], letters)
    mesh = make_mesh(devices=["cuda:0"] * 2, axis_name="sp")
    inputs = [make_alg_input(subst_np, y, x, GAPO, GAPE["nw_ag"], "nw_ag")
              for y, x in pairs]
    params = AlgParams({})
    ts = {"sequential": [], "stream": []}
    launches = {}
    for mode in ("sequential", "stream", "stream", "sequential") * 2:
        results = [AlgResult() for _ in inputs]
        banded_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        if mode == "stream":
            stats = align_giant2_stream(params, inputs, results, mesh=mesh)
        else:
            stats = [align_giant2(params, nw, res, mesh=mesh)
                     for nw, res in zip(inputs, results)]
        ts[mode].append(time.perf_counter() - t0)
        launches[mode] = banded_cuda.LAUNCHES
        got = ([res.align_cost for res in results],
               [nw.best_i for nw in inputs], [nw.best_j for nw in inputs])
        if any(stats) or got != (want["costs"], want["best_i"],
                                 want["best_j"]):
            fail(f"giant {mode} on two bands: statuses {stats} or results "
                 f"differ from D 1's")
        if launches[mode] <= 0:
            fail(f"giant {mode} on two bands: banded_pass never launched")
    out = {m: float(np.median(v)) for m, v in ts.items()}
    log(f"phase giant pair_generated_1 nw_ag on two bands of one card: "
        + "; ".join(
            f"{m} {len(pairs) / out[m]:.2f} pairs/s (median window "
            f"{out[m] * 1e3:.1f} ms; windows "
            + ", ".join(f"{v * 1e3:.1f}" for v in ts[m])
            + f" ms; {launches[m]} launches)" for m in ts)
        + "; costs and best cells equal to D 1's")
    return out


def bench_module(name: str):
    """A module of the benchmark (``generate``, ``reference/dp``), loaded
    from its file; both import numpy and torch only."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace("/", "_"),
        os.path.join(HERE, "benchmark", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def homolog_db(rng, queries, subjects):
    """Random subjects with, for each query, its own copy, copies with 10%
    and 30% of the residues replaced (residues 0-19), a copy with 25
    residues deleted and one with 40 inserted, a third of the way in."""
    import numpy as np

    out = list(subjects)
    for q in queries:
        out.append(q.copy())
        for share in (0.1, 0.3):
            c = q.copy()
            hit = np.flatnonzero(rng.random(len(q) - 1) < share) + 1
            c[hit] = rng.integers(0, 20, len(hit))
            out.append(c)
        cut = len(q) // 3
        out.append(np.concatenate([q[:cut], q[cut + 25:]]))
        out.append(np.concatenate(
            [q[:cut], rng.integers(0, 20, 40), q[cut:]]).astype(np.int32))
    return out


def phase_dbsearch(torch) -> dict:
    """Phase 11 (the module docstring): the database search on the cell's
    traffic and on a database of homologs. Returns, for each database,
    its buckets, launches, bytes sent and times."""
    import numpy as np

    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.ops import batch_cuda
    from gpuseqalign_tpu_torch.ops.batch_plain import scores_batch_plain
    from gpuseqalign_tpu_torch.parallel import dbsearch, load_db, search_db
    from gpuseqalign_tpu_torch.parallel.batch import fill_route, padded

    config, traffic = DBSEARCH_CELL
    with open(os.path.join(HERE, "benchmark", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "benchmark", "traffic",
                           traffic + ".json")) as f:
        tr = json.load(f)
    pool = bench_module("generate").make_pool(tr, cfg, DBSEARCH_SEED)
    subst_np = bench_module("reference/dp").matrix(cfg)
    spec = AlignSpec.from_name(cfg["algorithm"])
    gaps = (cfg["gapo"], cfg["gape"])
    kw = dict(kind=spec.kind.value, gap=spec.gap.value)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    subst = torch.from_numpy(subst_np).to(dev)

    cell_subjects = [x for _, x in pool[0]]
    rng = np.random.default_rng(DBSEARCH_SEED)
    hq = [np.concatenate([[0], rng.integers(0, 20, n)]).astype(np.int32)
          for n in DBSEARCH_HOMOLOG_QUERIES]
    dbs = (("cell", [p[0][0] for p in pool], cell_subjects),
           ("homologs", hq, homolog_db(
               rng, hq, cell_subjects[:DBSEARCH_HOMOLOG_RANDOM])))
    out = {}
    for label, queries, subjects in dbs:
        loads = dbsearch.DB_LOADS
        t0 = time.perf_counter()
        db = load_db(subjects, device=dev)
        load_s = time.perf_counter() - t0
        if dbsearch.DB_LOADS != loads + 1:
            fail(f"dbsearch {label}: DB_LOADS moved by "
                 f"{dbsearch.DB_LOADS - loads}, not 1")
        sent = dbsearch.SEARCH_H2D_BYTES
        batch_cuda.FILL_LAUNCHES = batch_cuda.TINY_LAUNCHES = 0
        t0 = time.perf_counter()
        results = [search_db(spec, subst_np, q, db, *gaps) for q in queries]
        search_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
        launched = {"fill": batch_cuda.FILL_LAUNCHES,
                    "tiny": batch_cuda.TINY_LAUNCHES}
        want = {"fill": 0, "tiny": 0}
        want_bytes = subst_np.nbytes
        for q in queries:
            rows_p = padded(len(q) - 1, "pow2")
            want_bytes += 4 * (2 + rows_p)
            for _, adjcs in db.buckets:
                want[fill_route(rows_p, len(adjcs), sms)] += 1
        if launched != want or min(launched.values()) <= 0:
            fail(f"dbsearch {label}: launches (K5, K6) {launched}, the "
                 f"route gives {want}; both must run")
        if dbsearch.SEARCH_H2D_BYTES - sent != want_bytes:
            fail(f"dbsearch {label}: the searches sent "
                 f"{dbsearch.SEARCH_H2D_BYTES - sent} bytes to the card, "
                 f"not the queries' and the matrix's {want_bytes}")
        # Each bucketed subject's input index, in bucket order.
        inv = db.inv.cpu().numpy()
        live = np.setdiff1d(np.arange(len(subjects)), db.empty)
        order = live[np.argsort(inv[live], kind="stable")]
        t0 = time.perf_counter()
        for q, res in zip(queries, results):
            answers = np.stack([res.costs, res.best_i, res.best_j])
            rows_p = padded(len(q) - 1, "pow2")
            ys = torch.zeros((1, 1 + rows_p), dtype=torch.int32)
            ys[0, :len(q)] = torch.from_numpy(q)
            ys = ys.to(dev)
            adjrs = torch.tensor([len(q)], dtype=torch.int32, device=dev)
            start = 0
            for xs, adjcs in db.buckets:
                b, cols_p = len(adjcs), xs.shape[1] - 1
                plain = torch.stack(scores_batch_plain(
                    subst, ys, xs, adjrs, adjcs, *gaps, **kw)).cpu()
                tiny = torch.stack(batch_cuda.tiny_scores(
                    subst, ys, xs, *gaps, adjrs, adjcs, **kw)).cpu()
                got = batch_cuda.mlsp_fill_batch(
                    subst, ys, xs, *gaps, adjrs, adjcs,
                    tile_h=math.gcd(rows_p, 128),
                    tile_w=math.gcd(cols_p, 512), **kw)
                fill = torch.cat([got["cost"].view(1, -1),
                                  got["best"][:, 1:].t()]).cpu()
                mine = torch.from_numpy(answers[:, order[start:start + b]])
                for name, t in (("mlsp_tiny", tiny), ("mlsp_fill_batch",
                                                      fill),
                                ("search_db", mine)):
                    if not torch.equal(t, plain):
                        fail(f"dbsearch {label}: {name} != "
                             f"scores_batch_plain, query {len(q) - 1} "
                             f"residues, bucket {rows_p}x{cols_p} of {b}")
                start += b
        check_s = time.perf_counter() - t0
        costs = np.stack([r.costs for r in results])
        out[label] = dict(
            subjects=len(subjects), load_s=load_s, search_ms=search_ms,
            check_s=check_s, launches=launched,
            h2d_bytes=dbsearch.SEARCH_H2D_BYTES - sent,
            buckets=[(xs.shape[1] - 1, len(adjcs)) for xs, adjcs in
                     db.buckets], max_cost=int(costs.max()))
        log(f"phase dbsearch {label}: {len(subjects)} subjects, buckets "
            f"(cols_p, subjects) {out[label]['buckets']}, load "
            f"{load_s:.3f} s, {len(queries)} searches "
            f"({', '.join(str(len(q) - 1) for q in queries)} residues) "
            f"{search_ms:.3f} ms each (first with the matrix), launches "
            f"{launched}, {out[label]['h2d_bytes']} B to the card; every "
            f"bucket through mlsp_tiny, mlsp_fill_batch and search_db "
            f"bit-exact against scores_batch_plain ({check_s:.1f} s); "
            f"largest cost {out[label]['max_cost']}")
    if out["homologs"]["max_cost"] <= 32767:
        fail(f"dbsearch homologs: largest cost {out['homologs']['max_cost']}"
             " does not pass 16 bits")
    return out


def phase_scaling() -> dict:
    """bench.scaling_report at its full sizes on the card (every row from
    a fresh subprocess, each naming what it ran on), its document written
    to logs/chip_smoke/scaling_report.json; every row logged. A row that
    fails fails the phase."""
    import contextlib
    import io

    from gpuseqalign_tpu_torch.bench import scaling_report

    path = os.path.join(OUT, "scaling_report.json")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = scaling_report.main(["--out", path])
    except (RuntimeError, subprocess.TimeoutExpired) as err:
        fail(f"scaling report: {err}")
    if rc != 0:
        fail(f"scaling report: exit {rc}")
    with open(path) as f:
        report = json.load(f)
    for name, row in report["configs"].items():
        log(f"phase scaling {name}: " + json.dumps(row))
    log(f"phase scaling: {len(report['configs'])} rows in "
        f"{report['elapsed_s']:.1f} s")
    return report


def phase_giant(torch, cli_main, subst, subst_np, S) -> dict:
    """The giant phase (7 in the module docstring). Returns its numbers;
    "launches" counts K7's launches in the 100000^2 D = 1 align_giant2
    calls, the phase's main path."""
    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import banded_cuda
    from gpuseqalign_tpu_torch.parallel import align_pairs_batched, make_mesh

    r = {}
    t0 = time.perf_counter()
    params = {"cpu1_st_row": {}, "tpu9_giant_mlsp": {}}
    for spec in SPECS:
        banded_cuda.LAUNCHES = 0
        rows = run_cli(cli_main, spec, params, cli_pairs(), f"giant_{spec}")
        if banded_cuda.LAUNCHES <= 0:
            fail(f"giant cli {spec}: banded_pass never launched")
        calc = sum(float(x["align.calc"]) for x in rows
                   if x["alg_name"] == "tpu9_giant_mlsp")
        log(f"phase giant cli {spec}: {len(rows)} rows err_step 0, "
            f"{banded_cuda.LAUNCHES} banded_pass launches, tpu9 align.calc "
            f"ms summed {calc:.1f}")
    r["cli_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    r["full"] = giant_full(torch, subst, subst_np, S)
    r["launches"] = r["full"]["launches"]
    r["full_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    r["bands"] = giant_bands(torch, subst, S, FULL_N, SPECS, (2, 4))
    r["bands"].update(giant_bands(torch, subst, S, GIANT_N, ("nw_ag",),
                                  (2, 4)))
    r["bands_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    for flag in ("--giantStream", "--giantSequential"):
        out_json = os.path.join(OUT, f"throughput_giant_{flag[7:]}.json")
        banded_cuda.LAUNCHES = 0
        rc = throughput.main([
            "--seqPath", SEQS,
            "--substPath", os.path.join(RESRC, "subst.json"),
            "--seqPairPath", THROUGHPUT_RUNS[0][1][1], "--algKind", "nw_ag",
            "--gapoCost", str(GAPO), "--gapeCost", str(GAPE["nw_ag"]),
            "--verify", "5", "--repeat", "3", "--jsonPath", out_json, flag])
        if rc != 0 or banded_cuda.LAUNCHES <= 0:
            fail(f"throughput {flag}: exit {rc}, {banded_cuda.LAUNCHES} "
                 f"banded_pass launches")
        with open(out_json) as f:
            res = json.load(f)
        r[flag[2:]] = res["pairs_per_s"]
        log(f"phase giant {flag} pair_generated_1 nw_ag ({res['mode']}, D "
            f"{res['bands']}): {res['pairs']} pairs, "
            f"{res['pairs_per_s']:.2f} pairs/s, {res['gcups']:.3f} "
            f"GCUPS (live cells) over the median window "
            f"{res['seconds'] * 1e3:.1f} ms (windows "
            + ", ".join(f"{v * 1e3:.1f}" for v in res["seconds_all"])
            + "), oracle check of 5 pairs ok")
    r["stream_D2"] = giant_stream_two_bands(torch, subst_np, res)
    r["streams_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    pairs = throughput.file_pairs(SEQS, THROUGHPUT_RUNS[0][1][1], letters)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    for spec in ("nw_ag", "sw_ag"):
        aspec = AlignSpec.from_name(spec)
        one = align_pairs_batched(aspec, subst_np, pairs, GAPO, GAPE[spec],
                                  quantum="pow2")
        two = align_pairs_batched(aspec, subst_np, pairs, GAPO, GAPE[spec],
                                  quantum="pow2", mesh=mesh)
        for k in ("costs", "best_i", "best_j"):
            if not (getattr(one, k) == getattr(two, k)).all():
                fail(f"batch mesh of 2 != no mesh: {spec} {k}")
    log("phase giant: align_pairs_batched on a two-entry mesh equals no "
        "mesh on pair_generated_1 (nw_ag, sw_ag)")
    r["multihost_s"] = run_multihost(torch, subst_np, S)
    log(f"phase giant: align_pairs_multihost in two processes on cuda:0 "
        f"equals align_pairs_batched (512 synthetic pairs, sw_ag) in "
        f"{r['multihost_s']:.1f} s")
    r["mesh_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    r["procs"] = run_giant_procs(torch, subst_np, release_seq())
    r["procs_s"] = time.perf_counter() - t0
    return r


# Columns of the strips phase 8 holds against their plain versions: one
# step, a part chunk of 32 steps beside whole ones, and whole chunks.
PROBE_COLS = (1, 33, 45, 64)


def check_probe_kernels(torch) -> int:
    """Every probe kernel, body, variant, strip count and rows a strip
    against its plain version on the card at small sizes, bit-exact;
    returns the cases."""
    from gpuseqalign_tpu_torch.bench.vpu_probe import (
        chain_input,
        strip_inputs,
    )
    from gpuseqalign_tpu_torch.ops import probe_cuda
    from gpuseqalign_tpu_torch.ops import probe_plain as pp

    dev = torch.device("cuda")
    cases = 0

    def same(name, got, want):
        nonlocal cases
        if not isinstance(got, dict):
            got, want = {"out": got}, {"out": want}
        err = max_abs_diff(torch, got, want)
        if err:
            fail(f"{name}: kernel != plain, max |diff| {err}")
        cases += 1

    for body in pp.CHAIN_BODIES:
        skeleton = body.startswith("skeleton_")
        gape = GAPE["nw_ag"] if body.endswith("_ag") else 0
        for nch in probe_cuda.STRIP_K if skeleton else probe_cuda.CHAIN_NCH:
            for nt in probe_cuda.STRIP_ROWS if skeleton else (256,):
                for iters in PROBE_COLS if skeleton else (0, 1, 53):
                    a = chain_input(3 if skeleton else 5, nt, dev,
                                    f"check {body} {nch} {nt} {iters}")
                    same(f"probe_chain {body} nch {nch} rows {nt} iters "
                         f"{iters}",
                         probe_cuda.probe_chain(a, body, nch, iters, GAPO,
                                                gape),
                         pp.chain_plain(a, body, nch, iters, GAPO, gape))
    for mode in pp.INT16_MODES:
        for iters in (0, 1, 77):
            a = chain_input(5, 256, dev, f"check {mode} {iters}",
                            full_words=mode != "i32")
            same(f"probe_int16 {mode} iters {iters}",
                 probe_cuda.probe_int16(a, mode, iters),
                 pp.int16_plain(a, mode, iters))
    for gap in ("linear", "affine"):
        gape = GAPE["nw_ag"] if gap == "affine" else 0
        for variant in pp.VARIANTS:
            nts = (32,) if variant == "onewarp" else probe_cuda.STRIP_ROWS
            for K, nt, iters in itertools.product(probe_cuda.STRIP_K, nts,
                                                  PROBE_COLS):
                ins = strip_inputs(3, K, nt, iters, dev,
                                   f"check {gap} {variant} {K} {nt} {iters}")
                same(f"probe_fullstep {gap} {variant} K {K} rows {nt} iters "
                     f"{iters}",
                     probe_cuda.probe_fullstep(*ins, GAPO, gape, gap=gap,
                                               variant=variant),
                     pp.fullstep_plain(*ins, GAPO, gape, gap=gap,
                                       variant=variant))
    torch.cuda.synchronize()
    return cases


def check_probe_strips(torch) -> int:
    """The skeleton (constant scores) and fullstep (real letters) strips,
    of 32, 128 and 256 rows, against the oracle on the same pair; returns
    the strips checked."""
    import numpy as np

    from gpuseqalign_tpu_torch.bench.vpu_probe import strip_inputs
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.models.oracle import oracle_align_dense
    from gpuseqalign_tpu_torch.ops import probe_cuda

    dev = torch.device("cuda")
    strips = 0

    def oracle(spec, subst, y_row, x_row):
        return oracle_align_dense(
            AlignSpec.from_name(spec), subst,
            np.concatenate([[0], y_row]).astype(np.int32),
            np.asarray(x_row, np.int32), GAPO, GAPE[spec])

    # 70 columns: a part chunk of 32 steps at each end, a whole one between.
    nt, iters, K = 128, 70, 2
    for spec, rows in itertools.product(("nw_lg", "nw_ag"), (nt, 256)):
        a = torch.full((2, rows), 3, dtype=torch.int32, device=dev)
        got = probe_cuda.probe_chain(a, f"skeleton_{spec}", K, iters, GAPO,
                                     GAPE[spec]).cpu().numpy()
        want = np.max([oracle(spec, np.full((25, 25), 3 + k, np.int32),
                              np.zeros(rows), np.zeros(iters + 1))["H"][1:, iters]
                       for k in range(K)], 0)
        if not (got == want).all():
            fail(f"skeleton_{spec} at {rows} rows != oracle")
        strips += 2 * K
    for spec in SPECS:
        gap = "affine" if spec.endswith("_ag") else "linear"
        kind = "sw" if spec.startswith("sw") else "base"
        for variant, rows in ((kind, nt), (kind, 256), ("onewarp", 32)):
            if variant == "onewarp" and kind == "sw":
                continue
            ins = strip_inputs(2, K, rows, iters, dev,
                               f"oracle {spec} {rows}")
            got = {k: v.cpu().numpy() for k, v in probe_cuda.probe_fullstep(
                *ins, GAPO, GAPE[spec], gap=gap, variant=variant).items()}
            subst, y, x = (t.cpu().numpy() for t in ins[:3])
            for b in range(2):
                for k in range(K):
                    m = oracle(spec, subst, y[b, k], x[k])
                    H = m["H"]
                    want = {"hcol": H[1:, iters], "hrow": H[rows, 1:]}
                    if gap == "affine":
                        want["ecol"] = m["E"][1:, iters]
                        want["frow"] = m["F"][rows, 1:]
                    if variant == "sw":
                        v, j = H[1:, 1:].max(1), H[1:, 1:].argmax(1) + 1
                        hit = v > 0
                        want["best"] = np.stack(
                            [v, np.arange(1, rows + 1) * hit, j * hit], -1)
                    for key, w in want.items():
                        if not (got[key][b, k] == w).all():
                            fail(f"probe_fullstep {spec} {variant} strip "
                                 f"({b}, {k}) {key} != oracle")
                    strips += 1
    return strips


def probe_main_path(torch) -> dict:
    """bench.vpu_probe's probes and bench.headline on the card, each
    result logged as a JSON line; returns the results."""
    import contextlib
    import io

    from gpuseqalign_tpu_torch.bench import headline, vpu_probe

    dev = torch.device("cuda")
    res = {"ops": vpu_probe.probe_ops(dev),
           "skeleton_nw_lg": vpu_probe.probe_skeleton(False, device=dev),
           "skeleton_nw_ag": vpu_probe.probe_skeleton(True, device=dev),
           "int16": vpu_probe.probe_int16(dev)}
    for kind, gap in (("nw", "linear"), ("sw", "linear"), ("nw", "affine"),
                      ("sw", "affine")):
        spec = vpu_probe.spec_name(kind, gap)
        res[f"roofline_{spec}"] = vpu_probe.roofline_body(kind, gap,
                                                          device=dev)
    for gap in ("linear", "affine"):
        spec = vpu_probe.spec_name("nw", gap)
        res[f"fullstep_{spec}"] = vpu_probe.probe_fullstep(
            res[f"roofline_{spec}"]["K"], gap=gap, device=dev,
            rows=res[f"roofline_{spec}"]["rows"])
        res[f"gridcost_{spec}"] = vpu_probe.probe_gridcost(FULL_N, gap,
                                                           device=dev)
    for name, r in res.items():
        log(f"phase probe {name}: " + json.dumps(r))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = headline.main([], device=dev)
    line = buf.getvalue().strip().splitlines()[-1]
    log(line)
    res["headline"] = json.loads(line)
    if rc != 0:
        fail(f"bench.headline exit {rc}")
    return res


def probe_resources() -> None:
    """Registers, spills and resident blocks of every probe kernel, its
    SASS opcodes and each strip kernel's hot-loop opcodes to
    logs/chip_smoke/probe_sass.json, the strip kernels' SASS to
    probe_sass_strips.txt.gz; spills and hot loops logged."""
    import gzip

    from gpuseqalign_tpu_torch.bench.vpu_probe import sass_summary

    summary = sass_summary(keep_text=True)
    os.makedirs(OUT, exist_ok=True)
    with gzip.open(os.path.join(OUT, "probe_sass_strips.txt.gz"), "wt") as f:
        f.write(summary.pop("strip_sass"))
    with open(os.path.join(OUT, "probe_sass.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log("phase probe hot loops (instructions): " + json.dumps(
        {k: v.get("insns") for k, v in summary["hot_loop"].items()}))
    spills = {k: v["local_bytes"] for k, v in summary["resources"].items()
              if v["local_bytes"]}
    log(f"phase probe resources: {len(summary['resources'])} kernels, "
        f"spills (local bytes a thread) {spills or 'none'}; registers "
        + json.dumps({k: v["regs"] for k, v in summary["resources"].items()}))


def time_probe_kernels(torch, res) -> dict:
    """Every probe kernel at the sizes the main path ran it, against its
    plain version on the same inputs, bit-exact: each ops body and int16
    mode at M1 on its card grid, each skeleton at its largest K and grid
    at M2, every fullstep variant at the roofline's K and rows on its grid
    at M2, and each spec's roofline winner (sw included) at its R, K, grid
    and both column counts. One call of each kernel is also timed for the
    kernels line (CUDA-event ms, mean of 3 after a warm-up; plain ms of
    one call) with its bound over the int32 instructions it issues (a
    chain body's over the pipe its one instruction issues on,
    ``vpu_probe.BODY_PEAK``, the int32 pipe for the int16 modes);
    max_abs_err is over every call held. The nw bodies are also timed
    and held at PROBE_OLD_GRIDS, to stand beside the earlier design's
    readings."""
    from gpuseqalign_tpu_torch.bench import vpu_probe as vp
    from gpuseqalign_tpu_torch.ops import probe_cuda
    from gpuseqalign_tpu_torch.ops import probe_plain as pp

    dev = torch.device("cuda")
    out = {k: dict(max_abs_err=0, held=0) for k in probe_cuda.LAUNCHES}

    def hold(kernel, name, run, plain):
        """Kernel against plain on one call; returns the plain ms."""
        got = run()
        want = []
        plain_ms = cuda_ms(torch, lambda: want.append(plain()), 1)
        if not isinstance(got, dict):
            got, want = {"out": got}, [{"out": want[0]}]
        err = max_abs_diff(torch, got, want[0])
        out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
        if err:
            fail(f"{kernel} {name} != plain at the main path's size: "
                 f"max |diff| {err}")
        out[kernel]["held"] += 1
        return plain_ms

    def timed(kernel, name, run, plain, nbytes, ops, peak=None):
        run()
        ms = cuda_ms(torch, run, 3)
        plain_ms = hold(kernel, name, run, plain)
        b_ms, b_by = bound(nbytes, ops, peak)
        out[kernel].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, timed=name)
        log(f"phase probe timing {kernel} {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), bit-exact")

    nt, iters = vp.CARD.chain_threads, vp.CARD.chain_iters[0]
    for body in vp.BODY_INSNS:
        blocks, _ = vp.card_grid(dev, "probe_chain", body, vp.OPS_CHAINS,
                                 nt)
        a = vp.chain_input(blocks, nt, dev, body)
        run = (lambda a=a, body=body: probe_cuda.probe_chain(
            a, body, vp.OPS_CHAINS, iters))
        plain = (lambda a=a, body=body: pp.chain_plain(
            a, body, vp.OPS_CHAINS, iters))
        name = f"{body} x{blocks} blocks, {iters} iterations"
        if body == "maxadd2":
            timed("probe_chain", name, run, plain, 8 * a.numel(),
                  a.numel() * vp.OPS_CHAINS * iters * vp.BODY_INSNS[body],
                  vp.BODY_PEAK[body])
        else:
            hold("probe_chain", name, run, plain)
    rows, m1, m2 = vp.CARD.strip_rows, *vp.CARD.strip_iters
    for spec in ("nw_lg", "nw_ag"):
        body, K = f"skeleton_{spec}", max(probe_cuda.STRIP_K)
        blocks, _ = vp.card_grid(dev, "probe_chain", body, K, rows)
        a = vp.chain_input(blocks, rows, dev, body)
        hold("probe_chain", f"{body} K{K} x{blocks} blocks, {m2} columns",
             lambda: probe_cuda.probe_chain(a, body, K, m2, GAPO,
                                            GAPE[spec]),
             lambda: pp.chain_plain(a, body, K, m2, GAPO, GAPE[spec]))
    for mode in pp.INT16_MODES:
        blocks, _ = vp.card_grid(dev, "probe_int16", mode, 0, nt)
        a = vp.chain_input(blocks, nt, dev, mode, full_words=mode != "i32")
        run = (lambda a=a, mode=mode: probe_cuda.probe_int16(a, mode,
                                                             iters))
        plain = (lambda a=a, mode=mode: pp.int16_plain(a, mode, iters))
        name = f"{mode} x{blocks} blocks, {iters} iterations"
        if mode == "i16x2":
            timed("probe_int16", name, run, plain, 8 * a.numel(),
                  a.numel() * pp.INT16_CHAINS * iters * vp.INT16_INSNS[mode],
                  vp.INT32_PIPE_INSNS_PER_S)
        else:
            hold("probe_int16", name, run, plain)

    def strip_call(gap, variant, K, blocks, cols, nt=rows):
        nt_ = 32 if variant == "onewarp" else nt
        ins = vp.strip_inputs(blocks, K, nt_, cols, dev, variant)
        gape = GAPE["nw_ag"] if gap == "affine" else 0
        strips = blocks * K
        outs = strips * (nt_ + cols) * (2 if gap == "affine" else 1)
        outs += 3 * strips * nt_ if variant == "sw" else 0
        return (lambda: probe_cuda.probe_fullstep(
                    *ins, GAPO, gape, gap=gap, variant=variant),
                lambda: pp.fullstep_plain(*ins, GAPO, gape, gap=gap,
                                          variant=variant),
                4 * (sum(t.numel() for t in ins) + outs),
                strips * nt_ * cols)

    for gap, kernel in (("linear", "probe_fullstep"),
                        ("affine", "probe_fullstep_affine")):
        nw = res[f"roofline_{vp.spec_name('nw', gap)}"]
        K = nw["K"]
        for variant in pp.VARIANTS:
            nt_ = 32 if variant == "onewarp" else nw["rows"]
            blocks, _ = vp.card_grid(dev, kernel, variant, K, nt_)
            run, plain, _, _ = strip_call(gap, variant, K, blocks, m2, nt_)
            hold(kernel, f"{variant} K{K} rows {nt_} x{blocks} blocks, "
                 f"{m2} columns", run, plain)
        for kind in ("nw", "sw"):
            spec = vp.spec_name(kind, gap)
            best = res[f"roofline_{spec}"]
            variant = "sw" if kind == "sw" else "base"
            for cols in (m1, m2):
                run, plain, nbytes, cells = strip_call(
                    gap, variant, best["K"], best["blocks"], cols,
                    best["rows"])
                name = (f"roofline {spec} {variant} R{best['R']} "
                        f"K{best['K']} x{best['blocks']} blocks, {cols} "
                        f"columns")
                if kind == "nw" and cols == m2:
                    timed(kernel, name, run, plain, nbytes,
                          cell_insns(spec) * cells)
                else:
                    hold(kernel, name, run, plain)
        # The earlier design's grid of this body, timed and held (logged).
        spec = vp.spec_name("nw", gap)
        K_old, blocks_old = PROBE_OLD_GRIDS[spec]
        run, plain, nbytes, cells = strip_call(gap, "base", K_old,
                                               blocks_old, m2)
        run()
        ms = cuda_ms(torch, run, 3)
        hold(kernel, f"old grid {spec} base K{K_old} x{blocks_old} blocks, "
             f"{m2} columns", run, plain)
        b_ms, b_by = bound(nbytes, cell_insns(spec) * cells)
        out[kernel]["old_grid"] = dict(ms=ms, bound_ms=b_ms, K=K_old,
                                       blocks=blocks_old, rows=rows,
                                       cols=m2)
        log(f"phase probe timing {kernel} at the old grid (base {spec}, "
            f"K{K_old}, {blocks_old} blocks x {rows} rows x {m2} columns): "
            f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of it, bit-exact")
    log("phase probe held at the main path's sizes: " + json.dumps(
        {k: v["held"] for k, v in out.items()}))
    return out


# The grids at which the probes' earlier design (a thread a row, a block
# barrier a step) timed K8b and K8c, base, strips of 128 rows, 2048
# columns: (strips a block, blocks). It took 2.3587 ms (nw_lg) and 1.1531
# ms (nw_ag) there on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
PROBE_OLD_GRIDS = {"nw_lg": (8, 792), "nw_ag": (1, 2112)}


# The tools phase: the fuzz's seed and cases on the card (their draws hold
# tpu7 tiles with a side <= 3, batch buckets for K5 and for K6, and every
# case runs the giant engine), and the reduced tile grids of the tuners.
TOOLS_FUZZ_SEED = 20261019
TOOLS_FUZZ_CASES = 100
TOOLS_V2_GRID = {"tileBy": [128, 256], "tileBx": [512, 1024]}
TOOLS_BANDED_GRID = {"tileBy": [128, 256], "tileBx": [128]}
DEMO_N = 100000


def tools_fuzz(torch) -> dict:
    """bench.fuzz.main on the card (fixed seed, TOOLS_FUZZ_CASES cases,
    --includeGiant): it must report every case with 0 failures, and the
    launch counters must show K1, K3, K5, K6 and K7 in the run. The seed's
    draws are checked first for a tpu7 tile side <= 3 and for batch
    buckets that fill_route sends to K5 and to K6."""
    import contextlib
    import io

    from gpuseqalign_tpu_torch.bench import fuzz
    from gpuseqalign_tpu_torch.ops import (
        banded_cuda,
        batch_cuda,
        dense_cuda,
        mlsp_cuda,
    )

    seed, n = TOOLS_FUZZ_SEED, TOOLS_FUZZ_CASES
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    small = []
    for k in range(n):
        c = fuzz._gen_case(seed, k)
        if min(c["tpu7Tiles"]) <= 3 and min(len(c["y"]), len(c["x"])) > 1:
            small.append(k)
    routes = {}
    for k in range(0, n, 5):
        for r in fuzz.batch_routes(fuzz._gen_batch_case(seed, k, sms), sms):
            routes[r] = routes.get(r, 0) + 1
    if not small or set(routes) != {"fill", "tiny"}:
        fail(f"tools fuzz seed {seed}: the draws miss a case (tpu7 tile "
             f"side <= 3 in cases {small}, batch routes {routes})")
    mlsp_cuda.LAUNCHES = dense_cuda.LAUNCHES = banded_cuda.LAUNCHES = 0
    batch_cuda.FILL_LAUNCHES = batch_cuda.TINY_LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fuzz.main(["--cases", str(n), "--seconds", "0", "--seed",
                        str(seed), "--includeGiant"], device="cuda")
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"phase tools fuzz: {line}")
    launches = {"mlsp_fill": mlsp_cuda.LAUNCHES,
                "dense_fill": dense_cuda.LAUNCHES,
                "mlsp_fill_batch": batch_cuda.FILL_LAUNCHES,
                "mlsp_tiny": batch_cuda.TINY_LAUNCHES,
                "banded_pass": banded_cuda.LAUNCHES}
    if rc != 0 or f"{n} cases, 0 failures" not in out:
        fail(f"tools fuzz seed {seed}: exit {rc}")
    if min(launches.values()) <= 0:
        fail(f"tools fuzz: a kernel was never launched: {launches}")
    log(f"phase tools fuzz: {n} cases, 0 failures on the card in "
        f"{wall:.1f} s (seed {seed}); tpu7 tile side <= 3 in cases {small}; "
        f"batch buckets by route {routes}; launches {launches}")
    return dict(cases=n, seed=seed, s=wall, launches=launches)


def tools_tune(torch, subst_np, seq) -> dict:
    """tune_v2 and tune_banded (nw_ag) on reduced grids at the release
    pair's size, each tile gated on the oracle and timed with CUDA
    events; both entries saved with save_defaults under a temporary root,
    never into the checkout, and read back through ops/tuned.py."""
    import contextlib
    import io
    import tempfile

    from gpuseqalign_tpu_torch.bench import autotune
    from gpuseqalign_tpu_torch.core.types import AlignSpec
    from gpuseqalign_tpu_torch.ops import tuned

    spec = AlignSpec.from_name("nw_ag")
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, tuner, grid in (
                ("tune_v2", autotune.tune_v2, TOOLS_V2_GRID),
                ("tune_banded", autotune.tune_banded, TOOLS_BANDED_GRID)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(buf):
                best = tuner(subst_np, seq, spec, GAPO, GAPE["nw_ag"],
                             grid=grid, verbose=True, device="cuda")
            for line in buf.getvalue().splitlines():
                log(f"phase tools {name} nw_ag {FULL_N}^2:{line}")
            log(f"phase tools {name} nw_ag {FULL_N}^2: winner "
                f"{json.dumps(best)} in {time.perf_counter() - t0:.1f} s")
            out[name] = best
        autotune.save_defaults(out["tune_v2"], spec.name, root=root)
        autotune.save_defaults({"banded": out["tune_banded"]}, spec.name,
                               root=root)
        got = tuned.tuned_defaults(spec.name, "cuda", root=root)
        if got != {**out["tune_v2"], "banded": out["tune_banded"]}:
            fail(f"tools: the saved cache reads back as {got}")
    return out


def tools_demo(torch) -> dict:
    """giant_demo.run_demo(DEMO_N, nw_ag) on the card; its first tile-header
    row (H and F of row tile_h, and H and E of rows 1..tile_h at the tile
    columns) held bit-exactly against mlsp_fill_plain on the same rows on
    the card; then the demo's line."""
    from gpuseqalign_tpu_torch.bench import giant_demo
    from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain

    r = giant_demo.run_demo(DEMO_N, "nw_ag", "cuda")
    th = r["tile"][0]
    ins, kw = r["inputs"], dict(r["fill_kw"])
    kw["adjr"] = 2 * th + 1
    plain = mlsp_fill_plain(ins["subst"], ins["y"][:2 * th + 1].contiguous(),
                            ins["x"], **kw)
    got = {"hrows": r["headers"]["hrows"][1], "hcols": r["headers"]["hcols"][0],
           "frows": r["headers"]["frows"][1], "ecols": r["headers"]["ecols"][0]}
    want = {"hrows": plain["hrows"][1], "hcols": plain["hcols"][0],
            "frows": plain["frows"][1], "ecols": plain["ecols"][0]}
    err = max_abs_diff(torch, got, want)
    if err:
        fail(f"giant_demo {DEMO_N}^2: the first tile-header row differs from "
             f"the plain fill's, max |diff| {err}")
    log(f"phase tools giant_demo: card {card_line()}, tile {th}x"
        f"{r['tile'][1]}, first fill (build included) {r['first_s']:.2f} s; "
        f"first tile-header row bit-exact against mlsp_fill_plain")
    log(f"phase tools giant_demo: {giant_demo.demo_line(r)}")
    return dict(ms=r["ms"], gcups=r["gcups"], tile=r["tile"],
                out_bytes=r["out_bytes"])


def body_shares(per_spec, dense_spec, fill, runs, banded, giant, wave,
                probe):
    """Each fill's GCUPS in this run beside the same run's roofline body
    for its spec and the card's issue rate: logged, and returned."""
    from gpuseqalign_tpu_torch.bench.vpu_probe import ISSUE_INSNS_PER_S

    def live_gcups(e, spec):
        # The batch kernels' instruction counts cover their live cells.
        return e["ops"] / cell_insns(spec) / (e["ms"] * 1e-3) / 1e9

    rows = {}  # name: (GCUPS, spec, launches a call)
    for spec in SPECS:
        rows[f"mlsp_fill {spec} 23728^2"] = (
            per_spec[spec]["gcups"], spec,
            per_spec[spec]["launches_per_fill"])
        rows[f"dense_fill {spec} 23728^2"] = (
            dense_spec[spec]["gcups"], spec,
            dense_spec[spec]["launches_per_fill"])
        rows[f"banded_pass {spec} 23728^2"] = (
            banded[spec]["gcups"], spec, banded[spec]["launches_per_fill"])
        g = giant["full"]["specs"][spec]
        rows[f"banded_pass {spec} 100000^2"] = (g["gcups"], spec,
                                                g["launches"])
    rows["mlsp_fill_batch nw_ag pair_generated_1"] = (
        live_gcups(fill, "nw_ag"), "nw_ag", fill["launches"] / fill["calls"])
    for name, e in wave.items():
        rows[f"{name} nw_lg 23728^2 R {e['R']}"] = (
            e["gcups"], "nw_lg", e["launches_per_fill"])
    for spec in SPECS:
        rows[f"mlsp_tiny {spec} synth_16384"] = (live_gcups(
            runs[f"synth_16384_{spec}"]["kernels"]["mlsp_tiny"], spec), spec,
            None)
    out = {}
    for name, (gcups, spec, launches) in rows.items():
        body = probe[f"roofline_{spec}"]["gcups"]
        out[name] = dict(gcups=gcups, body_gcups=body,
                         body_share=gcups / body,
                         bound_share=gcups * 1e9 * cell_insns(spec)
                         / ISSUE_INSNS_PER_S, launches_per_call=launches)
    log("phase probe body shares: " + json.dumps(out))
    # A fill faster than its spec's body: logged, the run goes on.
    log("body_over_fill: " + json.dumps(
        {k: v["body_share"] for k, v in out.items() if v["body_share"] > 1}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = set(ap.parse_args().phases.split(","))
    if phases - set(PHASES):
        fail(f"unknown phases {sorted(phases - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(HERE, "gpuseqalign_tpu_torch")):
        fail("gpuseqalign_tpu_torch not found beside chip_smoke.py")
    sys.path.insert(0, HERE)

    from gpuseqalign_tpu_torch.bench.cli import main as cli_main
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import (
        banded_cuda,
        batch_cuda,
        build,
        dense_cuda,
        mlsp_cuda,
        probe_cuda,
        strip_cuda,
    )
    from gpuseqalign_tpu_torch.ops.dense_plain import rowscan_dense
    from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    times = {}

    # 1. build (every phase needs the kernels; always run)
    t0 = time.perf_counter()
    build_s = build.build_all()
    times["build"] = time.perf_counter() - t0
    log(f"phase build: {build.sources()} in {build_s:.2f} s")

    subst_np = parse_subst_file(
        os.path.join(RESRC, "subst.json")).subst_map["blosum62"]
    subst = torch.from_numpy(subst_np).cuda()
    S = subst.shape[0]
    seq = release_seq()

    # 2. kernels against their plain versions, on the card
    banded = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        n1 = check_single_kernel(torch, subst, subst_np)
        nb = check_batch_kernels(torch, subst)
        nd = check_dense_kernel(torch, subst, subst_np)
        nk7 = check_banded_kernel(torch, subst, subst_np)
        t1 = time.perf_counter()
        nwf = check_wavefront_kernels(torch, subst, seq)
        times["kernels_wavefront"] = time.perf_counter() - t1
        times["kernels"] = time.perf_counter() - t0
        log(f"phase kernels: {n1} mlsp_fill cases, {nb} batch cases, "
            f"{nd} dense_fill cases, {nk7} banded_pass cases and {nwf} "
            f"cases of mlsp_nw_lg_fill and dense_nw_lg_fill (each) "
            f"bit-exact in {times['kernels']:.1f} s (the last "
            f"{times['kernels_wavefront']:.1f} s)")
        t0 = time.perf_counter()
        banded = time_banded(torch, subst, subst_np, FULL_N, S)
        times["kernels_banded_timing"] = time.perf_counter() - t0

    # 3. the single-pair path through the CLI, every spec
    params = {
        "cpu1_st_row": {},
        "tpu7_pallas_mlsp": {"tileBy": [128], "tileBx": [512]},
        "NwAlign_Gpu8_Mlsp_DiagDiag": {"tileBx": [76]},
    }
    cli_launches = {}
    if "cli" in phases:
        t0 = time.perf_counter()
        pairs = cli_pairs()
        runs = [(spec, dict(params, **DENSE_PARAMS), f"cli_{spec}")
                for spec in SPECS]
        runs.append(("nw_lg", os.path.join(RESRC, "param_best.json"),
                     "cli_param_best_nw_lg"))
        for spec, run_params, name in runs:
            mlsp_cuda.LAUNCHES = dense_cuda.LAUNCHES = 0
            t1 = time.perf_counter()
            rows = run_cli(cli_main, spec, run_params, pairs, name)
            cli_launches[name] = {"mlsp_fill": mlsp_cuda.LAUNCHES,
                                  "dense_fill": dense_cuda.LAUNCHES}
            if min(cli_launches[name].values()) <= 0:
                fail(f"cli {name}: a kernel was never launched: "
                     f"{cli_launches[name]}")
            calc = {}
            for r in rows:
                calc[r["alg_name"]] = (calc.get(r["alg_name"], 0.0)
                                       + float(r["align.calc"]))
            log(f"phase cli {name}: {len(rows)} rows of {len(calc)} "
                f"algorithms err_step 0 in {time.perf_counter() - t1:.1f} "
                f"s, kernel launches {cli_launches[name]}; align.calc ms "
                f"summed over the pairs: "
                + ", ".join(f"{a} {v:.1f}" for a, v in calc.items()))
        times["cli"] = time.perf_counter() - t0

    # 4. full size: the release pair through the CLI (nw_lg) ...
    per_spec, dense_spec, wave = {}, {}, {}
    max_err = 0
    main_launches = dense_launches = release_k7 = 0
    if "full" in phases:
        t0 = time.perf_counter()
        with open(RELEASE_PAIRS) as f:
            release = [line.strip() for line in f if line.strip()]
        mlsp_cuda.LAUNCHES = dense_cuda.LAUNCHES = banded_cuda.LAUNCHES = 0
        rows = run_cli(cli_main, "nw_lg",
                       {k: params[k] for k in ("cpu1_st_row",
                                               "tpu7_pallas_mlsp")}
                       | {"tpu3_pallas_dense": {}, "tpu9_giant_mlsp": {}},
                       release, "release_nw_lg")
        main_launches = mlsp_cuda.LAUNCHES
        dense_launches = dense_cuda.LAUNCHES
        release_k7 = banded_cuda.LAUNCHES
        if min(main_launches, dense_launches, release_k7) <= 0:
            fail(f"release nw_lg: a kernel was never launched (mlsp_fill "
                 f"{main_launches}, dense_fill {dense_launches}, "
                 f"banded_pass {release_k7})")
        ref_row = next(r for r in rows if r["alg_name"] == "cpu1_st_row")
        for alg, n_launch in (("tpu7_pallas_mlsp", main_launches),
                              ("tpu3_pallas_dense", dense_launches),
                              ("tpu9_giant_mlsp", release_k7)):
            row = next(r for r in rows if r["alg_name"] == alg)
            log(f"phase full-size cli nw_lg {release[0]} {alg}: cost "
                f"{row['align_cost']} (cpu1_st_row {ref_row['align_cost']}"
                f"), laps ms: " + ", ".join(
                    f"{lap} {row[lap]}" for lap in (
                        "align.alloc", "align.cpy_dev", "align.calc",
                        "align.cpy_host", "hash.calc", "trace.calc"))
                + f"; {n_launch} kernel launches")
        times["full_cli"] = time.perf_counter() - t0

        # ... and K1 against its plain version at that size, timed: the
        # pair entry (mlsp_fill, PAIR_WARPS warps a block) and, in turns
        # with it, the batch entry's route (mlsp_fill_batch with headers,
        # one pair, 4 warps a block).
        t0 = time.perf_counter()
        n, th, tw = FULL_N, 128, 512
        for i, spec in enumerate(SPECS):
            y, x = padded_inputs(torch, subst_np, n, n, th, tw, 100 + i)
            kw = fill_args(spec, n, n, th, tw)
            one = torch.tensor([n + 1], dtype=torch.int32, device="cuda")

            def pair():
                return mlsp_cuda.mlsp_fill(subst, y, x, **kw)

            def batch():
                return batch_cuda.mlsp_fill_batch(
                    subst, y.view(1, -1), x.view(1, -1), GAPO, GAPE[spec],
                    one, one, tile_h=th, tile_w=tw, headers=True,
                    **kind_gap(spec))

            pair(), batch()  # warm-up
            ab = {"pair": [], "batch": []}
            for name in ("pair", "batch", "batch", "pair"):
                ab[name].append(cuda_ms(torch, pair if name == "pair"
                                        else batch, 3))
            before = mlsp_cuda.LAUNCHES
            got = pair()
            launches = mlsp_cuda.LAUNCHES - before
            warp_got = batch()
            want = {}
            plain_ms = cuda_ms(
                torch, lambda: want.update(mlsp_fill_plain(subst, y, x, **kw)),
                1)
            err = max_abs_diff(torch, got, want)
            err_w = max_abs_diff(torch, {k: warp_got[k][0] for k in got},
                                 want)
            if err or err_w:
                fail(f"kernel != plain at {n}x{n} {spec}: max |diff| {err} "
                     f"(pair entry), {err_w} (batch entry)")
            max_err = max(max_err, err)
            ms = sum(ab["pair"]) / 2
            rows_p, cols_p = y.numel() - 1, x.numel() - 1
            b_ms, b_by = bound_ms(spec, rows_p, cols_p, th, tw, S)
            per_spec[spec] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                gcups=n * n / (ms * 1e-3) / 1e9, launches_per_fill=launches,
                pair_ms=ab["pair"], batch_ms=ab["batch"],
            )
            log(f"phase full-size {spec} {n}x{n} tile {th}x{tw}: kernel "
                f"{ms:.3f} ms ({per_spec[spec]['gcups']:.3f} GCUPS, "
                f"{launches} launches), plain {plain_ms:.1f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), bit-exact; A/B ms (pair entry "
                f"{strip_cuda.PAIR_WARPS} warp(s) a block, batch entry 4, "
                f"batch, pair): {ab['pair'][0]:.3f}, {ab['batch'][0]:.3f}, "
                f"{ab['batch'][1]:.3f}, {ab['pair'][1]:.3f}")
            del got, warp_got, want
        times["full_kernels"] = time.perf_counter() - t0

        # ... and the single-pair flow's header hand-off, every spec.
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q",
             "-p", "no:cacheprovider",
             os.path.join(HERE, "tests", "test_torch_mlsp_card.py")],
            cwd=HERE, capture_output=True, text=True, timeout=1800)
        last = (out.stdout.strip().splitlines() or [""])[-1]
        if out.returncode != 0:
            fail(f"test_torch_mlsp_card.py: exit {out.returncode}: "
                 f"{out.stdout[-3000:]}{out.stderr[-2000:]}")
        times["full_headers"] = time.perf_counter() - t0
        log(f"phase full-size header hand-off: {last}")

        # ... and K3 against its plain version, every spec.
        t0 = time.perf_counter()
        adj = n + 1
        for i, spec in enumerate(SPECS):
            y, x = padded_inputs(torch, subst_np, n, n, 128, 128, 200 + i)
            kw = dict(kind_gap(spec), adjr=adj, adjc=adj)

            def fill():
                return dense_cuda.dense_fill(subst, y, x, GAPO, GAPE[spec],
                                             **kw)

            fill()  # warm-up
            ms = cuda_ms(torch, fill, 3)
            before = dense_cuda.LAUNCHES
            got = fill()
            launches = dense_cuda.LAUNCHES - before
            plain = []
            plain_ms = cuda_ms(torch, lambda: plain.append(rowscan_dense(
                subst, y[:adj], x[:adj], GAPO, GAPE[spec],
                **kind_gap(spec))), 1)
            err = rows_max_abs_diff(torch, got, plain[0])
            if err:
                fail(f"dense_fill != rowscan_dense at {n}x{n} {spec}: "
                     f"max |diff| {err}")
            b_ms, b_by = dense_bound_ms(spec, adj, adj, S)
            dense_spec[spec] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err,
                gcups=n * n / (ms * 1e-3) / 1e9,
                launches_per_fill=launches,
            )
            log(f"phase full-size dense_fill {spec} {n}x{n} strips of "
                f"{32 * dense_cuda.LANE_ROWS} rows, {dense_cuda.WARPS} "
                f"warp(s) a block: kernel "
                f"{ms:.3f} ms ({dense_spec[spec]['gcups']:.3f} GCUPS, "
                f"{launches} launches), plain {plain_ms:.1f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), bit-exact")
            del got, plain
        sweep_dense(torch, subst, subst_np, n, S)
        times["full_dense"] = time.perf_counter() - t0

        # ... and the v1 wavefront flows (K2, K4), held against cpu1_st_row.
        t0 = time.perf_counter()
        wave = full_wavefront(torch, subst, subst_np, seq, ref_row, S)
        times["full_wavefront"] = time.perf_counter() - t0

    # 5. the single-pair path went through its kernel
    wave_launches = {k: v["launches"] for k, v in wave.items()}
    log(f"launches: cli {cli_launches}, full-size cli nw_lg mlsp_fill "
        f"{main_launches}, dense_fill {dense_launches}, v1 flows "
        f"{wave_launches}")
    if "full" in phases and set(wave_launches.values()) != {1}:
        fail(f"a v1 wavefront flow did not launch its kernel once: "
             f"{wave_launches}")

    # 6. the batch path
    runs = {}
    if "throughput" in phases:
        t0 = time.perf_counter()
        runs = phase_throughput(torch, subst, S)
        fill = time_fill_batch(torch, subst, S)
        sweep_tiny_schedule(torch, subst, S)
        trace_synth_windows(torch, subst_np, S)
        times["throughput"] = time.perf_counter() - t0

    # 7. the giant-pair engine
    giant = {}
    if "giant" in phases:
        t0 = time.perf_counter()
        giant = phase_giant(torch, cli_main, subst, subst_np, S)
        times["giant"] = time.perf_counter() - t0
        log(f"phase giant steps s: cli {giant['cli_s']:.1f}, 100000^2 D 1 "
            f"{giant['full_s']:.1f}, D 2/4 {giant['bands_s']:.1f}, streams "
            f"{giant['streams_s']:.1f}, batch mesh and multihost "
            f"{giant['mesh_s']:.1f}, release pair over two processes "
            f"{giant['procs_s']:.1f}")

    # 8. the step-body probes and the headline bench
    probe, probe_launches, probe_timing = {}, {}, {}
    if "probe" in phases:
        t0 = time.perf_counter()
        n_cases = check_probe_kernels(torch)
        n_strips = check_probe_strips(torch)
        log(f"phase probe: {n_cases} cases bit-exact against the plain "
            f"versions, {n_strips} strips equal to the oracle in "
            f"{time.perf_counter() - t0:.1f} s")
        probe_resources()
        probe_cuda.LAUNCHES.update(dict.fromkeys(probe_cuda.LAUNCHES, 0))
        probe = probe_main_path(torch)
        probe_launches = dict(probe_cuda.LAUNCHES)
        if min(probe_launches.values()) <= 0:
            fail(f"probe: a kernel was never launched: {probe_launches}")
        log(f"phase probe launches: {probe_launches}")
        probe_timing = time_probe_kernels(torch, probe)
        times["probe"] = time.perf_counter() - t0

    # 9. the user's tools: the fuzz, the tuners and the giant-pair demo
    if "tools" in phases:
        t0 = time.perf_counter()
        tools_fuzz(torch)
        times["tools_fuzz"] = time.perf_counter() - t0
        tools_tune(torch, subst_np, seq)
        tools_demo(torch)
        times["tools"] = time.perf_counter() - t0

    # 10. the scaling report, every row on the card
    if "scaling" in phases:
        t0 = time.perf_counter()
        phase_scaling()
        times["scaling"] = time.perf_counter() - t0

    # 11. the database search, on the cell's traffic and on homologs
    if "dbsearch" in phases:
        t0 = time.perf_counter()
        phase_dbsearch(torch)
        times["dbsearch"] = time.perf_counter() - t0

    log("phase times s: " + json.dumps({k: round(v, 2)
                                          for k, v in times.items()}))
    if phases != set(PHASES):
        log(f"partial run ({sorted(phases)}): no result line")
        return 0
    body_shares(per_spec, dense_spec, fill, runs, banded, giant, wave, probe)
    head = per_spec["nw_ag"]
    dense_head = dense_spec["nw_ag"]
    banded_head = banded["nw_ag"]
    k5 = runs["pair_generated_1_nw_ag"]["kernels"]["mlsp_fill_batch"]
    k6 = runs["synth_16384_nw_ag"]["kernels"]["mlsp_tiny"]
    print(json.dumps({"kernels": [{
        "name": "mlsp_fill",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/strip_fill.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_wavefront2.py:1152",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
    }, {
        "name": "mlsp_fill_batch",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/strip_fill.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_wavefront2.py:1580",
        "launches": k5["launches"],
        "max_abs_err": fill["max_abs_err"],
        "ms": fill["ms"],
        "plain_ms": fill["plain_ms"],
        "bound_ms": fill["bound_ms"],
        "bound_by": fill["bound_by"],
        "library_ms": None,
    }, {
        "name": "mlsp_tiny",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/mlsp_tiny.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_tiny.py:275",
        "launches": k6["launches"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": None,
    }, {
        "name": "dense_fill",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/strip_fill.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_wavefront2.py:1421",
        "launches": dense_launches,
        "max_abs_err": max(v["max_abs_err"] for v in dense_spec.values()),
        "ms": dense_head["ms"],
        "plain_ms": dense_head["plain_ms"],
        "bound_ms": dense_head["bound_ms"],
        "bound_by": dense_head["bound_by"],
        "library_ms": None,
    }, {
        "name": "banded_pass",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/strip_fill.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_banded.py:61",
        "launches": giant["launches"],
        "max_abs_err": max(v["max_abs_err"] for v in (
            *banded.values(), *giant["full"]["specs"].values())),
        "ms": banded_head["ms"],
        "plain_ms": banded_head["plain_ms"],
        "bound_ms": banded_head["bound_ms"],
        "bound_by": banded_head["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/probe.cu",
        "replaces": f"gpuseqalign_tpu/bench/vpu_probe.py:{line}",
        "launches": probe_launches[name],
        "max_abs_err": probe_timing[name]["max_abs_err"],
        "ms": probe_timing[name]["ms"],
        "plain_ms": probe_timing[name]["plain_ms"],
        "bound_ms": probe_timing[name]["bound_ms"],
        "bound_by": probe_timing[name]["bound_by"],
        "library_ms": None,
    } for name, line in (("probe_chain", 57), ("probe_fullstep", 176),
                         ("probe_fullstep_affine", 538),
                         ("probe_int16", 996))] + [{
        "name": name,
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/wavefront.cu",
        "replaces": f"gpuseqalign_tpu/ops/pallas_wavefront.py:{line}",
        "launches": wave[name]["launches"],
        "max_abs_err": wave[name]["max_abs_err"],
        "ms": wave[name]["ms"],
        "plain_ms": wave[name]["plain_ms"],
        "bound_ms": wave[name]["bound_ms"],
        "bound_by": wave[name]["bound_by"],
        "library_ms": None,
    } for name, line in (("wavefront_mlsp", 258),
                         ("wavefront_dense", 203))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
