#!/usr/bin/env python3
"""Time the fills of one tree of this repository on one card, for
comparing two trees in one call.

    python3 chip_ab.py ROOT LABEL [KERNELS]

ROOT is the root of a checkout (this one, or another unpacked beside it,
e.g. ``git archive <commit>`` into a directory that .gitignore lists);
its kernels are built from its own sources and its own ``chip_smoke.py``
gives the inputs. Prints one JSON line: LABEL and the CUDA-event ms (mean
of 3 after a warm-up, no plain version, no check) of K1 (``mlsp_fill``,
128 x 512) and K3 (``dense_fill``) at 23728^2, K7 (``banded_pass``, the
whole band of a 23728^2 pair at D = 1) for every spec, K5
(``mlsp_fill_batch``, the engine's cost-only call summed over the
pair_generated_1 nw_ag buckets), and the v1 fills K2
(``mlsp_nw_lg_fill``, R 128, TW 512) and K4 (``dense_nw_lg_fill``, R
1024) at 23728^2, nw_lg, at the tree's default schedule, and K6
(``tiny_scores`` at the tree's default schedule) on the synth_16384
512 x 512 bucket for every spec, beside ``small_pg1_nw_ag``: the engine's
call (``bucket_scores``, whichever kernel it picks) summed over the
pair_generated_1 nw_ag buckets shorter than TILE_FILL_MIN_ROWS. K8 is
the step-body yardstick: for every spec, the tree's own
``bench.vpu_probe.roofline_body`` (its probe kernel K8b or K8c, swept
over the tree's own grid choices), whose winner's GCUPS, strips a block,
rows a strip and blocks a SM it prints. KERNELS, a comma-separated
subset of K1,K2,K3,K4,K5,K6,K7,K8, times those alone (K8 only when
named: its sweep takes seconds). Run the trees in turns (A, B, B, A):
two calls may land on two cards.
"""

import json
import math
import os
import sys


def main() -> int:
    if len(sys.argv) not in (3, 4):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    keys = set(sys.argv[3].split(",") if len(sys.argv) == 4 else
               ("K1", "K2", "K3", "K4", "K5", "K6", "K7"))
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gpuseqalign_tpu_torch.bench import throughput
    from gpuseqalign_tpu_torch.core.types import AlgParams, AlignSpec
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import batch_cuda, build, dense_cuda
    from gpuseqalign_tpu_torch.ops import mlsp_cuda, wavefront_cuda
    from gpuseqalign_tpu_torch.ops.banded_cuda import banded_pass
    from gpuseqalign_tpu_torch.parallel.batch import (
        TILE_FILL_MIN_ROWS,
        bucket_pairs,
        bucket_scores,
        stack_bucket,
    )
    from gpuseqalign_tpu_torch.parallel.giant2 import band_geometry

    build.build_all()
    subst_data = parse_subst_file(os.path.join(cs.RESRC, "subst.json"))
    subst_np = subst_data.subst_map["blosum62"]
    subst = torch.from_numpy(subst_np).cuda()
    res = {"tree": sys.argv[2]}

    dev = torch.device("cuda")
    if "K8" in keys:
        from gpuseqalign_tpu_torch.bench import vpu_probe

        for kind, gap in (("nw", "linear"), ("sw", "linear"),
                          ("nw", "affine"), ("sw", "affine")):
            r = vpu_probe.roofline_body(kind, gap, device=dev)
            spec = vpu_probe.spec_name(kind, gap)
            res[f"K8_{spec}"] = r["gcups"]
            res[f"K8_{spec}_grid"] = dict(
                K=r["K"], rows=r.get("rows", r["threads"]),
                blocks_per_sm=r.get("blocks_per_sm"), blocks=r["blocks"])
    pairs = throughput.file_pairs(cs.SEQS, cs.THROUGHPUT_RUNS[0][1][1],
                                  subst_data.letter_map)
    if "K6" in keys:
        synth = throughput.synth_pairs(16384, 300, 500, subst.shape[0])
        ys, xs, adjrs, adjcs = stack_bucket(
            synth, bucket_pairs(synth, "pow2")[(512, 512)], 512, 512, dev)
        for spec in cs.SPECS:
            args = (subst, ys, xs, cs.GAPO, cs.GAPE[spec], adjrs, adjcs)
            kg = cs.kind_gap(spec)
            batch_cuda.tiny_scores(*args, **kg)  # warm-up
            res[f"K6_{spec}"] = cs.cuda_ms(
                torch, lambda: batch_cuda.tiny_scores(*args, **kg), 3)
        res["small_pg1_nw_ag"] = 0.0
        aspec = AlignSpec.from_name("nw_ag")
        for (rows_p, cols_p), idxs in bucket_pairs(pairs, "pow2").items():
            if rows_p >= TILE_FILL_MIN_ROWS:
                continue
            stacked = stack_bucket(pairs, idxs, rows_p, cols_p, dev)
            args = (aspec, subst, *stacked, cs.GAPO, cs.GAPE["nw_ag"])
            bucket_scores(*args)  # warm-up
            res["small_pg1_nw_ag"] += cs.cuda_ms(
                torch, lambda: bucket_scores(*args), 3)
    if "K5" in keys:
        res["K5_nw_ag"] = 0.0
        for (rows_p, cols_p), idxs in bucket_pairs(pairs, "pow2").items():
            if rows_p < TILE_FILL_MIN_ROWS:
                continue
            ys, xs, adjrs, adjcs = stack_bucket(pairs, idxs, rows_p, cols_p,
                                                dev)
            kw = dict(tile_h=math.gcd(rows_p, 128),
                      tile_w=math.gcd(cols_p, 512), **cs.kind_gap("nw_ag"))
            args = (subst, ys, xs, cs.GAPO, cs.GAPE["nw_ag"], adjrs, adjcs)
            batch_cuda.mlsp_fill_batch(*args, **kw)  # warm-up
            res["K5_nw_ag"] += cs.cuda_ms(
                torch, lambda: batch_cuda.mlsp_fill_batch(*args, **kw), 3)

    n = cs.FULL_N
    R, TW, bc, BL = band_geometry(AlgParams({}), [n], [n], 1)
    rows_p = -(-n // (BL * R)) * BL * R
    for spec in cs.SPECS:
        if "K7" in keys:
            y, x = cs.padded_inputs(torch, subst_np, n, n, rows_p, bc, 500)
            args = (subst, y, x, spec, n, n, R, TW, bc, 1, rows_p // R)
            cs.band_chain(torch, banded_pass, *args)
            res[f"K7_{spec}"] = cs.cuda_ms(
                torch, lambda: cs.band_chain(torch, banded_pass, *args), 3)
        y, x = cs.padded_inputs(torch, subst_np, n, n, 128, 512, 100)
        if "K1" in keys:
            kw = cs.fill_args(spec, n, n, 128, 512)
            mlsp_cuda.mlsp_fill(subst, y, x, **kw)
            res[f"K1_{spec}"] = cs.cuda_ms(
                torch, lambda: mlsp_cuda.mlsp_fill(subst, y, x, **kw), 3)
        if "K3" in keys:
            kd = dict(cs.kind_gap(spec), adjr=n + 1, adjc=n + 1)
            dense_cuda.dense_fill(subst, y, x, cs.GAPO, cs.GAPE[spec], **kd)
            res[f"K3_{spec}"] = cs.cuda_ms(
                torch, lambda: dense_cuda.dense_fill(
                    subst, y, x, cs.GAPO, cs.GAPE[spec], **kd), 3)

    seq = cs.release_seq()
    for key, R, TW, W in (("K2", 128, 512, 512), ("K4", 1024, None, 256)):
        if key not in keys:
            continue
        pskew, cols_p = cs.wavefront_pskew(torch, subst, seq, seq, R,
                                           TW or 128, W)
        if TW:
            def fill():
                wavefront_cuda.mlsp_nw_lg_fill(pskew, cs.GAPO, cols_p=cols_p,
                                               W=W, TW=TW)
        else:
            def fill():
                wavefront_cuda.dense_nw_lg_fill(pskew, cs.GAPO, cols_p=cols_p,
                                                W=W)
        fill()  # warm-up
        res[f"{key}_nw_lg"] = cs.cuda_ms(torch, fill, 3)
        del pskew
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
