#!/usr/bin/env python3
"""Smoke run of gpuseqalign_tpu_torch (the PyTorch/CUDA port) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (CUDA
toolkit with nvcc; the kernels are built from the checkout's sources).
Phases, each of which makes the script exit non-zero if it fails:

  1. build      every kernel under gpuseqalign_tpu_torch/ops/csrc, one
                nvcc per source, started together
  2. kernels    each kernel against its plain PyTorch version on the card,
                all four specs, several shapes: bit-exact (int32, no
                tolerance)
  3. cli        the main path: bench.cli.main on the card for nw_lg, nw_ag,
                sw_lg, sw_ag with cpu1_st_row as the reference, score hash
                and traceback; err_step must be 0 in every TSV row
  4. full size  resrc/pair_release.txt (23728 x 23728) through the CLI for
                nw_lg, then the kernel against its plain version at that
                size for every spec, timed with CUDA events
  5. launches   the main path's runs went through the kernel

The line before the last is a JSON object describing every kernel; the
last line is the contract line {"ok": true, "device": {...}}. Outputs (TSV
files) go to logs/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RESRC = os.path.join(HERE, "resrc")
OUT = os.path.join(HERE, "logs", "chip_smoke")
SPECS = ("nw_lg", "nw_ag", "sw_lg", "sw_ag")
GAPO = -11
GAPE = {"nw_lg": 0, "sw_lg": 0, "nw_ag": -2, "sw_ag": -2}

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3; INT32 issue rate =
# 132 SMs x 64 INT32 lanes x 1.98 GHz (a quarter of the 67 TFLOP/s FP32
# figure, which counts 2 flops per FMA on 128 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per DP cell of the recurrence: linear gap = add diag,
# max up/left, add gap, max; affine = F (max, 2 adds) + E (max, 2 adds) +
# H (add, 2 max); SW adds the zero clamp and the best-cell compare.
OPS_PER_CELL = {"nw_lg": 4, "sw_lg": 6, "nw_ag": 9, "sw_ag": 11}
# The reference's release pair (len23728 x len23728), bench.py's size.
RELEASE_PAIRS = os.path.join(RESRC, "pair_release.txt")
FULL_N = 23728


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


def fill_args(spec, rows, cols, th, tw):
    kind, gap = spec.split("_")
    return dict(gapo=GAPO, gape=GAPE[spec], adjr=rows + 1, adjc=cols + 1,
                tile_h=th, tile_w=tw, kind=kind,
                gap="affine" if gap == "ag" else "linear")


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


def bound_ms(spec, rows_p, cols_p, th, tw, S) -> tuple:
    """Least time for the fill: (ms, "operations"|"bytes"). Bytes: each
    input read once, each output written once; operations: the int32
    operations of the recurrence over every cell the fill computes."""
    trows, tcols = rows_p // th, cols_p // tw
    affine = spec.endswith("ag")
    out_words = trows * (1 + cols_p) + trows * th * tcols
    out_words *= 2 if affine else 1
    out_words += 3 * trows * tcols if spec.startswith("sw") else 0
    nbytes = 4 * (S * S + rows_p + cols_p + 2 + out_words)
    ops = OPS_PER_CELL[spec] * rows_p * cols_p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "operations" if t_ops >= t_bytes else "bytes")


def run_cli(main, spec, params, pair_lines, name):
    os.makedirs(OUT, exist_ok=True)
    param_path = os.path.join(OUT, f"{name}_params.json")
    pair_path = os.path.join(OUT, f"{name}_pairs.txt")
    tsv = os.path.join(OUT, f"{name}.tsv")
    with open(param_path, "w") as f:
        json.dump(params, f)
    with open(pair_path, "w") as f:
        f.write("\n".join(pair_lines) + "\n")
    argv = [
        "--substPath", os.path.join(RESRC, "subst.json"),
        "--algParamPath", param_path,
        "--seqPath", os.path.join(RESRC, "seq_generated.fa"),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(HERE, "gpuseqalign_tpu_torch")):
        fail("gpuseqalign_tpu_torch not found beside chip_smoke.py")
    sys.path.insert(0, HERE)

    from gpuseqalign_tpu_torch.bench.cli import main as cli_main
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import build, mlsp_cuda
    from gpuseqalign_tpu_torch.ops.mlsp_plain import mlsp_fill_plain

    kind = torch.cuda.get_device_name(0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    times = {}

    # 1. build
    t0 = time.perf_counter()
    build_s = build.build_all()
    times["build"] = time.perf_counter() - t0
    log(f"phase build: {build.sources()} in {build_s:.2f} s")

    subst_np = parse_subst_file(
        os.path.join(RESRC, "subst.json")).subst_map["blosum62"]
    subst = torch.from_numpy(subst_np).cuda()
    S = subst.shape[0]

    # 2. kernel against its plain version, on the card
    t0 = time.perf_counter()
    max_err = 0
    shapes = [  # rows, cols, tile_h, tile_w
        (2000, 3000, 128, 512),
        (777, 2049, 64, 76),
        (300, 700, 288, 40),  # taller than wide, two row groups
        (64, 13000, 32, 13000),  # top row in global scratch, not smem
        (1, 1, 128, 512),
        (50, 1, 128, 512),    # adjc == 2
    ]
    for spec in SPECS:
        for i, (rows, cols, th, tw) in enumerate(shapes):
            y, x = padded_inputs(torch, subst_np, rows, cols, th, tw, i)
            kw = fill_args(spec, rows, cols, th, tw)
            got = mlsp_cuda.mlsp_fill(subst, y, x, **kw)
            want = mlsp_fill_plain(subst, y, x, **kw)
            torch.cuda.synchronize()
            err = max_abs_diff(torch, got, want)
            if err:
                fail(f"kernel != plain: {spec} {rows}x{cols} tile "
                     f"{th}x{tw}, max |diff| {err}")
    times["kernels"] = time.perf_counter() - t0
    log(f"phase kernels: {len(SPECS) * len(shapes)} cases bit-exact in "
        f"{times['kernels']:.1f} s")

    # 3. the main path through the CLI, every spec
    t0 = time.perf_counter()
    with open(os.path.join(RESRC, "pair_debug.txt")) as f:
        debug = [line.strip() for line in f if line.strip()]
    pairs = ["len1 len1", "len31 len33", "len196 len256",
             "len512[2:] len728[:726]"]
    pairs += [p for p in debug if p.split()[0] in ("len1", "len2")
              or "[" in p]
    params = {
        "cpu1_st_row": {},
        "tpu7_pallas_mlsp": {"tileBy": [128], "tileBx": [512]},
        "NwAlign_Gpu8_Mlsp_DiagDiag": {"tileBx": [76]},
    }
    cli_launches = {}
    for spec in SPECS:
        mlsp_cuda.LAUNCHES = 0
        rows = run_cli(cli_main, spec, params, pairs, f"cli_{spec}")
        cli_launches[spec] = mlsp_cuda.LAUNCHES
        if cli_launches[spec] <= 0:
            fail(f"cli {spec}: the kernel was never launched")
        log(f"phase cli {spec}: {len(rows)} rows err_step 0, "
            f"{cli_launches[spec]} kernel launches")
    times["cli"] = time.perf_counter() - t0

    # 4. full size: the release pair through the CLI (nw_lg) ...
    t0 = time.perf_counter()
    with open(RELEASE_PAIRS) as f:
        release = [line.strip() for line in f if line.strip()]
    mlsp_cuda.LAUNCHES = 0
    rows = run_cli(cli_main, "nw_lg",
                   {k: params[k] for k in ("cpu1_st_row", "tpu7_pallas_mlsp")},
                   release, "release_nw_lg")
    main_launches = mlsp_cuda.LAUNCHES
    if main_launches <= 0:
        fail("release nw_lg: the kernel was never launched")
    mlsp_row = next(r for r in rows if r["alg_name"] == "tpu7_pallas_mlsp")
    ref_row = next(r for r in rows if r["alg_name"] == "cpu1_st_row")
    log(f"phase full-size cli nw_lg {release[0]}: cost "
        f"{mlsp_row['align_cost']} (cpu1_st_row {ref_row['align_cost']}), "
        f"align.calc {mlsp_row['align.calc']} ms, hash.calc "
        f"{mlsp_row['hash.calc']} ms, trace.calc {mlsp_row['trace.calc']} "
        f"ms, {main_launches} kernel launches")
    times["full_cli"] = time.perf_counter() - t0

    # ... and the kernel against its plain version at that size, timed.
    t0 = time.perf_counter()
    n, th, tw = FULL_N, 128, 512
    per_spec = {}
    for i, spec in enumerate(SPECS):
        y, x = padded_inputs(torch, subst_np, n, n, th, tw, 100 + i)
        kw = fill_args(spec, n, n, th, tw)
        mlsp_cuda.mlsp_fill(subst, y, x, **kw)  # warm-up
        ms = cuda_ms(torch, lambda: mlsp_cuda.mlsp_fill(subst, y, x, **kw), 3)
        got = mlsp_cuda.mlsp_fill(subst, y, x, **kw)
        want = {}
        plain_ms = cuda_ms(
            torch, lambda: want.update(mlsp_fill_plain(subst, y, x, **kw)), 1)
        err = max_abs_diff(torch, got, want)
        if err:
            fail(f"kernel != plain at {n}x{n} {spec}: max |diff| {err}")
        max_err = max(max_err, err)
        rows_p, cols_p = y.numel() - 1, x.numel() - 1
        b_ms, b_by = bound_ms(spec, rows_p, cols_p, th, tw, S)
        per_spec[spec] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            gcups=n * n / (ms * 1e-3) / 1e9,
            launches_per_fill=rows_p // th + cols_p // tw - 1,
        )
        log(f"phase full-size {spec} {n}x{n} tile {th}x{tw}: kernel "
            f"{ms:.3f} ms ({per_spec[spec]['gcups']:.3f} GCUPS, "
            f"{per_spec[spec]['launches_per_fill']} launches), plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), bit-exact")
        del got, want
    times["full_kernels"] = time.perf_counter() - t0

    # 5. the main path went through the kernel
    log(f"launches: cli {cli_launches}, full-size cli nw_lg {main_launches}")
    log("phase times s: " + json.dumps({k: round(v, 2)
                                          for k, v in times.items()}))
    head = per_spec["nw_ag"]
    print(json.dumps({"kernels": [{
        "name": "mlsp_fill",
        "route": "cuda",
        "source": "gpuseqalign_tpu_torch/ops/csrc/mlsp_fill.cu",
        "replaces": "gpuseqalign_tpu/ops/pallas_wavefront2.py:1152",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
