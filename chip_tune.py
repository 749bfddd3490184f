#!/usr/bin/env python3
"""Tune the card's tile cache, and keep only what holds end to end.

    python3 chip_tune.py [OUT_DIR] [--specs nw_lg,nw_ag,sw_lg,sw_ag]
                         [--bandedRows 100000]

Run from the root of a checkout on a machine with one card. For every
spec it runs ``python -m gpuseqalign_tpu_torch.bench.autotune
--save-defaults`` with ``--pair len23728 len23728`` (the release pair)
and ``--bandedRows``: K1's tile sweep (``tune_v2``) and the giant engine's
(``tune_banded``, K7 at D = 1 on a random pair of that many residues),
every tile gated on the oracle. Then, in turns (literal, tuned, tuned,
literal):

- K1 (``mlsp_fill``) at the winner and at the literal 128 x 512 on the
  release pair, and K7 (``giant2_fill`` at D = 1) at the banded winner and
  at the literal 128 x 128 on the --bandedRows pair: CUDA events, 4 fills
  a turn after a warm-up;
- the release pair through the CLI, ``tpu7_pallas_mlsp`` at the tile and
  ``tpu9_giant_mlsp`` at the banded tile, score hash and traceback on: the
  laps align.alloc, align.cpy_dev, align.calc, align.cpy_host, hash.calc
  and trace.calc of each row.

An entry is kept only where its CLI row's laps, summed and averaged over
its two turns, are no more than the literal tile's: the top-level tile by
the tpu7 row, the banded sub-entry by the tpu9 row. The cache of the kept
entries is written to OUT_DIR/<card>.json (default logs/chip_tune) with
every reading in OUT_DIR/chip_tune.json; copy the cache into resrc/tuned/
to commit it. The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SPECS = ("nw_lg", "nw_ag", "sw_lg", "sw_ag")
LITERAL = {"tile": (128, 512), "banded": (128, 128)}
LAPS = ("align.alloc", "align.cpy_dev", "align.calc", "align.cpy_host",
        "hash.calc", "trace.calc")
TURNS = ("literal", "tuned", "tuned", "literal")
M_FILLS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?",
                    default=os.path.join(HERE, "logs", "chip_tune"))
    ap.add_argument("--specs", default=",".join(SPECS))
    ap.add_argument("--bandedRows", type=int, default=100000)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gpuseqalign_tpu_torch.bench import autotune
    from gpuseqalign_tpu_torch.bench.cli import main as cli_main
    from gpuseqalign_tpu_torch.core.types import AlgParams
    from gpuseqalign_tpu_torch.io.subst import parse_subst_file
    from gpuseqalign_tpu_torch.ops import build, tuned
    from gpuseqalign_tpu_torch.ops.mlsp_cuda import mlsp_fill
    from gpuseqalign_tpu_torch.parallel import fill_plan, giant2_fill
    from gpuseqalign_tpu_torch.parallel.mesh import default_mesh

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    dev = torch.device("cuda")
    name = tuned.cache_name(dev)
    subst_np = parse_subst_file(
        os.path.join(cs.RESRC, "subst.json")).subst_map["blosum62"]
    subst = torch.from_numpy(subst_np).to(dev)
    seq = cs.release_seq()
    n = len(seq) - 1
    big = autotune.random_seq(args.bandedRows, subst_np.shape[0])
    nb = args.bandedRows
    with open(cs.RELEASE_PAIRS) as f:
        release = [line.strip() for line in f if line.strip()]
    os.makedirs(args.out, exist_ok=True)
    out_cache = os.path.join(args.out, f"{name}.json")
    if os.path.exists(out_cache):
        os.remove(out_cache)
    report = {"card": card, "cache": f"{name}.json", "specs": {}}

    def k1(spec, tile):
        y = autotune._padded(seq, tile[0], dev)
        x = autotune._padded(seq, tile[1], dev)
        return autotune._fill_ms(lambda: mlsp_fill(
            subst, y, x, cs.GAPO, cs.GAPE[spec], n + 1, n + 1,
            tile_h=tile[0], tile_w=tile[1], **cs.kind_gap(spec)), dev,
            M_FILLS)

    def k7(spec, tile):
        plan = fill_plan(
            AlgParams({"tileBy": [tile[0]], "tileBx": [tile[1]]}), [nb],
            [nb], 1)
        y, x = (t.to(dev) for t in plan.pad(big, big))
        return autotune._fill_ms(lambda: giant2_fill(
            subst, [y], [x], cs.GAPO, cs.GAPE[spec], [nb + 1], [nb + 1],
            mesh=default_mesh(dev), plan=plan, **cs.kind_gap(spec)), dev,
            M_FILLS)

    def cli_laps(spec, tile, band, turn):
        params = {"tpu7_pallas_mlsp": {"tileBy": [tile[0]],
                                       "tileBx": [tile[1]]},
                  "tpu9_giant_mlsp": {"tileBy": [band[0]],
                                      "tileBx": [band[1]]}}
        rows = cs.run_cli(cli_main, spec, params, release,
                          f"tune_{spec}_{turn}")
        return {r["alg_name"]: {lap: float(r[lap]) for lap in LAPS}
                for r in rows}

    for spec in args.specs.split(","):
        t0 = time.perf_counter()
        argv = ["--save-defaults", "--seqPath", cs.SEQS,
                "--substPath", os.path.join(cs.RESRC, "subst.json"),
                "--pair", cs.RELEASE_SEQ, cs.RELEASE_SEQ, "--algKind", spec,
                "--gapoCost", str(cs.GAPO), "--gapeCost", str(cs.GAPE[spec]),
                "--bandedRows", str(nb)]
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = autotune.main(argv, device=dev)
        for line in se.getvalue().splitlines():
            print(f"{spec} autotune:{line}", flush=True)
        if rc != 0:
            cs.fail(f"autotune {spec}: exit {rc}")
        entry = json.loads(so.getvalue().strip().splitlines()[-1])[spec]
        band = entry.pop("banded")
        tiles = {"literal": LITERAL["tile"],
                 "tuned": (entry["tileBy"], entry["tileBx"])}
        bands = {"literal": LITERAL["banded"],
                 "tuned": (band["tileBy"], band["tileBx"])}
        r = {"entry": entry, "banded": band, "k1_ms": {}, "k7_ms": {},
             "cli": {}}
        for turn in TURNS:
            r["k1_ms"].setdefault(turn, []).append(k1(spec, tiles[turn]))
            r["k7_ms"].setdefault(turn, []).append(k7(spec, bands[turn]))
        for turn in TURNS:
            r["cli"].setdefault(turn, []).append(
                cli_laps(spec, tiles[turn], bands[turn], turn))

        def total(turn, alg):
            runs = r["cli"][turn]
            return sum(sum(x[alg].values()) for x in runs) / len(runs)

        r["cli_total_ms"] = {
            alg: {turn: total(turn, alg) for turn in ("literal", "tuned")}
            for alg in ("tpu7_pallas_mlsp", "tpu9_giant_mlsp")}
        keep_tile = (r["cli_total_ms"]["tpu7_pallas_mlsp"]["tuned"]
                     <= r["cli_total_ms"]["tpu7_pallas_mlsp"]["literal"])
        keep_band = (r["cli_total_ms"]["tpu9_giant_mlsp"]["tuned"]
                     <= r["cli_total_ms"]["tpu9_giant_mlsp"]["literal"])
        r["kept"] = {"tile": keep_tile, "banded": keep_band}
        if keep_tile:
            autotune.save_defaults(entry, spec, root=args.out)
        if keep_band:
            autotune.save_defaults({"banded": band}, spec, root=args.out)
        r["s"] = time.perf_counter() - t0
        report["specs"][spec] = r
        print(f"{spec}: " + json.dumps(r), flush=True)
        with open(os.path.join(args.out, "chip_tune.json"), "w") as f:
            json.dump(report, f, indent=1)
    written = os.path.join(HERE, "resrc", "tuned", f"{name}.json")
    if os.path.exists(written):
        shutil.copy(written, os.path.join(args.out, f"{name}.all.json"))
    print(json.dumps({"cache": report["cache"], "kept": {
        s: v["kept"] for s, v in report["specs"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
