"""The readings a cell's correctness limit is set from, on the chip.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... [--seconds 2] [--bits 16]

For each seed, in one process: the cell's set-up (``harness.prepare``)
and a short window at the cell's own load (``harness.measure``), then
the number the run compares (``wrong``: answers that differ from the
plain reference) for the program, and for the control, the reference
computed in ``--bits`` (saturating; 16 or 8) put in the program's place
for every call of the same window. One JSON line a seed. The
benchmark's own runs do not run this; its CPU form is
``tests/test_bench_control.py``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, seconds: float, bits: list,
             device: str = "cuda", root: str = ROOT) -> dict:
    """The program's and each control's ``wrong`` on one seed."""
    import torch

    from benchmark import harness

    cell = harness.Cell(name, root)
    subst, pool, entry = harness.prepare(cell, seed, device)
    calls, window_s, _, _ = harness.measure(entry, len(pool), seconds)
    del entry
    if device == "cuda":
        torch.cuda.empty_cache()
    algorithm = cell.config["algorithm"]
    ref = harness.reference_answers(cell, pool, subst, device)
    out = {"workload": name, "seed": seed, "calls": len(calls),
           "window_s": window_s,
           "program_wrong": harness.wrong_answers(calls, ref, algorithm)}
    for b in bits:
        ctl = harness.reference_answers(cell, pool, subst, device, bits=b)
        as_calls = [harness.Call(c.item, c.seconds, ctl[c.item], {})
                    for c in calls]
        out[f"control{b}_wrong"] = harness.wrong_answers(as_calls, ref,
                                                         algorithm)
        out[f"control{b}_pairs_wrong"] = harness.wrong_answers(
            [harness.Call(k, 0.0, a, {}) for k, a in enumerate(ctl)], ref,
            algorithm)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--bits", default="16",
                    help="comma-separated control widths (16, 8; "
                         "empty: the program alone)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    bits = [int(b) for b in args.bits.split(",") if b]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, args.seconds, bits)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
