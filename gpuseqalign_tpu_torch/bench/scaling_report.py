"""Scaling report: the BASELINE.json configs table of the port in one
command (the counterpart of gpuseqalign_tpu/bench/scaling_report.py).

Prints one JSON document (and writes it to ``--out`` when given) with
aligned pairs/s and aggregate GCUPS, or the giant pair's GCUPS, at:

  1card / 1cpu   one device: the batch engine (``align_pairs_batched``)
  mesh           the batch engine over a mesh: every card of the machine,
                 or two entries of the one card (or of the CPU) where it
                 has one
  2procs         two processes of a gloo group (``align_pairs_multihost``),
                 each on its own card, or both on the one card
  giant_pair     ONE pair in column bands (``align_giant2``): GCUPS per
                 band of the fill at D = 1 against D = 4, beside the call
                 model of ``parallel/giant2.py`` (``FillPlan.model_steps``)
  giant_stream   a stream of pairs at D = 4: ``align_giant2_stream``
                 against one ``align_giant2`` call a pair

Every row comes from a fresh subprocess and says what it ran on: the
platform, the devices' names and count, the mesh's entries ("4 mesh
entries on one card" where they share a card: never counted as cards) and,
on the card, its name and power limit as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives them. The rows run on the card
(a RuntimeError without one) unless ``--device cpu`` is given. Times:
the batch rows the best of 3 host-clock windows after a warm-up (the
engine returns host results, so a window covers the device); the giant
fill the mean of 3 fills after a warm-up, CUDA events on the card, the
host clock on the CPU; the stream the best of 2 windows a mode, in turns,
after a warm-up. ``--quick`` times one window or fill of each.

Sizes: ``--quick`` keeps the JAX module's (16 pairs of 100-370 residues,
a 1024 x 2048 giant pair, a stream of 3 pairs of 256 x 600); without it
the batch rows and the stream run ``resrc/pair_generated_1.txt`` (36
pairs of 500-9384 residues) and the giant pair is 100000 x 100000.
blosum62, gapo -11, gape -2 (0 for a linear spec).

Usage: python -m gpuseqalign_tpu_torch.bench.scaling_report [--quick]
[--spec nw_ag] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import card_info, resolve_device

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
RESRC = os.path.join(REPO, "resrc")
GAPO, GAPE = -11, -2
GIANT_SEED = 20261016
QUICK_GIANT = (1024, 2048)
FULL_GIANT = (100000, 100000)
QUICK_STREAM = (3, 256, 600)
# Bands of the giant rows beside D = 1, as the JAX report's.
GIANT_D = 4
# Runs of a row from the coordinator: the import, the card's first
# touch, the build's load and the runs themselves.
ROW_TIMEOUT_S = 600
_RUN = ("import sys; from gpuseqalign_tpu_torch.bench.scaling_report "
        "import run_job; run_job(sys.argv[1])")


def _gape(spec: str) -> int:
    return GAPE if spec.endswith("ag") else 0


def _subst() -> np.ndarray:
    from ..io.subst import parse_subst_file

    return parse_subst_file(os.path.join(RESRC, "subst.json")).subst_map[
        "blosum62"]


def _random_pairs(sizes, S: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(np.concatenate([[0], rng.integers(0, S, r)]).astype(np.int32),
             np.concatenate([[0], rng.integers(0, S, c)]).astype(np.int32))
            for r, c in sizes]


def batch_pairs(quick: bool, S: int):
    """The batch rows' pairs: the JAX report's quick sizes, or
    pair_generated_1."""
    if quick:
        return _random_pairs([(100 + 13 * k, 150 + 17 * k)
                              for k in range(16)], S, 7)
    return _file_pairs()


def _file_pairs():
    from ..io.subst import parse_subst_file
    from .throughput import file_pairs

    letters = parse_subst_file(os.path.join(RESRC, "subst.json")).letter_map
    return file_pairs(os.path.join(RESRC, "seq_generated.fa"),
                      os.path.join(RESRC, "pair_generated_1.txt"), letters)


def ran_on(devices: Sequence[torch.device],
           unit: str = "mesh entries") -> dict:
    """What a row ran on: the platform, the distinct devices, its entries
    (``unit``: mesh entries or processes; a card named twice is one card,
    never two), and the card's name and power limit."""
    devs = list(dict.fromkeys(devices))
    n = len(devices)
    cuda = devs[0].type == "cuda"
    place = ("the CPU" if not cuda else "one card" if len(devs) == 1
             else f"{len(devs)} cards")
    where = place if n == 1 else f"{n} {unit} on {place}"
    if not cuda:
        return {"platform": "cpu", "devices": ["cpu"], "cards": 0,
                "entries": n, "where": where}
    name, power = card_info(devs[0])
    return {"platform": "gpu",
            "devices": [torch.cuda.get_device_name(d) for d in devs],
            "cards": len(devs), "card_count": torch.cuda.device_count(),
            "card": f"{name}, {power}", "entries": n, "where": where}


def _mesh_devices(dev: torch.device, n: int) -> List[torch.device]:
    """n mesh entries: n cards where the machine has them, else n entries
    of the one card (or of the CPU)."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reps(job: dict) -> int:
    return 1 if job["quick"] else 3


def _best_of(fn, dev: torch.device, reps: int) -> List[float]:
    """Host-clock seconds of ``reps`` runs of ``fn`` after a warm-up."""
    fn()
    out = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def _batch_row(job: dict) -> dict:
    from ..core.types import AlignSpec
    from ..parallel import align_pairs_batched, make_mesh

    dev = torch.device(job["device"])
    subst = _subst()
    pairs = batch_pairs(job["quick"], subst.shape[0])
    spec = AlignSpec.from_name(job["spec"])
    devs = _mesh_devices(dev, job["mesh"]) if job["mesh"] else [dev]
    kw = (dict(mesh=make_mesh(devices=devs)) if job["mesh"]
          else dict(device=dev))
    got = []
    ts = _best_of(lambda: got.append(align_pairs_batched(
        spec, subst, pairs, GAPO, _gape(job["spec"]), quantum="pow2",
        **kw)), dev, _reps(job))
    cells = sum((len(y) - 1) * (len(x) - 1) for y, x in pairs)
    t = min(ts)
    return {"ran_on": ran_on(devs), "pairs": len(pairs),
            "pairs_per_s": len(pairs) / t, "gcups_agg": cells / t / 1e9,
            "windows_s": ts, "cost_sum": int(got[-1].costs.sum())}


def _procs_row(job: dict) -> Optional[dict]:
    from ..core.types import AlignSpec
    from ..parallel import align_pairs_multihost, distributed_init

    rank = job["rank"]
    distributed_init(f"localhost:{job['port']}", 2, rank)
    dev = torch.device(job["device"])
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        dev = torch.device("cuda", rank)
    subst = _subst()
    pairs = batch_pairs(job["quick"], subst.shape[0])
    spec = AlignSpec.from_name(job["spec"])
    got = []
    ts = _best_of(lambda: got.append(align_pairs_multihost(
        spec, subst, pairs, GAPO, _gape(job["spec"]), quantum="pow2",
        device=dev)), dev, _reps(job))
    # Both ranks hold every pair's result; rank 0 reports.
    import torch.distributed as dist

    devs = [None, None]
    dist.all_gather_object(devs, str(dev))
    dist.destroy_process_group()
    if rank:
        return None
    cells = sum((len(y) - 1) * (len(x) - 1) for y, x in pairs)
    t = min(ts)
    return {"ran_on": ran_on([torch.device(d) for d in devs], "processes"),
            "pairs": len(pairs),
            "pairs_per_s": len(pairs) / t, "gcups_agg": cells / t / 1e9,
            "windows_s": ts, "cost_sum": int(got[-1].costs.sum())}


def _giant_input(job: dict, subst: np.ndarray, rows: int, cols: int):
    from ..core.types import make_alg_input

    (y, x), = _random_pairs([(rows, cols)], subst.shape[0], GIANT_SEED)
    return make_alg_input(subst, y, x, GAPO, _gape(job["spec"]), job["spec"],
                          device=job["device"])


def _giant_row(job: dict) -> dict:
    """One pair at D = 1 and at GIANT_D bands, each through align_giant2
    once (cost, wall) and its fill alone, timed; the costs must agree."""
    g1, gd = (_giant_at(job, D) for D in (1, GIANT_D))
    if g1["cost"] != gd["cost"]:
        raise RuntimeError(f"giant cost at D {GIANT_D} ({gd['cost']}) != "
                           f"D 1's ({g1['cost']})")
    return {
        "D1": g1, f"D{GIANT_D}": gd,
        "pipeline_efficiency": gd["gcups_per_band"] / g1["gcups_per_band"],
        # Per-band rate by the call model: steps at D = 1 over D x steps.
        "model_efficiency": g1["model_steps"] / (GIANT_D
                                                 * gd["model_steps"]),
    }


def _giant_at(job: dict, D: int) -> dict:
    from ..core.types import AlgParams, AlgResult
    from ..ops import banded_cuda
    from ..parallel import align_giant2, fill_plan, giant2_fill, make_mesh

    dev = torch.device(job["device"])
    rows, cols = QUICK_GIANT if job["quick"] else FULL_GIANT
    subst = _subst()
    devs = _mesh_devices(dev, D)
    mesh = make_mesh(devices=devs, axis_name="sp")
    nw = _giant_input(job, subst, rows, cols)
    res = AlgResult()
    t0 = time.perf_counter()
    stat = align_giant2(AlgParams({}), nw, res, mesh=mesh)
    wall = time.perf_counter() - t0
    if stat != 0:
        raise RuntimeError(f"align_giant2 at D {D}: status {stat}")
    plan = fill_plan(AlgParams({}), [rows], [cols], D, nw.spec, devs[0])
    y, x = (t.to(devs[0]) for t in plan.pad(nw.seqY, nw.seqX))
    s_d = torch.from_numpy(subst).to(devs[0])
    kw = dict(mesh=mesh, plan=plan, kind=nw.spec.kind.value,
              gap=nw.spec.gap.value)

    def fill():
        return giant2_fill(s_d, [y], [x], GAPO, _gape(job["spec"]),
                           [rows + 1], [cols + 1], **kw)

    fill()
    reps = _reps(job)
    banded_cuda.LAUNCHES = 0
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fill()
        end.record()
        end.synchronize()
        fill_s = start.elapsed_time(end) / 1e3 / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fill()
        fill_s = (time.perf_counter() - t0) / reps
    gcups = rows * cols / fill_s / 1e9
    return {"ran_on": ran_on(devs), "bands": D, "rows": rows, "cols": cols,
            "tile": [plan.R, plan.TW], "BL": plan.BL,
            "band_cols": plan.band_cols, "n_pass": plan.n_pass[0],
            "call_passes": plan.C, "calls": plan.calls,
            "launches_per_fill": banded_cuda.LAUNCHES // reps,
            "fill_ms": fill_s * 1e3, "gcups": gcups,
            "gcups_per_band": gcups / D, "model_steps": plan.model_steps,
            "align_giant2_s": wall, "cost": int(res.align_cost)}


def _stream_row(job: dict) -> dict:
    """A stream of pairs at GIANT_D bands: align_giant2_stream against one
    align_giant2 call a pair, in turns; the costs must agree."""
    from ..core.types import AlgParams, AlgResult, make_alg_input
    from ..parallel import (
        align_giant2,
        align_giant2_stream,
        fill_plan,
        make_mesh,
    )

    dev, D = torch.device(job["device"]), GIANT_D
    subst = _subst()
    if job["quick"]:
        n, r, c = QUICK_STREAM
        pairs = _random_pairs([(r, c)] * n, subst.shape[0], 7)
    else:
        pairs = _file_pairs()
    devs = _mesh_devices(dev, D)
    mesh = make_mesh(devices=devs, axis_name="sp")
    inputs = [make_alg_input(subst, y, x, GAPO, _gape(job["spec"]),
                             job["spec"], device=job["device"])
              for y, x in pairs]
    pr = AlgParams({})

    def sequential():
        results = [AlgResult() for _ in inputs]
        stats = [align_giant2(pr, nw, res, mesh=mesh)
                 for nw, res in zip(inputs, results)]
        return stats, [res.align_cost for res in results]

    def stream():
        results = [AlgResult() for _ in inputs]
        stats = align_giant2_stream(pr, inputs, results, mesh=mesh)
        return stats, [res.align_cost for res in results]

    ts = {"sequential": [], "stream": []}
    costs = {}
    # A warm-up of each mode, then the timed windows in turns.
    turns = ("stream", "sequential") + (
        () if job["quick"] else ("sequential", "stream"))
    for mode in ("sequential", "stream") + turns:
        fn = sequential if mode == "sequential" else stream
        _sync(dev)
        t0 = time.perf_counter()
        stats, costs[mode] = fn()
        ts[mode].append(time.perf_counter() - t0)
        if any(stats):
            raise RuntimeError(f"giant {mode} at D {D}: statuses {stats}")
    if costs["sequential"] != costs["stream"]:
        raise RuntimeError("giant stream costs differ from sequential")
    ts = {m: v[1:] for m, v in ts.items()}  # the first of each: warm-up
    rows = [len(y) - 1 for y, _ in pairs]
    cols = [len(x) - 1 for _, x in pairs]
    spec = inputs[0].spec
    steps_seq = sum(fill_plan(pr, [r], [c], D, spec, devs[0]).model_steps
                    for r, c in zip(rows, cols))
    steps_str = fill_plan(pr, rows, cols, D, spec, devs[0]).model_steps
    t_seq, t_str = min(ts["sequential"]), min(ts["stream"])
    return {"ran_on": ran_on(devs), "bands": D, "pairs": len(pairs),
            "t_sequential_s": t_seq, "t_stream_s": t_str,
            "windows_s": ts, "speedup": t_seq / t_str,
            "step_model_speedup": steps_seq / steps_str,
            "cost_sum": int(sum(costs["stream"]))}


_ROWS = {"batch": _batch_row, "procs": _procs_row, "giant": _giant_row,
         "stream": _stream_row}


def run_job(arg: str) -> None:
    """A row's subprocess: runs the job (JSON) and prints its row as the
    last line of its output (nothing from a rank other than 0)."""
    job = json.loads(arg)
    row = _ROWS[job["kind"]](job)
    if row is not None:
        print(json.dumps(row), flush=True)


def _start(job: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", _RUN, json.dumps(job)],
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs: Sequence[subprocess.Popen]) -> Optional[dict]:
    """Wait for a row's processes; the last JSON line of their output.
    A process that fails, or outlasts ROW_TIMEOUT_S, fails the report."""
    row = None
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=ROW_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"scaling row exit {proc.returncode}: {err[-3000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if lines:
                row = json.loads(lines[-1])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return row


def _row(job: dict) -> dict:
    return _finish([_start(job)])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the JAX report's small sizes")
    ap.add_argument("--spec", default="nw_ag")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    base = {"quick": args.quick, "spec": args.spec, "device": device}

    t_all = time.perf_counter()
    report: Dict[str, object] = {"spec": args.spec, "quick": args.quick,
                                 "host": socket.gethostname(),
                                 "configs": {}}
    rows = report["configs"]
    rows["1card" if dev.type == "cuda" else "1cpu"] = _row(
        dict(base, kind="batch", mesh=0))
    rows["mesh"] = _row(dict(base, kind="batch", mesh=2))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rows["2procs"] = _finish([_start(dict(base, kind="procs", rank=r,
                                          port=port)) for r in (0, 1)])
    rows["giant_pair"] = _row(dict(base, kind="giant"))
    rows["giant_stream"] = _row(dict(base, kind="stream"))
    report["elapsed_s"] = time.perf_counter() - t_all

    text = json.dumps(report, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
