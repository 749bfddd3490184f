"""Step-body probes of the port's DP kernels on an H100: the measured
basis of its roofline (the counterpart of gpuseqalign_tpu/bench/vpu_probe.py).

Every probe runs a kernel of ``ops/csrc/probe.cu`` (wrappers in
``ops/probe_cuda.py``) twice: on one block, whose time per step is the
chain's latency (ns per chain step), and on the whole card (SM count x
resident blocks a SM), whose rate is the card's (GCUPS or Gops). Times
follow the two-point recipe, (T(M2) - T(M1)) / (M2 - M1) over M iterations
or columns, timed with CUDA events, so launch overhead and each strip's
ramp drop out. Each rate is also given as a share of the published int32
bound, 132 SMs x 64 int32 lanes x 1.98 GHz (PERF.md §2), in one unit:
the int32 instructions the card issues, a step of each elementwise body
(``BODY_INSNS``, ``INT16_INSNS``) and a cell of each DP recurrence
(``INSNS_PER_CELL``).

  ops              per-body costs: int32 max+add (and the same in one DPX
                   __viaddmax_s32), a select, a shift+add, a warp rotation
                   by one lane (__shfl_sync) and by one warp (shared memory
                   and __syncthreads, K1's cross-warp hand-off); 12 chains
                   a thread, and the latency of one chain
  skeleton         K1's nw_lg step with constant scores and no header I/O,
                   at K = 1..8 strips a block
  skeleton_affine  the same for nw_ag
  fullstep         K1's faithful nw_lg step with ablation variants (base,
                   nolookup, noheader, onewarp, sw)
  fullstep_affine  the same for the Gotoh body
  int16            int32 against packed int16x2 add+max, and DPX
  roofline         roofline_body for the four specs: the fastest faithful
                   body (base or sw) over a sweep of K and blocks a SM
  gridcost         K1 (row strips) at 23728^2 against the same launch
                   with the DP cells skipped, and one strip alone
                   (``--gap``): its machinery share, the ns of a strip
                   step and the columns a strip trails the one above
  sass             what the compiler made of each probe kernel: registers,
                   spills, resident blocks a SM, and the opcodes of its SASS

Usage: python -m gpuseqalign_tpu_torch.bench.vpu_probe [PROBE|all]
[--K K] [--variants a,b] [--n N] [--gap linear|affine]. Prints one JSON
object per probe, with the card's name and power limit. ``all`` runs every
probe but gridcost and sass. ``main(argv, device=None)`` runs on the card
and raises without one; ``device="cpu"`` runs the plain versions at tiny
sizes, times them on the host clock and labels the output "cpu".
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import probe_cuda
from ..ops.probe_cuda import CHAIN_NCH, STRIP_K, kernel_info
from ..ops.probe_plain import CHAIN_BODIES, INT16_CHAINS, INT16_MODES, VARIANTS
from ..utils.device import card_info, resolve_device

# The published H100 SXM int32 issue rate: 132 SMs x 64 int32 lanes x
# 1.98 GHz (a quarter of the 67 TFLOP/s FP32 figure).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 instructions a DP cell of the recurrence issues on sm_90a. Its
# operations (linear gap: add diag, max up/left, add gap, max = 4; affine:
# F and E (max, 2 adds each) and H (add, 2 max) = 9; SW adds the zero clamp
# and the best-cell compare: 6 and 11) issue as fewer instructions, since
# each add that feeds a max fuses with it into one DPX VIADDMNMX and the SW
# clamp into its .RELU form. The faithful bodies' SASS a cell: nw_lg
# VIMNMX, VIADD, VIADDMNMX; nw_ag 3 VIADDMNMX, 2 VIADD, VIMNMX; SW the
# same with .RELU, and one ISETP for the compare.
INSNS_PER_CELL = {"nw_lg": 3, "sw_lg": 4, "nw_ag": 6, "sw_ag": 7}
# Instructions a chain step of each elementwise body as ptxas compiles it
# for sm_90a (the SASS opcodes of ``sass_summary``): the add and the max of
# maxadd2 fuse into one DPX VIADDMNMX, as viaddmax asks; the select is one
# SEL (its compare is hoisted); the shift and add one LEA; one SHFL; a
# shared store and load (and a barrier an iteration). Counting the source's
# two operations for maxadd2 read 195% of the int32 bound: an instruction
# count, not an operation count, is what the card issues.
BODY_INSNS = {"maxadd2": 1, "viaddmax": 1, "select": 1, "shift_add2": 1,
              "shfl": 1, "xwarp": 2}
# probe_int16: every mode compiles to one VIADDMNMX a chain step (ptxas
# fuses __vadd2 and __vmaxs2 into the DPX form too); int16x2 computes two
# values an instruction.
INT16_INSNS = {"i32": 1, "i16x2": 1, "i16x2_dpx": 1}
INT16_LANES = {"i32": 1, "i16x2": 2, "i16x2_dpx": 2}
GAPO, GAPE = -11, -2
SEED = 20261017
LETTERS = 25  # blosum62's alphabet
# The tile probe_gridcost times K1 at: K1's literal default, the one
# the card's tuned cache overrides (strips of 128 rows)
TILE_H, TILE_W = 128, 512
SASS_OPCODES = ("IMNMX", "VIMNMX", "VIADDMNMX", "VIADD", "IADD3", "IMAD",
                "SEL", "ISETP", "SHF", "LEA", "SHFL", "BAR", "LDS", "STS",
                "LDG", "STG", "LDL", "STL")
# Chains a thread of the ops probe (the JAX probe's 12).
OPS_CHAINS = 12


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The probes' sizes on one kind of device."""

    chain_iters: Tuple[int, int]   # M1, M2 iterations of a chain body
    strip_iters: Tuple[int, int]   # M1, M2 columns of a strip
    chain_threads: int             # threads a block of the chain bodies
    strip_threads: int             # rows a strip (K1's tile height)
    reps: int                      # timed runs at each M
    skeleton_ks: Tuple[int, ...]
    fullstep_ks: Tuple[int, ...]
    blocks_per_sm: Tuple[int, ...]  # roofline_body's sweep
    cpu_blocks: int = 0            # the "card" grid on the CPU


CARD = Sizes((2000, 20000), (512, 2048), 256, 128, 3, STRIP_K, STRIP_K,
             (1, 2, 4, 8, 16))
CPU = Sizes((2, 6), (2, 4), 64, 64, 1, (1, 2), (1, 2), (1,), cpu_blocks=2)


def sizes(dev: torch.device) -> Sizes:
    return CARD if dev.type == "cuda" else CPU


def spec_name(kind: str, gap: str) -> str:
    return f"{kind}_{'ag' if gap == 'affine' else 'lg'}"


def elapsed_s(fn: Callable[[], object], dev: torch.device, reps: int,
               head_start_s: float = 0.0) -> float:
    """Mean seconds of ``fn`` over ``reps`` runs after one warm-up: CUDA
    events on the card, the host clock on the CPU. ``head_start_s`` first
    keeps the card busy that long, so that many short launches queue up
    and run back to back instead of at the host's pace."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(dev):
        if head_start_s:
            torch.cuda._sleep(int(head_start_s * 2e9))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _time_pair(run: Callable[[int], object], m1: int, m2: int,
               dev: torch.device, reps: int) -> float:
    """Seconds per unit of M: (T(M2) - T(M1)) / (M2 - M1)."""
    t1 = elapsed_s(lambda: run(m1), dev, reps)
    t2 = elapsed_s(lambda: run(m2), dev, reps)
    return (t2 - t1) / (m2 - m1)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def card_grid(dev: torch.device, kernel: str, sel: str, K: int, nt: int,
          bps: Optional[int] = None) -> Tuple[int, Dict[str, int]]:
    """Blocks that fill the card (SM count x ``bps``, by default the
    resident maximum) and the kernel's resources; on the CPU the small
    grid of ``CPU``."""
    if dev.type != "cuda":
        return CPU.cpu_blocks, {}
    info = kernel_info(kernel, sel, K, nt)
    bps = bps or info["blocks_per_sm"]
    return _sm_count(dev) * bps, dict(info, blocks_per_sm=bps)


def _share(ops_per_s: float, dev: torch.device) -> Optional[float]:
    """``ops_per_s`` over the published int32 bound; None on the CPU,
    where the bound of the card means nothing."""
    return ops_per_s / INT32_OPS_PER_S if dev.type == "cuda" else None


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng([SEED, sum(map(ord, tag))])


def chain_input(blocks: int, nt: int, dev: torch.device, tag: str,
                full_words: bool = False) -> torch.Tensor:
    """Per-thread inputs: small (in [-3, 3], so no chain overflows int32
    within the timed iterations) or, for the int16 lanes, whole words."""
    rng = _rng(tag)
    if full_words:
        v = rng.integers(-2 ** 31, 2 ** 31, (blocks, nt), dtype=np.int64)
    else:
        v = rng.integers(-3, 4, (blocks, nt))
    return torch.from_numpy(v.astype(np.int32)).to(dev)


def strip_inputs(blocks: int, K: int, nt: int, iters: int,
                 dev: torch.device, tag: str):
    """(subst, y, x, a) of probe_fullstep: a random matrix of blosum62's
    size and range, random letters, and the nolookup scores a."""
    rng = _rng(tag)
    subst = rng.integers(-4, 12, (LETTERS, LETTERS))
    y = rng.integers(0, LETTERS, (blocks, K, nt))
    x = rng.integers(0, LETTERS, (K, 1 + iters))
    x[:, 0] = 0
    a = rng.integers(-3, 4, (blocks, nt))
    return tuple(torch.from_numpy(v.astype(np.int32)).to(dev)
                 for v in (subst, y, x, a))


def _rates(run_on: Callable[[int], Callable[[int], object]], blocks: int,
           iters: Tuple[int, int], dev: torch.device, reps: int
           ) -> Tuple[float, float]:
    """Seconds per step of one block and of ``blocks`` blocks."""
    return (_time_pair(run_on(1), *iters, dev, reps),
            _time_pair(run_on(blocks), *iters, dev, reps))


def probe_ops(device=None) -> dict:
    """Per-body costs, 12 chains a thread: ns per chain step and per
    instruction on one block, the card's instructions a second and share
    of the int32 bound, and one chain's latency a step (one block, one
    chain a thread)."""
    dev = resolve_device(device)
    sz = sizes(dev)
    nt = sz.chain_threads
    out = {}
    for body, insns in BODY_INSNS.items():
        blocks, info = card_grid(dev, "probe_chain", body, OPS_CHAINS, nt)

        def run_on(nb, nch=OPS_CHAINS, body=body):
            a = chain_input(nb, nt, dev, body)
            return lambda m: probe_cuda.probe_chain(a, body, nch, m)

        dt1, dtc = _rates(run_on, blocks, sz.chain_iters, dev, sz.reps)
        latency = _time_pair(run_on(1, 1), *sz.chain_iters, dev, sz.reps)
        step_ns = dt1 * 1e9 / OPS_CHAINS
        card_insns = blocks * nt * OPS_CHAINS * insns / dtc
        out[body] = {
            "ns_per_chain_step": step_ns, "ns_per_insn": step_ns / insns,
            "latency_ns": latency * 1e9, "insns": insns,
            "card_ginsns": card_insns / 1e9,
            "peak_share": _share(card_insns, dev),
            "blocks": blocks, "threads": nt, **info,
        }
    return out


def probe_skeleton(affine: bool, ks: Optional[Sequence[int]] = None,
                   device=None) -> dict:
    """K1's step with constant scores and no header I/O at K strips a
    block: ns per chain step (one block) and the card's GCUPS."""
    dev = resolve_device(device)
    sz = sizes(dev)
    nt = sz.strip_threads
    body = "skeleton_nw_ag" if affine else "skeleton_nw_lg"
    gape = GAPE if affine else 0
    spec = "nw_ag" if affine else "nw_lg"
    res = {}
    for K in ks or sz.skeleton_ks:
        blocks, info = card_grid(dev, "probe_chain", body, K, nt)

        def run_on(nb, K=K):
            a = chain_input(nb, nt, dev, body)
            return lambda m: probe_cuda.probe_chain(a, body, K, m, GAPO, gape)

        dt1, dtc = _rates(run_on, blocks, sz.strip_iters, dev, sz.reps)
        cells = blocks * nt * K / dtc
        res[f"K{K}"] = {
            "ns_per_chain_step": dt1 * 1e9 / K, "gcups": cells / 1e9,
            "peak_share": _share(cells * INSNS_PER_CELL[spec], dev),
            "blocks": blocks, "threads": nt, **info,
        }
    return res


def _fullstep_rate(variant: str, gap: str, K: int, dev: torch.device,
                   bps: Optional[int] = None, one_block: bool = True
                   ) -> dict:
    sz = sizes(dev)
    affine = gap == "affine"
    nt = 32 if variant == "onewarp" else sz.strip_threads
    kernel = "probe_fullstep_affine" if affine else "probe_fullstep"
    blocks, info = card_grid(dev, kernel, variant, K, nt, bps)
    gape = GAPE if affine else 0
    spec = spec_name("sw" if variant == "sw" else "nw", gap)

    def run_on(nb):
        ins = {m: strip_inputs(nb, K, nt, m, dev, variant)
               for m in sz.strip_iters}
        return lambda m: probe_cuda.probe_fullstep(
            *ins[m], GAPO, gape, gap=gap, variant=variant)

    dtc = _time_pair(run_on(blocks), *sz.strip_iters, dev, sz.reps)
    cells = blocks * nt * K / dtc
    out = {"K": K, "gcups": cells / 1e9,
           "peak_share": _share(cells * INSNS_PER_CELL[spec], dev),
           "blocks": blocks, "threads": nt, **info}
    if one_block:
        dt1 = _time_pair(run_on(1), *sz.strip_iters, dev, sz.reps)
        out["ns_per_chain_step"] = dt1 * 1e9 / K
    return out


def probe_fullstep(K: int = 4, variants: Optional[Sequence[str]] = None,
                   gap: str = "linear", device=None) -> dict:
    """K1's faithful nw_lg (``gap`` "linear") or nw_ag step at K strips a
    block, one entry per ablation variant: base, nolookup (a constant
    score a row), noheader (no right-column or bottom-row stores),
    onewarp (32-row strips: no cross-warp slot, no barrier), sw."""
    dev = resolve_device(device)
    return {v: _fullstep_rate(v, gap, K, dev) for v in variants or VARIANTS}


def probe_fullstep_affine(K: int = 6, variants=None, device=None) -> dict:
    """probe_fullstep for the Gotoh (nw_ag / sw_ag) body."""
    return probe_fullstep(K, variants, "affine", device)


def roofline_body(kind: str, gap: str, K: Optional[int] = None,
                  device=None) -> dict:
    """The spec's fastest faithful step body measured now, in the calling
    process: ``base`` (NW) or ``sw`` over a sweep of K (all of STRIP_K
    unless ``K`` is given) and blocks a SM, at its best card GCUPS."""
    dev = resolve_device(device)
    sz = sizes(dev)
    variant = "sw" if kind == "sw" else "base"
    kernel = "probe_fullstep_affine" if gap == "affine" else "probe_fullstep"
    sweep, best = {}, None
    for k in [K] if K else sz.fullstep_ks:
        bpss = [None]
        if dev.type == "cuda":
            most = kernel_info(kernel, variant, k, sz.strip_threads
                               )["blocks_per_sm"]
            bpss = sorted({b for b in sz.blocks_per_sm if b < most} | {most})
        for bps in bpss:
            r = _fullstep_rate(variant, gap, k, dev, bps, one_block=False)
            sweep[f"K{k}_b{r.get('blocks_per_sm', 0)}"] = r["gcups"]
            if best is None or r["gcups"] > best["gcups"]:
                best = r
    ns = _fullstep_rate(variant, gap, best["K"], dev, best.get(
        "blocks_per_sm"))["ns_per_chain_step"]
    return {"spec": spec_name(kind, gap), "variant": variant, **best,
            "ns_per_chain_step": ns, "sweep": sweep}


def probe_int16(device=None) -> dict:
    """12 max(c + a, a + 7) chains a thread in int32, int16x2 (__vadd2,
    __vmaxs2) and int16x2 DPX (__viaddmax_s16x2)."""
    dev = resolve_device(device)
    sz = sizes(dev)
    nt = sz.chain_threads
    out = {}
    for mode in INT16_MODES:
        blocks, info = card_grid(dev, "probe_int16", mode, 0, nt)

        def run_on(nb, mode=mode):
            a = chain_input(nb, nt, dev, mode, full_words=mode != "i32")
            return lambda m: probe_cuda.probe_int16(a, mode, m)

        dt1, dtc = _rates(run_on, blocks, sz.chain_iters, dev, sz.reps)
        step_ns = dt1 * 1e9 / INT16_CHAINS
        steps = blocks * nt * INT16_CHAINS / dtc
        out[mode] = {
            "ns_per_chain_step": step_ns,
            "ns_per_insn": step_ns / INT16_INSNS[mode],
            "lanes": INT16_LANES[mode],
            "card_lane_gops": steps * 2 * INT16_LANES[mode] / 1e9,
            "peak_share": _share(steps * INT16_INSNS[mode], dev),
            "blocks": blocks, "threads": nt, **info,
        }
    return out


def probe_gridcost(n: int = 23728, gap: str = "linear",
                   device=None) -> dict:
    """Split K1's (``mlsp_fill``) time at n x n, tile 128 x 512, into the
    DP cells and the machinery around them (the shuffles, the hand-over
    between strips, the header stores, the SW reduction), by timing the
    same launch with the cells skipped; and time one strip of the same
    columns alone, whose steps run back to back: its ns a step (a strip
    column) with and without the cells, and from the whole fill the
    columns each strip trails the one above (the pipeline's lag)."""
    from ..ops import strip_cuda
    from ..ops.mlsp_cuda import mlsp_fill

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("probe_gridcost times the kernel's machinery on "
                         "the card; the plain fill has none")
    th, tw = TILE_H, TILE_W
    sh = strip_cuda.strip_rows(th)
    rng = np.random.default_rng(7)
    subst = torch.from_numpy(
        rng.integers(-4, 10, (LETTERS, LETTERS)).astype(np.int32)).to(dev)
    trows, tcols = -(-n // th), -(-n // tw)
    y = np.zeros(1 + trows * th, np.int32)
    x = np.zeros(1 + tcols * tw, np.int32)
    y[1:1 + n] = rng.integers(0, LETTERS, n)
    x[1:1 + n] = rng.integers(0, LETTERS, n)
    y, x = torch.from_numpy(y).to(dev), torch.from_numpy(x).to(dev)
    cols = x.numel() - 1
    ns = strip_cuda.n_strips(y.numel() - 1, sh)
    kw = dict(gapo=GAPO, gape=GAPE if gap == "affine" else 0, adjr=n + 1,
              adjc=n + 1, tile_w=tw, kind="nw", gap=gap)
    res = {"n": n, "gap": gap, "tile": [th, tw], "strips": ns,
           "launches": 1}
    for name, yy, tile_h in (("", y, th), ("one_strip_", y[:1 + sh], sh)):
        for part, off in (("full", False), ("bodyoff", True)):
            res[name + part] = {"ms": 1e3 * elapsed_s(
                lambda off=off, yy=yy, tile_h=tile_h: mlsp_fill(
                    subst, yy, x, **kw, tile_h=tile_h, _bodyoff=off),
                dev, 3, head_start_s=0.05)}
    steps = cols + 32  # a strip's steps: its columns and 31 of lane skew
    step_ns = res["one_strip_full"]["ms"] * 1e6 / steps
    res.update(
        body_ms=res["full"]["ms"] - res["bodyoff"]["ms"],
        machinery_frac=res["bodyoff"]["ms"] / res["full"]["ms"],
        steps_per_strip=steps,
        ns_per_serial_step=step_ns,
        ns_per_serial_step_bodyoff=(res["one_strip_bodyoff"]["ms"] * 1e6
                                    / steps),
        lag_steps=((res["full"]["ms"] - res["one_strip_full"]["ms"]) * 1e6
                   / step_ns / max(1, ns - 1)),
    )
    return res


def _cuda_bin(tool: str) -> str:
    found = shutil.which(tool)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", tool)
    if not os.path.exists(path):
        raise RuntimeError(f"{tool} not found")
    return path


def sass_summary() -> dict:
    """Per probe kernel of the built library: registers, spill bytes and
    resident blocks a SM (``kernel_info``), and the count of each of
    ``SASS_OPCODES`` (the base name, before the first '.') in its SASS."""
    from ..ops import build

    build.build_all(["probe"])
    dump = subprocess.run([_cuda_bin("cuobjdump"), "-sass",
                           build.so_path("probe")], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if m and current is not None and m.group(1) in SASS_OPCODES:
            current[m.group(1)] = current.get(m.group(1), 0) + 1
    names = list(counts)
    try:
        demangled = subprocess.run(
            [_cuda_bin("cu++filt")], input="\n".join(names),
            capture_output=True, text=True, check=True).stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        demangled = names
    resources = {}
    for kernel, sels, ks, nt in (
            ("probe_chain", CHAIN_BODIES[:6], CHAIN_NCH, CARD.chain_threads),
            ("probe_chain", CHAIN_BODIES[6:], STRIP_K, CARD.strip_threads),
            ("probe_fullstep", VARIANTS, STRIP_K, CARD.strip_threads),
            ("probe_fullstep_affine", VARIANTS, STRIP_K, CARD.strip_threads),
            ("probe_int16", INT16_MODES, (0,), CARD.chain_threads)):
        for sel in sels:
            for k in ks:
                resources[f"{kernel}/{sel}/K{k}"] = kernel_info(
                    kernel, sel, k, 32 if sel == "onewarp" else nt)
    return {"resources": resources,
            "opcodes": dict(zip(demangled, counts.values()))}


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    import argparse

    probes = ("ops", "skeleton", "skeleton_affine", "fullstep",
              "fullstep_affine", "int16", "roofline", "gridcost", "sass")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=probes + ("all",))
    ap.add_argument("--K", type=int, default=0,
                    help="strips a block of fullstep (default 4, affine 6) "
                         "and roofline (default: the sweep)")
    ap.add_argument("--variants", default="",
                    help="comma-separated fullstep variants (default all)")
    ap.add_argument("--n", type=int, default=23728, help="gridcost's n")
    ap.add_argument("--gap", default="linear", choices=("linear", "affine"),
                    help="gridcost's gap")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card, power = card_info(dev)
    head = {"device": dev.type, "card": card, "power_limit": power}
    variants = args.variants.split(",") if args.variants else None
    todo = set(probes[:7]) if args.which == "all" else {args.which}

    def emit(probe: str, res: dict) -> None:
        print(json.dumps({"probe": probe, **head, **res}), flush=True)

    if "ops" in todo:
        emit("ops", probe_ops(dev))
    if "skeleton" in todo:
        emit("skeleton_nw_lg", probe_skeleton(False, device=dev))
    if "skeleton_affine" in todo:
        emit("skeleton_nw_ag", probe_skeleton(True, device=dev))
    if "fullstep" in todo:
        emit("fullstep_nw_lg", probe_fullstep(args.K or 4, variants,
                                              device=dev))
    if "fullstep_affine" in todo:
        emit("fullstep_nw_ag", probe_fullstep_affine(args.K or 6, variants,
                                                     device=dev))
    if "int16" in todo:
        emit("int16", probe_int16(dev))
    if "roofline" in todo:
        for kind, gap in (("nw", "linear"), ("sw", "linear"),
                          ("nw", "affine"), ("sw", "affine")):
            emit(f"roofline_{spec_name(kind, gap)}",
                 roofline_body(kind, gap, args.K or None, dev))
    if "gridcost" in todo:
        emit(f"gridcost_{spec_name('nw', args.gap)}",
             probe_gridcost(args.n, args.gap, device=dev))
    if "sass" in todo:
        emit("sass", sass_summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
