"""Benchmark orchestrator (ref: src/benchmark.cpp:328-540).

Run-loop nest: algorithms (reference algorithm forced first) x sequence
pairs x parameter combinations (odometer) x (warmup + sample repeats);
per repeat: align -> optional score hash -> optional traceback -> verify
against the first algorithm's results. Successful warmup runs are
discarded; failed ones are kept (ref: src/benchmark.cpp:498-502). Repeats
are lap-averaged via Stopwatch.combine. Progress dots / errstep digits go
to stdout; results stream to the TSV.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.registry import Algorithm, get_algorithm_map
from ..core.types import (
    AlgInput,
    AlgParams,
    AlgResult,
    AlignSpec,
    Range,
    SeqPair,
    Status,
)
from ..io.tsv import TsvPrintCtl, write_result_to_tsv
from ..utils.stopwatch import Stopwatch


@dataclasses.dataclass
class BenchmarkData:
    result_list: List[AlgResult] = dataclasses.field(default_factory=list)
    calc_errors: int = 0


CompareKey = Tuple[str, str, Range, Range]


@dataclasses.dataclass
class CompareRes:
    align_cost: int
    score_hash: int
    trace_hash: int

    def __eq__(self, other):
        return (
            self.align_cost == other.align_cost
            and self.score_hash == other.score_hash
            and self.trace_hash == other.trace_hash
        )


def set_or_verify_result(
    res: AlgResult, compare_map: Dict[CompareKey, CompareRes]
) -> Status:
    """First algorithm to produce a key SETS the expected value; later
    algorithms must match it (ref: src/benchmark.cpp:119-147)."""
    key = (res.seqY_id, res.seqX_id, res.seqY_range, res.seqX_range)
    calc = CompareRes(res.align_cost, res.score_hash, res.trace_hash)
    if key not in compare_map:
        compare_map[key] = calc
        return Status.success
    if compare_map[key] != calc:
        return Status.errorInvalidResult
    return Status.success


def vector_substring_with_header(
    vect: np.ndarray, rng: Range
) -> Optional[np.ndarray]:
    """Apply a Range to a stored sequence, re-prepending the header element
    (ref: src/benchmark.cpp:14-36)."""
    size_no_header = len(vect) - 1
    if rng.l < 0 or rng.l >= size_no_header or rng.r <= rng.l or rng.r > size_no_header:
        return None
    if (not rng.l_not_default or rng.l == 0) and (
        not rng.r_not_default or rng.r == size_no_header
    ):
        return vect
    out = np.empty(1 + (rng.r - rng.l), dtype=np.int32)
    out[0] = 0
    out[1:] = vect[1 + rng.l: 1 + rng.r]
    return out


def combine_rep_results(res_list: List[AlgResult]) -> AlgResult:
    """(ref: src/benchmark.cpp:149-173) Take the last result (if one errored
    it is the last) and average the stopwatch laps."""
    if not res_list:
        return AlgResult()
    res = dataclasses.replace(res_list[-1])
    res.sw_align = Stopwatch.combine([r.sw_align for r in res_list])
    res.sw_hash = Stopwatch.combine([r.sw_hash for r in res_list])
    res.sw_trace = Stopwatch.combine([r.sw_trace for r in res_list])
    return res


def _device_core_count(dev: torch.device) -> int:
    """The reference's multiProcessorCount (ref: src/benchmark.cpp:178-187):
    the card's SM count, or the host CPU count on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return os.cpu_count() or 1


def benchmark_algs(cmd_args, cmd_data, bench_data: BenchmarkData,
                   device: torch.device) -> Status:
    compare_map: Dict[CompareKey, CompareRes] = {}
    alg_map = get_algorithm_map()

    nw = AlgInput()
    nw.subst = cmd_data.subst_data.subst_map[cmd_args.subst_name]
    nw.substsz = nw.subst.shape[0]
    nw.gapo_cost = cmd_args.gapo_cost
    nw.gape_cost = cmd_args.gape_cost
    nw.spec = AlignSpec.from_name(cmd_args.align_kind)
    nw.device = str(device)
    nw.core_count = _device_core_count(device)

    seq_map = cmd_data.seq_data.seq_map
    seq_list = list(seq_map.values())
    seq_idx_map = {seq.id: i for i, seq in enumerate(seq_list)}
    pair_list: List[SeqPair] = cmd_data.pair_list

    progress = cmd_args.f_write_progress
    res_ofs = cmd_data.res_ofs
    debug_ofs = cmd_data.debug_ofs

    # TSV header.
    ctl_hdr = TsvPrintCtl(
        write_col_name=True,
        f_print_score_stats=cmd_args.f_calc_score_hash,
        f_print_trace_stats=cmd_args.f_calc_trace,
    )
    write_result_to_tsv(res_ofs, AlgResult(), ctl_hdr)
    if progress:
        res_ofs.flush()

    # Reference algorithm first (ref: src/benchmark.cpp:384-390).
    alg_names = list(cmd_args.alg_names)
    if cmd_args.ref_alg_name in alg_names:
        alg_names.remove(cmd_args.ref_alg_name)
        alg_names.insert(0, cmd_args.ref_alg_name)

    try:
        for alg_name in alg_names:
            if progress:
                print(f"{alg_name}:", flush=True)

            alg = alg_map[alg_name]
            alg_params = AlgParams(cmd_data.alg_params.get(alg_name, {}))

            for pair in pair_list:
                iY = seq_idx_map[pair.seqY_id]
                iX = seq_idx_map[pair.seqX_id]
                seqY = vector_substring_with_header(
                    seq_list[iY].seq, pair.seqY_range
                )
                seqX = vector_substring_with_header(
                    seq_list[iX].seq, pair.seqX_range
                )
                if seqY is None or seqX is None:
                    print("error: cannot take substring from sequence",
                          file=sys.stderr)
                    return Status.errorInvalidValue

                nw.seqY = seqY
                nw.seqX = seqX
                nw.adjrows = len(seqY)
                nw.adjcols = len(seqX)

                alg_params.reset()
                while alg_params.has_curr():
                    rep_res: List[AlgResult] = []
                    i_r = -cmd_args.warmup_per_align
                    while i_r < cmd_args.samples_per_align:
                        res = AlgResult()
                        rep_res.append(res)
                        res.alg_name = alg_name
                        res.alg_params = alg_params.copy_current()
                        res.seqY_idx = iY
                        res.seqX_idx = iX
                        res.seqY_id = seq_list[iY].id
                        res.seqX_id = seq_list[iX].id
                        res.seqY_range = pair.seqY_range
                        res.seqX_range = pair.seqX_range
                        res.seqY_len = len(seqY) - 1
                        res.seqX_len = len(seqX) - 1
                        res.subst_name = cmd_args.subst_name
                        res.gapo_cost = cmd_args.gapo_cost
                        res.gape_cost = cmd_args.gape_cost
                        res.align_kind = cmd_args.align_kind
                        res.warmup_runs = cmd_args.warmup_per_align
                        res.sample_runs = cmd_args.samples_per_align
                        res.last_run_idx = i_r
                        res.core_count = nw.core_count

                        try:
                            res.stat = alg.align(alg_params, nw, res)
                        except Exception as e:
                            res.stat = Status.errorKernelFailure
                            res.error_msg = (
                                f"{type(e).__name__}: {e}"
                            )[:300]
                            print(
                                f"error: {alg_name} align failed on pair "
                                f"({res.seqY_id}, {res.seqX_id}): "
                                f"{res.error_msg}",
                                file=sys.stderr,
                            )
                        if res.stat != Status.success:
                            res.errstep = (
                                1 if res.stat == Status.errorInvalidValue else 2
                            )
                        def run_step(fn, step_name):
                            # Same contract as the align step: a raising
                            # hash/trace is THIS run's failure (errstep +
                            # error_msg in its TSV row), not an abort of
                            # every remaining pair/param/algorithm.
                            try:
                                return fn()
                            except Exception as e:
                                res.error_msg = (
                                    f"{type(e).__name__}: {e}"
                                )[:300]
                                print(
                                    f"error: {alg_name} {step_name} failed "
                                    f"on pair ({res.seqY_id}, "
                                    f"{res.seqX_id}): {res.error_msg}",
                                    file=sys.stderr,
                                )
                                return Status.errorKernelFailure

                        if (
                            cmd_args.f_calc_score_hash
                            and not res.errstep
                        ):
                            res.stat = run_step(
                                lambda: alg.hash(nw, res), "hash"
                            )
                            if res.stat != Status.success:
                                res.errstep = 3
                        if cmd_args.f_calc_trace and not res.errstep:
                            res.stat = run_step(
                                lambda: alg.trace(
                                    nw, res, cmd_args.f_print_trace
                                ),
                                "trace",
                            )
                            if res.stat != Status.success:
                                res.errstep = 4
                        if not res.errstep:
                            res.stat = set_or_verify_result(res, compare_map)
                            if res.stat != Status.success:
                                res.errstep = 5
                                bench_data.calc_errors += 1

                        if i_r < 0 and res.stat == Status.success:
                            rep_res.pop()  # discard successful warmups

                        last_iter = (
                            i_r == cmd_args.samples_per_align - 1
                            or res.stat != Status.success
                        )
                        if last_iter:
                            combined = combine_rep_results(rep_res)
                            bench_data.result_list.append(combined)
                            _print_report_line(
                                cmd_args, res_ofs, debug_ofs, alg, nw,
                                combined,
                            )

                        nw.reset_cycle()
                        if res.stat != Status.success:
                            break
                        i_r += 1

                    alg_params.next()

            if progress:
                print("\n", flush=True)
    finally:
        if bench_data.calc_errors > 0:
            print(
                f"error: {bench_data.calc_errors} calculation error(s)",
                file=sys.stderr,
            )

    if bench_data.calc_errors > 0:
        return Status.errorInvalidResult
    return Status.success


def _print_report_line(cmd_args, res_ofs, debug_ofs, alg: Algorithm,
                       nw: AlgInput, combined: AlgResult) -> None:
    if cmd_args.f_write_progress:
        if combined.stat == Status.success:
            print(".", end="", flush=True)
        else:
            print(combined.errstep, end="", flush=True)

    ctl = TsvPrintCtl(
        write_value=True,
        f_print_score_stats=cmd_args.f_calc_score_hash,
        f_print_trace_stats=cmd_args.f_calc_trace,
    )
    write_result_to_tsv(res_ofs, combined, ctl)
    if cmd_args.f_write_progress:
        res_ofs.flush()

    if (cmd_args.f_print_score or cmd_args.f_print_trace) and debug_ofs:
        debug_ofs.write(">results\n")
        hdr = TsvPrintCtl(
            write_col_name=True,
            f_print_score_stats=cmd_args.f_calc_score_hash,
            f_print_trace_stats=cmd_args.f_calc_trace,
        )
        write_result_to_tsv(debug_ofs, combined, hdr)
        write_result_to_tsv(debug_ofs, combined, ctl)
        if cmd_args.f_print_trace:
            debug_ofs.write("+\n>edit_trace\n")
            alg.print_trace(debug_ofs, nw, combined)
            debug_ofs.write("\n")
        if cmd_args.f_print_score:
            debug_ofs.write("+\n>score_matrix\n")
            alg.print_score(debug_ofs, nw, combined)
        debug_ofs.write("\n\n")
        if cmd_args.f_write_progress:
            debug_ofs.flush()
