"""CLI entry point — flag-compatible with the reference ``nw`` binary
(ref: src/cmd_parser.cpp:123-314), plus the framework's extensions:

  --algKind <nw_lg|nw_ag|sw_lg|sw_ag>  alignment problem (default nw_lg;
                                       the reference implements only nw_lg)
  --gapeCost <cost>                    gap-extend cost — USED by the *_ag
                                       kinds here (parsed-but-unused in the
                                       reference, ref: src/cmd_parser.cpp:143)

Usage: python -m gpuseqalign_tpu_torch --algParamPath p --seqPath p [params]

Runs on the CUDA card; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
from typing import Dict, List, Optional, TextIO, Union

import torch

from ..core.registry import get_algorithm_map
from ..core.types import Status
from ..io.fasta import FormatError, parse_seq_file
from ..io.params import parse_alg_params_file
from ..io.pairs import default_pairs, parse_seq_pair_file
from ..io.subst import SubstError, parse_subst_file
from ..utils.device import resolve_device
from .driver import BenchmarkData, benchmark_algs

USAGE = """nw --algParamPath "path" --seqPath "path" [params]

Parameters:
-b, --substPath <path>     Path of JSON substitution matrices file, defaults to "./resrc/subst.json".
-r, --algParamPath <path>  Path of JSON algorithm parameters file.
-s, --seqPath <path>       Path of FASTA file with sequences to be aligned.
-p, --seqPairPath <path>   Path of TXT file with sequence pairs to be aligned. Each line has the format "seqY seqX",
                           where "seqY" and "seqX" are sequence ids. It's possible to specify a substring
                           e.g. "seqX[l:r]", starting from element "l" inclusive until element "r" exclusive.
                           The start/end of the interval can be omitted: "[l:]", "[:r]", "[:]".
                           If the TXT file is not specified, then all sequences in the FASTA file except the first
                           are aligned to the first sequence. In that case, there must be two or more sequences
                           in the FASTA file.
-o, --resPath <path>       Path of TSV test bench results file, defaults to "./logs/%{datetime}.tsv".

--substName <name>         Substitution matrix name from the "subst" file. Defaults to "blosum62".
--gapoCost <cost>          Gap open cost. Integer, defaults to -11.
--gapeCost <cost>          Gap extend cost (used by affine-gap kinds). Integer, defaults to 0.
--algKind <kind>           Alignment kind: nw_lg, nw_ag, sw_lg, sw_ag. Defaults to nw_lg.
--algName <name>           Algorithm from the "algParam" JSON file to run; repeatable.
--refAlgName <name>        Algorithm treated as the source of truth (run first).
--warmupPerAlign <num>     Warmup runs per alignment. Nonnegative integer, defaults to 0.
--samplesPerAlign <num>    Runs per alignment. Positive integer, defaults to 1.

--fCalcTrace               Calculate the traceback. Defaults to false.
--fCalcScoreHash           Calculate the score-matrix hash. Defaults to false.
--fWriteProgress           Print progress to stdout. Defaults to false.
--debugPath <path>         Debug TXT output path for score matrices/traces.
--fPrintScore              Print the score matrix to the debug file.
--fPrintTrace              Print the trace to the debug file.
--profileDir <path>        Capture a torch.profiler trace of the whole
                           benchmark into this directory (Chrome trace JSON,
                           viewable in Perfetto). The analog of the
                           reference's RelWithDebInfo + external-profiler
                           flow (ref: README.md:117-118).

-h, --help                 Print help and exit.
"""


@dataclasses.dataclass
class CmdArgs:
    subst_path: Optional[str] = None
    alg_param_path: Optional[str] = None
    seq_path: Optional[str] = None
    seq_pair_path: Optional[str] = None
    res_path: Optional[str] = None
    subst_name: Optional[str] = None
    gapo_cost: Optional[int] = None
    gape_cost: Optional[int] = None
    align_kind: Optional[str] = None
    alg_names: Optional[List[str]] = None
    ref_alg_name: Optional[str] = None
    warmup_per_align: Optional[int] = None
    samples_per_align: Optional[int] = None
    f_calc_trace: Optional[bool] = None
    f_calc_score_hash: Optional[bool] = None
    f_write_progress: Optional[bool] = None
    debug_path: Optional[str] = None
    f_print_score: Optional[bool] = None
    f_print_trace: Optional[bool] = None
    profile_dir: Optional[str] = None
    iso_datetime: str = ""


@dataclasses.dataclass
class CmdData:
    subst_data: object = None
    alg_params: Dict[str, Dict[str, List[int]]] = None
    seq_data: object = None
    pair_list: list = None
    res_ofs: TextIO = None
    debug_ofs: Optional[TextIO] = None


def _err(msg: str) -> Status:
    print(f"error: {msg}", file=sys.stderr)
    return Status.errorInvalidValue


def parse_cmd_args(argv: List[str], cmd_args: CmdArgs) -> Status:
    cmd_args.iso_datetime = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")

    if not argv:
        print(USAGE)
        return _err("expected command parameters")

    def take_str(i: int, cur, name: str):
        if cur is not None:
            return None, _err(f'parameter already set: "{name}"')
        if i + 1 >= len(argv):
            return None, _err(f'expected parameter value: "{name}"')
        return argv[i + 1], Status.success

    def take_int(i: int, cur, name: str):
        v, stat = take_str(i, cur, name)
        if stat != Status.success:
            return None, stat
        try:
            return int(v), Status.success
        except ValueError:
            return None, _err(f'parameter value should be int: "{name}"')

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-b", "--substPath"):
            cmd_args.subst_path, stat = take_str(i, cmd_args.subst_path, arg)
            i += 1
        elif arg in ("-r", "--algParamPath"):
            cmd_args.alg_param_path, stat = take_str(i, cmd_args.alg_param_path, arg)
            i += 1
        elif arg in ("-s", "--seqPath"):
            cmd_args.seq_path, stat = take_str(i, cmd_args.seq_path, arg)
            i += 1
        elif arg in ("-p", "--seqPairPath"):
            cmd_args.seq_pair_path, stat = take_str(i, cmd_args.seq_pair_path, arg)
            i += 1
        elif arg in ("-o", "--resPath"):
            cmd_args.res_path, stat = take_str(i, cmd_args.res_path, arg)
            i += 1
        elif arg == "--substName":
            cmd_args.subst_name, stat = take_str(i, cmd_args.subst_name, arg)
            i += 1
        elif arg == "--gapoCost":
            cmd_args.gapo_cost, stat = take_int(i, cmd_args.gapo_cost, arg)
            i += 1
        elif arg == "--gapeCost":
            cmd_args.gape_cost, stat = take_int(i, cmd_args.gape_cost, arg)
            i += 1
        elif arg == "--algKind":
            cmd_args.align_kind, stat = take_str(i, cmd_args.align_kind, arg)
            i += 1
        elif arg == "--algName":
            v, stat = take_str(i, None, arg)
            if stat == Status.success:
                cmd_args.alg_names = (cmd_args.alg_names or []) + [v]
            i += 1
        elif arg == "--refAlgName":
            cmd_args.ref_alg_name, stat = take_str(i, cmd_args.ref_alg_name, arg)
            i += 1
        elif arg == "--warmupPerAlign":
            cmd_args.warmup_per_align, stat = take_int(
                i, cmd_args.warmup_per_align, arg
            )
            if stat == Status.success and cmd_args.warmup_per_align < 0:
                stat = _err(f'parameter must be nonnegative integer: "{arg}"')
            i += 1
        elif arg == "--samplesPerAlign":
            cmd_args.samples_per_align, stat = take_int(
                i, cmd_args.samples_per_align, arg
            )
            if stat == Status.success and cmd_args.samples_per_align <= 0:
                stat = _err(f'parameter must be positive integer: "{arg}"')
            i += 1
        elif arg == "--fCalcTrace":
            stat = (
                _err(f'parameter already set: "{arg}"')
                if cmd_args.f_calc_trace is not None
                else Status.success
            )
            cmd_args.f_calc_trace = True
        elif arg == "--fCalcScoreHash":
            stat = (
                _err(f'parameter already set: "{arg}"')
                if cmd_args.f_calc_score_hash is not None
                else Status.success
            )
            cmd_args.f_calc_score_hash = True
        elif arg == "--fWriteProgress":
            stat = (
                _err(f'parameter already set: "{arg}"')
                if cmd_args.f_write_progress is not None
                else Status.success
            )
            cmd_args.f_write_progress = True
        elif arg == "--debugPath":
            cmd_args.debug_path, stat = take_str(i, cmd_args.debug_path, arg)
            i += 1
        elif arg == "--fPrintScore":
            stat = (
                _err(f'parameter already set: "{arg}"')
                if cmd_args.f_print_score is not None
                else Status.success
            )
            cmd_args.f_print_score = True
        elif arg == "--fPrintTrace":
            stat = (
                _err(f'parameter already set: "{arg}"')
                if cmd_args.f_print_trace is not None
                else Status.success
            )
            cmd_args.f_print_trace = True
        elif arg == "--profileDir":
            cmd_args.profile_dir, stat = take_str(
                i, cmd_args.profile_dir, arg
            )
            i += 1
        elif arg in ("-h", "--help"):
            print(USAGE)
            return Status.helpMenuRequested
        else:
            print(USAGE)
            print()
            return _err(f'unknown parameter: "{arg}"')
        if stat != Status.success:
            return stat
        i += 1

    if cmd_args.alg_param_path is None:
        return _err('expected parameter: "--algParamPath"')
    if cmd_args.seq_path is None:
        return _err('expected parameter: "--seqPath"')

    if (cmd_args.f_print_score or cmd_args.f_print_trace) and not cmd_args.debug_path:
        cmd_args.debug_path = f"./logs/{cmd_args.iso_datetime}_debug.txt"

    # Defaults (ref: src/cmd_parser.cpp:289-311).
    cmd_args.subst_path = cmd_args.subst_path or "./resrc/subst.json"
    cmd_args.seq_pair_path = cmd_args.seq_pair_path or ""
    cmd_args.res_path = cmd_args.res_path or f"./logs/{cmd_args.iso_datetime}.tsv"
    cmd_args.subst_name = cmd_args.subst_name or "blosum62"
    cmd_args.gapo_cost = -11 if cmd_args.gapo_cost is None else cmd_args.gapo_cost
    cmd_args.gape_cost = 0 if cmd_args.gape_cost is None else cmd_args.gape_cost
    cmd_args.align_kind = cmd_args.align_kind or "nw_lg"
    cmd_args.warmup_per_align = cmd_args.warmup_per_align or 0
    cmd_args.samples_per_align = cmd_args.samples_per_align or 1
    cmd_args.f_calc_trace = bool(cmd_args.f_calc_trace)
    cmd_args.f_calc_score_hash = bool(cmd_args.f_calc_score_hash)
    cmd_args.f_write_progress = bool(cmd_args.f_write_progress)
    cmd_args.debug_path = cmd_args.debug_path or ""
    cmd_args.f_print_score = bool(cmd_args.f_print_score)
    cmd_args.f_print_trace = bool(cmd_args.f_print_trace)

    if cmd_args.align_kind not in ("nw_lg", "nw_ag", "sw_lg", "sw_ag"):
        return _err(f'unknown algKind: "{cmd_args.align_kind}"')

    return Status.success


def init_cmd_data(cmd_args: CmdArgs, cmd_data: CmdData) -> Status:
    try:
        cmd_data.subst_data = parse_subst_file(cmd_args.subst_path)
    except (OSError, KeyError, ValueError) as e:
        print(
            f'error: could not open/parse json from substPath: '
            f'"{cmd_args.subst_path}"\n{e}',
            file=sys.stderr,
        )
        return getattr(e, "stat", Status.errorIoStream)

    try:
        cmd_data.alg_params = parse_alg_params_file(cmd_args.alg_param_path)
    except (OSError, ValueError) as e:
        print(
            f'error: could not open/parse json from algParamPath: '
            f'"{cmd_args.alg_param_path}"\n{e}',
            file=sys.stderr,
        )
        return Status.errorIoStream

    # Verify algorithm names (ref: src/cmd_parser.cpp:370-424).
    alg_map = get_algorithm_map()
    provided = list(cmd_data.alg_params.keys())
    for name in provided:
        if name not in alg_map:
            return _err(f'unknown algorithm in algParam file: "{name}"')
    if cmd_args.alg_names:
        for name in cmd_args.alg_names:
            if name not in alg_map:
                return _err(f'unknown algorithm on command line: "{name}"')
            if name not in provided:
                return _err(
                    f'selected algorithm not present in algParam file: "{name}"'
                )
    else:
        cmd_args.alg_names = provided
    if cmd_args.ref_alg_name:
        if cmd_args.ref_alg_name not in alg_map:
            return _err(
                f'unknown referent algorithm on command line: '
                f'"{cmd_args.ref_alg_name}"'
            )
        if cmd_args.ref_alg_name not in cmd_args.alg_names:
            return _err(
                "selected referent algorithm not present in algParam file: "
                f'"{cmd_args.ref_alg_name}"'
            )
    else:
        cmd_args.ref_alg_name = cmd_args.alg_names[0]

    try:
        cmd_data.seq_data = parse_seq_file(
            cmd_args.seq_path, cmd_data.subst_data.letter_map
        )
    except OSError:
        print(
            f'error: could not open fasta file from seqPath: "{cmd_args.seq_path}"',
            file=sys.stderr,
        )
        return Status.errorIoStream
    except FormatError as e:
        print(
            f'error: invalid fasta format on seqPath: "{cmd_args.seq_path}"\n{e}',
            file=sys.stderr,
        )
        return e.stat

    try:
        if cmd_args.seq_pair_path:
            cmd_data.pair_list = parse_seq_pair_file(
                cmd_args.seq_pair_path, cmd_data.seq_data.seq_map
            )
        else:
            cmd_data.pair_list = default_pairs(cmd_data.seq_data.seq_map)
    except OSError:
        print(
            f'error: could not open text file from seqPairPath: '
            f'"{cmd_args.seq_pair_path}"',
            file=sys.stderr,
        )
        return Status.errorIoStream
    except FormatError as e:
        print(
            f'error: invalid text format on seqPairPath: '
            f'"{cmd_args.seq_pair_path}"\n{e}',
            file=sys.stderr,
        )
        return e.stat
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return Status.errorInvalidFormat

    try:
        os.makedirs(os.path.dirname(cmd_args.res_path) or ".", exist_ok=True)
        cmd_data.res_ofs = open(cmd_args.res_path, "w", encoding="utf-8")
    except OSError:
        return _err(f'could not open resPath: "{cmd_args.res_path}"')

    if cmd_args.debug_path:
        try:
            os.makedirs(
                os.path.dirname(cmd_args.debug_path) or ".", exist_ok=True
            )
            cmd_data.debug_ofs = open(cmd_args.debug_path, "w", encoding="utf-8")
        except OSError:
            return _err(f'could not open debugPath: "{cmd_args.debug_path}"')

    return Status.success


def _profile(profile_dir: str, dev: torch.device):
    """torch.profiler over the whole benchmark; the Chrome trace is
    written to ``profile_dir/trace.json`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(
        activities=acts,
        on_trace_ready=lambda p: p.export_chrome_trace(
            os.path.join(profile_dir, "trace.json")),
    )


def main(argv: Optional[List[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> int:
    """(ref: src/main.cpp:4-27) ``device`` None means the CUDA card; a
    missing card raises RuntimeError rather than running on the CPU."""
    argv = sys.argv[1:] if argv is None else argv
    cmd_args = CmdArgs()

    stat = parse_cmd_args(argv, cmd_args)
    if stat == Status.helpMenuRequested:
        return 0
    if stat != Status.success:
        return -1
    dev = resolve_device(device)

    cmd_data = CmdData()
    stat = init_cmd_data(cmd_args, cmd_data)
    if stat != Status.success:
        return -1

    bench_data = BenchmarkData()
    profile_cm = contextlib.nullcontext()
    if cmd_args.profile_dir:
        profile_cm = _profile(cmd_args.profile_dir, dev)
    try:
        with profile_cm:
            stat = benchmark_algs(cmd_args, cmd_data, bench_data, dev)
    finally:
        if cmd_data.res_ofs:
            cmd_data.res_ofs.close()
        if cmd_data.debug_ofs:
            cmd_data.debug_ofs.close()
    if stat != Status.success:
        return -1
    return 0
