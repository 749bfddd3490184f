"""TSV result writer, schema-compatible with the reference
(ref: src/file_formats.cpp:401-524, column list at :467-520).

Column names and order follow the reference binary so existing downstream
tooling — including positional parsers — keeps working; ``cuda_stat`` is
retained as the device status column (always 0),
``sm_count`` carries the card's SM count (the host CPU count on the
CPU), and the five peak-memory columns map to host RAM / device memory /
shared memory / 0 / 0. Three extension columns (no
reference analog — the reference is NW-linear-only and records no
exception text) are APPENDED after the last reference column so every
reference column keeps its reference position under any flag set:
``gape_cost``, ``align_kind``, ``error_msg``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TextIO

from ..core.types import AlgResult


@dataclasses.dataclass
class TsvPrintCtl:
    """(ref: src/file_formats.hpp:153-163)"""

    write_col_name: bool = False
    write_value: bool = False
    f_print_score_stats: bool = False
    f_print_trace_stats: bool = False


def _fields(res: AlgResult, ctl: TsvPrintCtl):
    """Yield (name, formatted-value) in reference column order."""
    yield "alg_name", res.alg_name
    yield "seqY_idx", str(res.seqY_idx)
    yield "seqX_idx", str(res.seqX_idx)
    yield "seqY_id", res.seqY_id + res.seqY_range.id_suffix()
    yield "seqX_id", res.seqX_id + res.seqX_range.id_suffix()

    yield "seqY_len", str(res.seqY_len)
    yield "seqX_len", str(res.seqX_len)
    yield "subst_name", res.subst_name
    yield "gapo_cost", str(res.gapo_cost)
    yield "warmup_runs", str(res.warmup_runs)
    yield "sample_runs", str(res.sample_runs)
    yield "last_run_idx", str(res.last_run_idx)

    # Compact JSON like nlohmann's dump() (no spaces).
    yield "alg_params", json.dumps(res.alg_params, separators=(",", ":"))

    yield "err_step", str(res.errstep)
    yield "nw_stat", str(int(res.stat))
    yield "cuda_stat", str(int(res.device_stat))

    yield "align_cost", str(res.align_cost)
    if ctl.f_print_score_stats:
        yield "score_hash", f"{res.score_hash & 0xFFFFFFFF:08x}"
    if ctl.f_print_trace_stats:
        yield "trace_hash", f"{res.trace_hash & 0xFFFFFFFF:08x}"

    yield "sm_count", str(res.core_count)
    yield "ram_peak_allocs", str(res.ram_peak_allocs)
    yield "glmem_peak_allocs", str(res.glmem_peak_allocs)
    yield "shmem_peak_allocs", str(res.shmem_peak_allocs)
    yield "locmem_peak_allocs", str(res.locmem_peak_allocs)
    yield "regmem_peak_allocs", str(res.regmem_peak_allocs)

    def ms(sw, name):
        return f"{sw.get_or_default(name):.4f}"

    yield "align.alloc", ms(res.sw_align, "align.alloc")
    yield "align.cpy_dev", ms(res.sw_align, "align.cpy_dev")
    yield "align.init_hdr", ms(res.sw_align, "align.init_hdr")
    yield "align.calc_init", ms(res.sw_align, "align.calc_init")
    yield "align.calc", ms(res.sw_align, "align.calc")
    yield "align.cpy_host", ms(res.sw_align, "align.cpy_host")
    if ctl.f_print_score_stats:
        yield "hash.calc", ms(res.sw_hash, "hash.calc")
    if ctl.f_print_trace_stats:
        yield "trace.alloc", ms(res.sw_trace, "trace.alloc")
        yield "trace.calc", ms(res.sw_trace, "trace.calc")
        yield "edit_trace", res.edit_trace

    # Extension columns (not in the reference schema — it only supports
    # NW linear-gap and records no exception text), appended LAST so the
    # reference columns keep their positions: the affine extend cost,
    # the align-kind name, and the exception class/message of a failed
    # step (the reference records only the raw cudaError_t code).
    yield "gape_cost", str(res.gape_cost)
    yield "align_kind", res.align_kind
    yield "error_msg", res.error_msg.replace("\t", " ").replace("\n", " ")


def write_result_to_tsv(os: TextIO, res: AlgResult, ctl: TsvPrintCtl) -> None:
    if ctl.write_col_name == ctl.write_value:
        raise ValueError("exactly one of write_col_name/write_value must be set")
    cells = []
    for name, value in _fields(res, ctl):
        cells.append(name if ctl.write_col_name else value)
    os.write("\t".join(cells))
    os.write("\n")
