"""Algorithm registry (ref: src/nw_algorithm.{hpp,cpp}).

Each algorithm bundles five strategy functions — align / trace / hash /
print_score / print_trace (ref: src/nw_algorithm.hpp:8-40). The map is
insertion-ordered; reference algorithm names are registered as ALIASES
under the same names as in gpuseqalign_tpu, so the reference's parameter
files (resrc/param_best.json, resrc/param_optimize.json) keep working.

Alias mapping (reference -> this port):
  NwAlign_Cpu1_St_Row        -> cpu1_st_row        (host oracle, row sweep)
  NwAlign_Cpu2_St_Diag       -> cpu2_st_diag       (host, anti-diagonal order)
  NwAlign_Cpu3_St_DiagRow    -> cpu3_st_diagrow    (host, tiled)
  NwAlign_Cpu4_Mt_DiagRow    -> cpu4_mt_diagrow    (host, tiled + OpenMP)
  NwAlign_Gpu1_Ml_Diag       -> tpu1_xla_diag      (anti-diagonal scan, torch
                                    ops on the device)
  NwAlign_Gpu2_Ml_DiagRow2Pass -> tpu2_xla_rowscan (row max-plus scan, torch
                                    ops on the device)
  NwAlign_Gpu3_Ml_DiagDiag   -> tpu3_pallas_dense  (dense H: the CUDA
                                    tile-diagonal kernel on the card)
  NwAlign_Gpu4_Ml_DiagDiag2Pass -> tpu3_pallas_dense
  NwAlign_Gpu5_Coop_DiagDiag -> tpu3_pallas_dense
  NwAlign_Gpu6_Coop_DiagDiag2Pass -> tpu3_pallas_dense
  NwAlign_Gpu7_Mlsp_DiagDiag -> tpu7_pallas_mlsp   (sparse tile headers: the
                                    CUDA tile-diagonal kernel on the card)
  NwAlign_Gpu8_Mlsp_DiagDiag -> tpu7_pallas_mlsp
  NwAlign_Gpu9_Mlsp_DiagDiagDiag -> tpu7_pallas_mlsp

Beside them, with no reference name, ``tpu9_giant_mlsp``: the giant-pair
engine (``parallel/giant2.align_giant2``), one pair's columns in a band
on the input's own device (more bands, with a halo between neighbours,
take an explicit mesh), filled by the CUDA banded kernel (its plain
version on the CPU), every spec on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, TextIO

from .types import AlgInput, AlgParams, AlgResult, Status

AlignFn = Callable[[AlgParams, AlgInput, AlgResult], Status]
TraceFn = Callable[[AlgInput, AlgResult, bool], Status]
HashFn = Callable[[AlgInput, AlgResult], Status]
PrintFn = Callable[[TextIO, AlgInput, AlgResult], Status]


@dataclasses.dataclass
class Algorithm:
    align: AlignFn
    trace: TraceFn
    hash: HashFn
    print_score: PrintFn
    print_trace: PrintFn


def get_algorithm_map() -> Dict[str, Algorithm]:
    """Build the name -> Algorithm map (insertion-ordered)."""
    from ..models import cpu_algs
    from ..ops import dense_kernels, mlsp_kernels
    from ..parallel import giant2
    from ..trace import plain, sparse

    def dense(align_fn: AlignFn) -> Algorithm:
        return Algorithm(
            align=align_fn,
            trace=plain.trace_plain,
            hash=plain.hash_plain,
            print_score=plain.print_score_plain,
            print_trace=plain.print_trace_plain,
        )

    def mlsp(align_fn: AlignFn) -> Algorithm:
        return Algorithm(
            align=align_fn,
            trace=sparse.trace_sparse,
            hash=sparse.hash_sparse,
            print_score=sparse.print_score_sparse,
            print_trace=plain.print_trace_plain,
        )

    algs: Dict[str, Algorithm] = {}

    # Host oracles.
    algs["cpu1_st_row"] = dense(cpu_algs.align_cpu1_st_row)
    algs["cpu2_st_diag"] = dense(cpu_algs.align_cpu2_st_diag)
    algs["cpu3_st_diagrow"] = dense(cpu_algs.align_cpu3_st_diagrow)
    algs["cpu4_mt_diagrow"] = dense(cpu_algs.align_cpu4_mt_diagrow)

    # Device fills (names kept from gpuseqalign_tpu for parameter files).
    algs["tpu1_xla_diag"] = dense(dense_kernels.align_xla_diag)
    algs["tpu2_xla_rowscan"] = dense(dense_kernels.align_xla_rowscan)
    algs["tpu3_pallas_dense"] = dense(dense_kernels.align_dense)
    algs["tpu7_pallas_mlsp"] = mlsp(mlsp_kernels.align_mlsp)

    # Giant-pair engine (an extension; the reference is single-GPU). The
    # JAX package takes its banded kernel on a TPU and the portable XLA
    # engine elsewhere; here every device takes the banded kernel.
    algs["tpu9_giant_mlsp"] = mlsp(giant2.align_giant2)

    # Reference-name aliases (same objects).
    aliases = {
        "NwAlign_Cpu1_St_Row": "cpu1_st_row",
        "NwAlign_Cpu2_St_Diag": "cpu2_st_diag",
        "NwAlign_Cpu3_St_DiagRow": "cpu3_st_diagrow",
        "NwAlign_Cpu4_Mt_DiagRow": "cpu4_mt_diagrow",
        "NwAlign_Gpu1_Ml_Diag": "tpu1_xla_diag",
        "NwAlign_Gpu2_Ml_DiagRow2Pass": "tpu2_xla_rowscan",
        "NwAlign_Gpu3_Ml_DiagDiag": "tpu3_pallas_dense",
        "NwAlign_Gpu4_Ml_DiagDiag2Pass": "tpu3_pallas_dense",
        "NwAlign_Gpu5_Coop_DiagDiag": "tpu3_pallas_dense",
        "NwAlign_Gpu6_Coop_DiagDiag2Pass": "tpu3_pallas_dense",
        "NwAlign_Gpu7_Mlsp_DiagDiag": "tpu7_pallas_mlsp",
        "NwAlign_Gpu8_Mlsp_DiagDiag": "tpu7_pallas_mlsp",
        "NwAlign_Gpu9_Mlsp_DiagDiagDiag": "tpu7_pallas_mlsp",
    }
    for ref_name, our_name in aliases.items():
        algs[ref_name] = algs[our_name]

    return algs
