from .types import (
    Status,
    Range,
    AlignSpec,
    AlgParams,
    AlgInput,
    AlgResult,
    SeqPair,
    default_range,
    make_alg_input,
)
from .hashing import djb2_init, djb2_ints, djb2_str, DJB2_SEED
from .transcript import rle_append, rle_finish, EditRun
from .registry import Algorithm, get_algorithm_map

__all__ = [
    "Status",
    "Range",
    "AlignSpec",
    "AlgParams",
    "AlgInput",
    "AlgResult",
    "SeqPair",
    "default_range",
    "make_alg_input",
    "djb2_init",
    "djb2_ints",
    "djb2_str",
    "DJB2_SEED",
    "rle_append",
    "rle_finish",
    "EditRun",
    "Algorithm",
    "get_algorithm_map",
]
