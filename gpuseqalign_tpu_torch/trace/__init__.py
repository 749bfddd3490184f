from .plain import trace_plain, hash_plain, print_score_plain, print_trace_plain
from .sparse import (
    trace_sparse,
    hash_sparse,
    print_score_sparse,
    get_tile_and_elem_ij,
    align_tile,
)

__all__ = [
    "trace_plain",
    "hash_plain",
    "print_score_plain",
    "print_trace_plain",
    "trace_sparse",
    "hash_sparse",
    "print_score_sparse",
    "get_tile_and_elem_ij",
    "align_tile",
]
