from .oracle import (
    oracle_align_dense,
    oracle_align_slow,
    oracle_trace_dense,
    oracle_hash_dense,
)

__all__ = [
    "oracle_align_dense",
    "oracle_align_slow",
    "oracle_trace_dense",
    "oracle_hash_dense",
]
