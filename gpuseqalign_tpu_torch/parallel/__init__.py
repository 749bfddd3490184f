"""Multi-pair engines. So far the batched pair engine on one card
(``batch.py``); the mesh-sharded and giant-pair engines come later."""

from ..ops.batch_plain import scores_batch_plain
from .batch import BatchResult, align_pairs_batched, bucket_pairs

__all__ = [
    "BatchResult",
    "align_pairs_batched",
    "bucket_pairs",
    "scores_batch_plain",
]
