"""Multi-pair and multi-device engines: the batch engine (``batch.py``;
over a mesh of devices, or over processes in ``multihost.py``) and the
giant-pair engines (``giant2.py``, the banded kernel; ``giant.py``, the
portable NW linear-gap form)."""

from ..ops.batch_plain import scores_batch_plain
from .batch import BatchResult, align_pairs_batched, bucket_pairs
from .giant import align_giant_mlsp, giant_mlsp_nw_lg
from .giant2 import (
    align_giant2,
    align_giant2_nw_lg,
    align_giant2_stream,
    giant2_fill,
)
from .mesh import Mesh, distributed_init, make_mesh
from .multihost import align_pairs_multihost

__all__ = [
    "BatchResult",
    "Mesh",
    "align_giant2",
    "align_giant2_nw_lg",
    "align_giant2_stream",
    "align_giant_mlsp",
    "align_pairs_batched",
    "align_pairs_multihost",
    "bucket_pairs",
    "distributed_init",
    "giant2_fill",
    "giant_mlsp_nw_lg",
    "make_mesh",
    "scores_batch_plain",
]
