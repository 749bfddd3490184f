"""Multi-pair and multi-device engines: the batch engine (``batch.py``;
over a mesh of devices, or over processes in ``multihost.py``), the
database search against subjects kept on one device (``dbsearch.py``) and
the giant-pair engines (``giant2.py``, the banded kernel, over a mesh that
may span processes; ``giant.py``, the portable NW linear-gap form)."""

from ..ops.batch_plain import scores_batch_plain
from .batch import BatchResult, align_pairs_batched, bucket_pairs
from .dbsearch import SubjectDB, load_db, search_db
from .giant import align_giant_mlsp, giant_mlsp_nw_lg
from .giant2 import (
    FillPlan,
    align_giant2,
    align_giant2_nw_lg,
    align_giant2_stream,
    call_model_steps,
    fill_plan,
    giant2_fill,
    pick_call_passes,
    schedule,
)
from .mesh import Mesh, distributed_init, make_mesh
from .multihost import align_pairs_multihost

__all__ = [
    "BatchResult",
    "FillPlan",
    "Mesh",
    "SubjectDB",
    "align_giant2",
    "align_giant2_nw_lg",
    "align_giant2_stream",
    "align_giant_mlsp",
    "align_pairs_batched",
    "align_pairs_multihost",
    "bucket_pairs",
    "call_model_steps",
    "distributed_init",
    "fill_plan",
    "giant2_fill",
    "giant_mlsp_nw_lg",
    "load_db",
    "make_mesh",
    "pick_call_passes",
    "schedule",
    "scores_batch_plain",
    "search_db",
]
