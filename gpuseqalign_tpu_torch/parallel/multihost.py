"""Multi-process batch alignment: the pair list shared out over the
processes of a ``torch.distributed`` group, the results gathered back.

Port of gpuseqalign_tpu's ``parallel/multihost.py``. Each process aligns
the pairs it owns (round-robin by rank) through ``parallel/batch.py`` on
its own device, then every process receives every other's fixed-size
result block with ``all_gather``. The block is tiny ((ceil(n/P), 4)
int32), so it goes over the CPU (gloo) whatever device aligned the pairs,
and several ranks may share one card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.types import AlignSpec
from .batch import BatchResult, align_pairs_batched


def align_pairs_multihost(
    spec: AlignSpec,
    subst: np.ndarray,
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    gapo: int,
    gape: int = 0,
    quantum: "int | str" = 256,
    device: Optional[Union[str, torch.device]] = None,
) -> BatchResult:
    """Align the global pair list (identical on every process) and return
    every pair's result on every process.

    Call after ``parallel.mesh.distributed_init`` (a gloo group). A caller
    outside a group of more than one process falls through to
    ``align_pairs_batched``.
    """
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return align_pairs_batched(spec, subst, pairs, gapo, gape,
                                   quantum=quantum, device=device)

    n_proc, rank = dist.get_world_size(), dist.get_rank()
    n = len(pairs)
    my_idx = list(range(rank, n, n_proc))
    local = align_pairs_batched(spec, subst, [pairs[i] for i in my_idx],
                                gapo, gape, quantum=quantum, device=device)

    # Fixed-size block: every process owns at most ceil(n/P) pairs.
    per = -(-n // n_proc)
    block = np.zeros((per, 4), np.int32)  # [global_idx, cost, bi, bj]
    block[:, 0] = -1
    for row, gi in enumerate(my_idx):
        block[row] = (gi, local.costs[row], local.best_i[row],
                      local.best_j[row])
    gathered = [torch.empty((per, 4), dtype=torch.int32)
                for _ in range(n_proc)]
    dist.all_gather(gathered, torch.from_numpy(block))

    out = np.zeros((3, n), np.int32)
    for gi, cost, bi, bj in torch.cat(gathered).numpy():
        if gi >= 0:
            out[:, gi] = (cost, bi, bj)
    return BatchResult(out[0], out[1], out[2], n_buckets=local.n_buckets)
