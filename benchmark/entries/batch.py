"""The batch engine: one ``align_pairs_batched`` call a request.

The engine buckets the request's pairs by padded shape (``quantum``),
stacks each bucket and sends it to the batched fill or the tiny-pair fill,
and returns every pair's cost and SW best cell in input order, after a
synchronise of the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.parallel import align_pairs_batched


class Entry:
    def __init__(self, config: Dict, traffic: Dict, pool: List, subst:
                 np.ndarray, device: str) -> None:
        self._spec = AlignSpec.from_name(config["algorithm"])
        self._subst = subst
        self._gaps = (config["gapo"], config["gape"])
        quantum = traffic["entry"]["quantum"]
        self._quantum = quantum if quantum == "pow2" else int(quantum)
        self._pool = pool
        self._device = device

    def call(self, k: int) -> Tuple[np.ndarray, Dict[str, float]]:
        """Request ``k`` of the pool: its (n, 3) [cost, best_i, best_j]
        and no laps."""
        out = align_pairs_batched(self._spec, self._subst, self._pool[k],
                                  *self._gaps, quantum=self._quantum,
                                  device=self._device)
        return np.stack([out.costs, out.best_i, out.best_j], 1), {}
