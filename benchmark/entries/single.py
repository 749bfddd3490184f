"""One registry algorithm's align, one pair at a time, as the CLI calls it.

Each request's pairs go through ``get_algorithm_map()[name].align`` with
the default parameters (the port picks its tile), one ``AlgInput`` a pair
made at set-up and reset after each call as the CLI's driver does; no
score hash and no traceback. The align's own stopwatch laps
(``align.alloc``, ``align.cpy_dev``, ``align.calc``, ``align.cpy_host``)
come back with the answer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from gpuseqalign_tpu_torch.core.registry import get_algorithm_map
from gpuseqalign_tpu_torch.core.types import (AlgParams, AlgResult, Status,
                                              make_alg_input)


class Entry:
    def __init__(self, config: Dict, traffic: Dict, pool: List, subst:
                 np.ndarray, device: str) -> None:
        self._alg = get_algorithm_map()[traffic["entry"]["algorithm"]]
        self._inputs = [
            [make_alg_input(subst, y, x, config["gapo"], config["gape"],
                            config["algorithm"], device=device)
             for y, x in pairs]
            for pairs in pool]

    def call(self, k: int) -> Tuple[Optional[np.ndarray], Dict[str, float]]:
        """Request ``k``: its (n, 3) [cost, best_i, best_j] (None when an
        align returns another status than success) and the summed laps."""
        answers, laps = [], {}
        for nw in self._inputs[k]:
            res = AlgResult()
            stat = self._alg.align(AlgParams({}), nw, res)
            for name, ms in res.sw_align.laps().items():
                laps[name] = laps.get(name, 0.0) + ms
            answers.append((res.align_cost, nw.best_i, nw.best_j))
            nw.reset_cycle()
            if stat != Status.success:
                return None, laps
        return np.array(answers, np.int64), laps
