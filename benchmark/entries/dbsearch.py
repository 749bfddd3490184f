"""The database search: one ``search_db`` call a request, against a
database loaded on the device once.

The pool must be the ``query_vs_db`` form: every request holds one query
against the same subject arrays, in the same order. Set-up loads those
subjects once (``load_db``: bucketed, sorted, stacked and padded on the
device), so the load counts in ``setup_s``; request k searches query k
and returns every subject's cost and SW best cell in subject order,
after one wait for the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gpuseqalign_tpu_torch.core.types import AlignSpec
from gpuseqalign_tpu_torch.parallel import load_db, search_db


class Entry:
    def __init__(self, config: Dict, traffic: Dict, pool: List, subst:
                 np.ndarray, device: str) -> None:
        subjects = [x for _, x in pool[0]]
        for k, pairs in enumerate(pool):
            if (len(pairs) != len(subjects)
                    or any(p[0] is not pairs[0][0] for p in pairs)
                    or any(p[1] is not s for p, s in zip(pairs, subjects))):
                raise ValueError(
                    f"request {k} is not one query against the subjects of "
                    "request 0: the dbsearch entry takes a query_vs_db pool")
        self._queries = [pairs[0][0] for pairs in pool]
        self._spec = AlignSpec.from_name(config["algorithm"])
        self._subst = subst
        self._gaps = (config["gapo"], config["gape"])
        if traffic["entry"]["quantum"] != "pow2":
            raise ValueError("the database is padded to powers of two: the "
                             "dbsearch entry takes quantum \"pow2\" only")
        self._db = load_db(subjects, device=device)

    def call(self, k: int) -> Tuple[np.ndarray, Dict[str, float]]:
        """Request ``k`` of the pool: its (n, 3) [cost, best_i, best_j]
        and no laps. The answers are a view of the search's own (3, n)
        block: a copy would put tens of thousands of fresh words a call,
        and their page faults, on the harness's side of the trace."""
        out = search_db(self._spec, self._subst, self._queries[k], self._db,
                        *self._gaps)
        return out.costs.base.T, {}
