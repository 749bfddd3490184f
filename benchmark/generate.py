"""The one traffic generator: a pool of requests from a traffic file and a seed.

A traffic file (``traffic/<name>.json``) gives the pairs of one request
and how many distinct requests the pool holds:

- ``{"all_vs_all": [L1, L2, ...]}``: one sequence of each length, and
  every pair (i, j) with i <= j of them, in that order (a sequence is
  aligned with itself too, as in upstream's pair files);
- ``{"list": [[Ly, Lx], ...]}``: each pair's two sequences drawn apart;
- ``{"query_vs_db": {"queries": [Lq, ...], "subjects": [Ls, ...]}}``: a
  database search. The subjects are drawn once and every request shares
  those same arrays; request k aligns query ``queries[k]`` (the rows, y)
  with every subject (the columns, x), in subject order. The pool holds
  one request a query.

A traffic file may also hold ``"tiny": {"pairs": {...}, "pool": n}``, in
any of these forms: the cell's tiny twin, which the benchmark's own tests
run on the CPU (``tests/conftest.py``); a run never reads it.

Residues are uniform over the traffic's ``alphabet``, mapped to the
configuration's letter indices. Every seed gives the same lengths in the
same order; only the residues change. Each sequence carries the header
element 0 in front, as the port and upstream take it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]


def _letters(traffic: Dict, config: Dict) -> np.ndarray:
    index = {c: k for k, c in enumerate(config["letters"])}
    return np.array([index[c] for c in traffic["alphabet"]], np.int32)


def _draw(rng: np.random.Generator, letters: np.ndarray, n: int
          ) -> np.ndarray:
    seq = np.zeros(1 + n, np.int32)
    seq[1:] = letters[rng.integers(0, len(letters), n)]
    return seq


def make_pool(traffic: Dict, config: Dict, seed: int) -> List[List[Pair]]:
    """``traffic["pool"]`` requests, each a list of (y, x) pairs."""
    rng = np.random.default_rng(seed % 2 ** 64)
    letters = _letters(traffic, config)
    spec = traffic["pairs"]
    n_pool = int(traffic["pool"])
    if "query_vs_db" in spec:
        queries = spec["query_vs_db"]["queries"]
        if n_pool != len(queries):
            raise ValueError(f"pool {n_pool} != {len(queries)} queries: "
                             "a database search holds one request a query")
        subjects = [_draw(rng, letters, n)
                    for n in spec["query_vs_db"]["subjects"]]
        return [[(query, s) for s in subjects]
                for query in (_draw(rng, letters, n) for n in queries)]
    pool = []
    for _ in range(n_pool):
        if "all_vs_all" in spec:
            seqs = [_draw(rng, letters, n) for n in spec["all_vs_all"]]
            pairs = [(seqs[i], seqs[j]) for i in range(len(seqs))
                     for j in range(i, len(seqs))]
        else:
            pairs = [(_draw(rng, letters, a), _draw(rng, letters, b))
                     for a, b in spec["list"]]
        pool.append(pairs)
    return pool
