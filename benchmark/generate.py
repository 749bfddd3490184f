"""The one traffic generator: a pool of requests from a traffic file and a seed.

A traffic file (``traffic/<name>.json``) gives the pairs of one request
and how many distinct requests the pool holds:

- ``{"all_vs_all": [L1, L2, ...]}``: one sequence of each length, and
  every pair (i, j) with i <= j of them, in that order (a sequence is
  aligned with itself too, as in upstream's pair files);
- ``{"list": [[Ly, Lx], ...]}``: each pair's two sequences drawn apart.

Residues are uniform over the traffic's ``alphabet``, mapped to the
configuration's letter indices. Every seed gives the same lengths in the
same order; only the residues change. Each sequence carries the header
element 0 in front, as the port and upstream take it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]


def shapes(traffic: Dict) -> List[Tuple[int, int]]:
    """(rows, cols) of every pair of one request, in order."""
    spec = traffic["pairs"]
    if "all_vs_all" in spec:
        lens = spec["all_vs_all"]
        return [(lens[i], lens[j]) for i in range(len(lens))
                for j in range(i, len(lens))]
    return [(int(a), int(b)) for a, b in spec["list"]]


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
    pool = []
    for _ in range(int(traffic["pool"])):
        if "all_vs_all" in spec:
            seqs = [_draw(rng, letters, n) for n in spec["all_vs_all"]]
            pairs = [(seqs[i], seqs[j]) for i in range(len(seqs))
                     for j in range(i, len(seqs))]
        else:
            pairs = [(_draw(rng, letters, a), _draw(rng, letters, b))
                     for a, b in spec["list"]]
        pool.append(pairs)
    return pool
