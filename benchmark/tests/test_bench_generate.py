"""The traffic generator: the database-search form, and the pools of the
first three cells' traffic files, byte for byte as they were before that
form was added."""

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark import generate
from conftest import ROOT

DB = {"alphabet": "ARNDCQEGHILKMFPSTWYV", "pool": 3,
      "pairs": {"query_vs_db": {"queries": [7, 12, 5],
                                "subjects": [3, 40, 1, 9, 9, 26]}}}
SEEDS = (1, 2 ** 31 + 977)
# SHA-256 of ``_digest`` of each first cell's pool at its real size, from
# the tree before ``query_vs_db`` (commit 9b6f893).
DIGESTS = {
    ("pg1", 1):
        "2bdffd78daad914e818e4c54e985c5b83e9134634010b90294348f971aa7f96c",
    ("pg1", 2 ** 31 + 977):
        "3ac86ea9878192efcccaa697a73570377e4ae07c5715a7ee87d24d5621ee9722",
    ("allvsall20", 1):
        "9de568d37830c3b1f7902944aadab240bef4a500819b5d7e9e50d1ae4d9f0744",
    ("allvsall20", 2 ** 31 + 977):
        "9308cbb9380f4d8d13bf4a5a1bcdab017291ab3ffcf4c7136c21600f0144ae97",
    ("release", 1):
        "261bc545a710fcf176f722b203778d8c65f3e34290c4ab365bd80b5eb90f80ef",
    ("release", 2 ** 31 + 977):
        "5fe9fcdf44a70394c0ac2953244bf2a994f216b648bb6416125b910d42678238",
}
CONFIGS = {"pg1": "upstream_nw_lg", "allvsall20": "blastp_sw_ag",
           "release": "upstream_nw_lg"}


def _json(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


def _digest(pool):
    h = hashlib.sha256()
    for pairs in pool:
        h.update(np.int64(len(pairs)).tobytes())
        for y, x in pairs:
            for s in (y, x):
                h.update(s.dtype.str.encode())
                h.update(np.int64(len(s)).tobytes())
                h.update(s.tobytes())
    return h.hexdigest()


CFG = _json("configs", "blastp_sw_ag.json")


def test_query_vs_db_pool():
    pool = generate.make_pool(DB, CFG, 2 ** 31 + 5)
    spec = DB["pairs"]["query_vs_db"]
    assert len(pool) == len(spec["queries"])
    subjects = [x for _, x in pool[0]]
    assert [len(x) - 1 for x in subjects] == spec["subjects"]
    for k, pairs in enumerate(pool):
        # One query, the rows, against the very subject arrays of every
        # other request, the columns, in subject order.
        assert all(x is s for (_, x), s in zip(pairs, subjects))
        assert len(pairs) == len(subjects)
        assert all(y is pairs[0][0] for y, _ in pairs)
        assert len(pairs[0][0]) - 1 == spec["queries"][k]
    for pairs in pool:
        for y, x in pairs:
            assert y.dtype == x.dtype == np.int32
            assert y[0] == 0 and x[0] == 0


def test_query_vs_db_lengths_stay_residues_move():
    a, b, c = (generate.make_pool(DB, CFG, s) for s in (3, 3, 2 ** 40 + 3))
    seqs = lambda pool: [s for pairs in pool for p in pairs for s in p]
    assert all((u == v).all() for u, v in zip(seqs(a), seqs(b)))
    assert [len(s) for s in seqs(a)] == [len(s) for s in seqs(c)]
    assert any((u != v).any() for u, v in zip(seqs(a), seqs(c)))


@pytest.mark.parametrize("pool", [2, 4])
def test_query_vs_db_pool_must_match_the_queries(pool):
    with pytest.raises(ValueError, match="one request a query"):
        generate.make_pool(dict(DB, pool=pool), CFG, 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("traffic", ["pg1", "allvsall20", "release"])
def test_the_first_cells_pools_are_unchanged(traffic, seed):
    pool = generate.make_pool(_json("traffic", f"{traffic}.json"),
                              _json("configs", f"{CONFIGS[traffic]}.json"),
                              seed)
    assert _digest(pool) == DIGESTS[traffic, seed]
