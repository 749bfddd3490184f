"""Algorithm-parameter file parsing (ref: src/cmd_parser.cpp:357-368).

The file maps algorithm name -> { param name -> list of int values }.
Every parameter is a LIST; the benchmark iterates the Cartesian product as
an odometer (ref: src/run_types.cpp:69-83). JSON key order is preserved
(algorithm run order, odometer significance order).
"""

from __future__ import annotations

from typing import Dict, List

from .jsonc import read_jsonc_file


def parse_alg_params_file(path: str) -> Dict[str, Dict[str, List[int]]]:
    raw = read_jsonc_file(path)
    out: Dict[str, Dict[str, List[int]]] = {}
    for alg_name, params in raw.items():
        if not isinstance(params, dict):
            raise ValueError(f'algorithm parameters must be an object: "{alg_name}"')
        out[alg_name] = {}
        for pname, values in params.items():
            # Non-empty: an empty list would make the AlgParams odometer
            # have no current combination (at()/copy_current IndexError
            # deep inside the benchmark loop).
            if not isinstance(values, list) or not values or not all(
                isinstance(v, int) for v in values
            ):
                raise ValueError(
                    "parameter values must be a non-empty list of ints: "
                    f'"{alg_name}.{pname}"'
                )
            out[alg_name][pname] = list(values)
    return out
