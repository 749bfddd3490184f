"""Substitution-matrix file parsing (ref: src/cmd_parser.cpp:316-355).

The subst JSON file holds a ``letterMap`` (letter -> index, indices must be
contiguous from 0) and a ``substMap`` (name -> flat letters^2 int list).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .jsonc import read_jsonc_file
from ..core.types import Status


class SubstError(ValueError):
    def __init__(self, message: str, stat: Status = Status.errorInvalidFormat):
        super().__init__(message)
        self.stat = stat


@dataclasses.dataclass
class SubstData:
    letter_map: Dict[str, int]
    subst_map: Dict[str, np.ndarray]  # name -> (letters, letters) int32

    @property
    def letters(self) -> int:
        return len(self.letter_map)


def parse_subst_file(path: str) -> SubstData:
    raw = read_jsonc_file(path)
    letter_map: Dict[str, int] = raw["letterMap"]

    letter_idx = 0
    for letter, idx in letter_map.items():
        if len(letter) != 1:
            raise SubstError(
                f'substitution matrix letters must be a character: "{letter}"'
            )
        if idx != letter_idx:
            raise SubstError(
                "substitution matrix letter's index must start from zero and "
                f'increase by 1: "{letter}": {idx}'
            )
        letter_idx += 1

    letters = len(letter_map)
    subst_map: Dict[str, np.ndarray] = {}
    for name, flat in raw["substMap"].items():
        if len(flat) != letters * letters:
            raise SubstError(
                "substitution matrix must have exactly letter_cnt^2 elements: "
                f'"{name}"'
            )
        subst_map[name] = np.asarray(flat, dtype=np.int32).reshape(letters, letters)

    return SubstData(letter_map=letter_map, subst_map=subst_map)
