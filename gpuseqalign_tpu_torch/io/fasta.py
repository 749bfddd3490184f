"""FASTA reading (ref: src/file_formats.cpp:34-239).

Replicates the reference's observable semantics:
  * letters map to ints via the substitution letter map,
  * every sequence gets a header element ``0`` PREPENDED
    (ref: src/file_formats.cpp:43-47) — the DP header row/column element,
  * interior whitespace inside sequence lines is skipped,
  * multiple sequence lines per record are concatenated,
  * empty lines anywhere are skipped,
  * duplicate ids are an error,
  * errors carry ``path:line:col`` (1-based) exactly like the reference
    (ref: src/file_formats.cpp:16-32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, TextIO

import numpy as np

from ..core.types import Status


class FormatError(ValueError):
    """Parse error carrying path:line:col context."""

    def __init__(self, message: str, path: str, line0: int, col0: int,
                 stat: Status = Status.errorInvalidFormat):
        # Lines and columns start from 1 in messages (ref: file_formats.cpp:28).
        super().__init__(f"{path}:{line0 + 1}:{col0 + 1}: {message}")
        self.stat = stat
        self.raw_message = message


@dataclasses.dataclass
class Seq:
    id: str = ""
    info: str = ""
    # int32 letters INCLUDING the prepended header 0 element.
    seq: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))


@dataclasses.dataclass
class SeqData:
    # Insertion-ordered (file order), like the reference's Dict.
    seq_map: Dict[str, Seq] = dataclasses.field(default_factory=dict)


def _first_non_ws(line: str) -> int:
    i = 0
    while i < len(line) and line[i].isspace():
        i += 1
    return i


def iter_fasta(path: str, stream: TextIO, letter_map: Dict[str, int]):
    """Streaming FASTA reader: yields ``Seq`` records one at a time.

    Identical observable semantics to ``read_fasta`` (header-0 element,
    whitespace skipping, duplicate-id and letter errors with
    ``path:line:col``), but holds only ONE sequence in memory — for
    corpora larger than host RAM the batch/throughput flows can consume
    this generator chunk-wise instead of ``parse_seq_file`` (the
    reference always loads everything up front,
    ref: src/cmd_parser.cpp:316-530).
    """
    seen: set = set()
    cur_id: Optional[str] = None
    cur_info = ""
    cur_letters: List[int] = []

    def flush() -> Optional[Seq]:
        nonlocal cur_id, cur_info, cur_letters
        out = None
        if cur_id is not None and cur_letters:
            # Header element prepended (ref: file_formats.cpp:43-47).
            arr = np.asarray([0] + cur_letters, dtype=np.int32)
            out = Seq(id=cur_id, info=cur_info, seq=arr)
        cur_id = None
        cur_info = ""
        cur_letters = []
        return out

    expect_header = True
    have_header = False

    for line0, raw in enumerate(stream):
        line = raw.rstrip("\n")
        start = _first_non_ws(line)
        if start >= len(line):
            continue  # skip empty lines

        if line[start] == ">":
            if have_header and not cur_letters:
                # Header directly after header: the reference errors in
                # readFastaSequenceLine (ref: file_formats.cpp:137).
                raise FormatError("expected sequence after header", path, line0, start)
            done = flush()
            if done is not None:
                yield done
            # Parse header: '>' [ws] id [ws info]
            rest = line[start + 1:]
            body = rest.lstrip()
            if not body:
                raise FormatError(
                    "expected sequence id after '>' symbol", path, line0, start,
                )
            parts = body.split(None, 1)
            seq_id = parts[0]
            if seq_id in seen:
                raise FormatError(
                    "duplicate sequence id", path, line0, start,
                    stat=Status.errorInvalidValue,
                )
            seen.add(seq_id)
            cur_id = seq_id
            cur_info = parts[1].rstrip() if len(parts) > 1 else ""
            have_header = True
            expect_header = False
            continue

        if expect_header:
            raise FormatError("expected sequence header (>)", path, line0, start)

        # Sequence line: map letters, skip whitespace.
        for col0 in range(start, len(line)):
            ch = line[col0]
            val = letter_map.get(ch)
            if val is None:
                if ch.isspace():
                    continue
                raise FormatError(
                    "letter not found in substitution letters", path, line0, col0,
                    stat=Status.errorInvalidValue,
                )
            cur_letters.append(val)

    done = flush()
    if done is not None:
        yield done


def read_fasta(path: str, stream: TextIO, letter_map: Dict[str, int]) -> SeqData:
    seq_data = SeqData()
    for seq in iter_fasta(path, stream, letter_map):
        seq_data.seq_map[seq.id] = seq
    return seq_data


def parse_seq_file(path: str, letter_map: Dict[str, int]) -> SeqData:
    with open(path, "r", encoding="utf-8") as f:
        return read_fasta(path, f, letter_map)


def iter_seq_file(path: str, letter_map: Dict[str, int]):
    """Streaming variant of parse_seq_file: yields Seq records."""
    with open(path, "r", encoding="utf-8") as f:
        yield from iter_fasta(path, f, letter_map)
