"""Sequence-pair list parsing (ref: src/file_formats.cpp:241-399).

Line format: ``seqY_id seqX_id`` where each id may carry a Python-style
substring range ``id[l:r]``, ``id[l:]``, ``id[:r]``, ``id[:]`` with bounds
checked against the sequence length (header element excluded).
The shorter sequence is conventionally listed first (Y) — the mlsp kernels
assume len(X) >= len(Y) (ref: src/nwalign_gpu8_mlsp_diagdiag.cu:313).
"""

from __future__ import annotations

from typing import Dict, List, TextIO, Tuple

from ..core.types import Range, SeqPair, Status
from .fasta import FormatError, Seq


def _parse_int(s: str, pos: int) -> Tuple[int, int]:
    """Parse an optionally-signed integer starting at pos; returns (value, next_pos)."""
    start = pos
    if pos < len(s) and s[pos] in "+-":
        pos += 1
    while pos < len(s) and s[pos].isdigit():
        pos += 1
    if pos == start or (pos == start + 1 and s[start] in "+-"):
        raise ValueError("no digits")
    return int(s[start:pos]), pos


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos].isspace():
        pos += 1
    return pos


def _read_id_and_range(
    line: str, pos: int, path: str, line0: int, seq_map: Dict[str, Seq]
) -> Tuple[str, Range, int]:
    pos = _skip_ws(line, pos)
    col0 = pos

    # Consume id until whitespace or '['.
    idend = pos
    while idend < len(line) and not line[idend].isspace() and line[idend] != "[":
        idend += 1
    seq_id = line[pos:idend]
    if not seq_id:
        raise FormatError("expected sequence id", path, line0, col0)
    if seq_id not in seq_map:
        raise FormatError(
            "unknown sequence id", path, line0, col0, stat=Status.errorInvalidValue
        )
    pos = idend

    seq_len = len(seq_map[seq_id].seq) - 1  # without header element
    rng = Range(l=0, r=seq_len, l_not_default=False, r_not_default=False)

    if pos >= len(line) or line[pos] != "[":
        return seq_id, rng, pos

    pos += 1  # consume '['
    pos = _skip_ws(line, pos)

    if pos < len(line) and line[pos] != ":":
        c = line[pos] if pos < len(line) else ""
        if not (c.isdigit() or c in "+-"):
            raise FormatError("expected a number", path, line0, pos)
        try:
            rng.l, pos = _parse_int(line, pos)
        except ValueError:
            raise FormatError("expected a number", path, line0, pos)
        rng.l_not_default = True
        if rng.l < 0:
            raise FormatError("left bound must be non-negative", path, line0, pos)
        if rng.l >= seq_len:
            raise FormatError(
                "left bound greater than or equal to sequence length",
                path, line0, pos,
            )

    pos = _skip_ws(line, pos)
    if pos >= len(line) or line[pos] != ":":
        raise FormatError("expected ':'", path, line0, pos)
    pos += 1
    pos = _skip_ws(line, pos)

    if pos < len(line) and line[pos] != "]":
        c = line[pos]
        if not (c.isdigit() or c in "+-"):
            raise FormatError("expected a number", path, line0, pos)
        try:
            rng.r, pos = _parse_int(line, pos)
        except ValueError:
            raise FormatError("expected a number", path, line0, pos)
        rng.r_not_default = True
        if rng.r <= rng.l:
            raise FormatError(
                "right bound must be greater than left", path, line0, pos
            )
        if rng.r > seq_len:
            raise FormatError(
                "right bound greater than sequence length", path, line0, pos
            )

    pos = _skip_ws(line, pos)
    if pos >= len(line) or line[pos] != "]":
        raise FormatError("expected ']'", path, line0, pos)
    pos += 1

    return seq_id, rng, pos


def read_seq_pairs(
    path: str, stream: TextIO, seq_map: Dict[str, Seq]
) -> List[SeqPair]:
    pairs: List[SeqPair] = []
    line0 = -1
    for line0, raw in enumerate(stream):
        line = raw.rstrip("\n")
        pos = _skip_ws(line, 0)
        if pos >= len(line):
            continue  # skip empty lines

        y_id, y_rng, pos = _read_id_and_range(line, pos, path, line0, seq_map)
        x_id, x_rng, pos = _read_id_and_range(line, pos, path, line0, seq_map)
        pos = _skip_ws(line, pos)
        if pos < len(line):
            raise FormatError("expected next line", path, line0, pos)

        pairs.append(
            SeqPair(seqY_id=y_id, seqX_id=x_id, seqY_range=y_rng, seqX_range=x_rng)
        )

    if not pairs:
        raise FormatError("expected at least one sequence pair", path, line0, 0)
    return pairs


def parse_seq_pair_file(path: str, seq_map: Dict[str, Seq]) -> List[SeqPair]:
    with open(path, "r", encoding="utf-8") as f:
        return read_seq_pairs(path, f, seq_map)


def default_pairs(seq_map: Dict[str, Seq]) -> List[SeqPair]:
    """All-vs-first pairing when no pair file is given
    (ref: src/cmd_parser.cpp:466-499): Y = every other sequence, X = first."""
    ids = list(seq_map.keys())
    if not ids:
        raise ValueError(
            "since seqPairPath is empty, at least two sequences are necessary "
            "for default alignment"
        )
    x_id = ids[0]
    x_len = len(seq_map[x_id].seq) - 1
    pairs: List[SeqPair] = []
    for y_id in ids:
        if y_id == x_id:
            continue
        y_len = len(seq_map[y_id].seq) - 1
        pairs.append(
            SeqPair(
                seqY_id=y_id,
                seqX_id=x_id,
                seqY_range=Range(l=0, r=y_len),
                seqX_range=Range(l=0, r=x_len),
            )
        )
    if not pairs:
        raise ValueError(
            "since seqPairPath is empty, at least two sequences are necessary "
            "for default alignment"
        )
    return pairs
