"""Run-length-encoded edit transcripts.

The reference builds the transcript while walking the traceback from the
bottom-right corner and reverses at the end (ref: src/nwtrace1_plain.cpp:81-103).
The observable result: the transcript reads from the TOP-LEFT corner as a
concatenation of ``<count><edit>`` runs, e.g. ``193=1X2I`` = 193 matches,
1 mismatch, 2 insertions.

Edit letters (ref: src/nwtrace1_plain.cpp:46-77):
    '='  diagonal move, letters match
    'X'  diagonal move, letters differ
    'I'  up move (gap in seqX aligned to a letter in seqY) — insertion in seqX
    'D'  left move (letter in seqX aligned to a gap in seqY) — deletion in seqX

We build the transcript forward (path order) which yields the identical
string without double reversal.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List


@dataclasses.dataclass
class EditRun:
    edit: str
    count: int


def rle_append(runs: List[EditRun], edit: str) -> None:
    """Append one edit step (in path order, top-left to bottom-right)."""
    if runs and runs[-1].edit == edit:
        runs[-1].count += 1
    else:
        runs.append(EditRun(edit, 1))


def rle_finish(runs: Iterable[EditRun]) -> str:
    """Render runs as the reference-format transcript ``<count><edit>``..."""
    return "".join(f"{r.count}{r.edit}" for r in runs)


def rle_from_edits(edits: Iterable[str]) -> str:
    runs: List[EditRun] = []
    for e in edits:
        rle_append(runs, e)
    return rle_finish(runs)


def expand_transcript(transcript: str) -> str:
    """Inverse of rle: '2=1X' -> '==X'. For tests and CIGAR-ish consumers."""
    out: List[str] = []
    num = ""
    for ch in transcript:
        if ch.isdigit():
            num += ch
        else:
            out.append(ch * int(num))
            num = ""
    return "".join(out)
