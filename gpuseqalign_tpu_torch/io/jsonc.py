"""JSON with // and /* */ comments (ref: src/io.hpp:29-34 — the reference
parses its JSON config files with comments allowed)."""

from __future__ import annotations

import json
from typing import Any


def strip_json_comments(text: str) -> str:
    out = []
    i = 0
    n = len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def read_jsonc_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return json.loads(strip_json_comments(text))
