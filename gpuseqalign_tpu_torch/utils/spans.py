"""Profiler spans that cost one flag read while no profiler records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler records (the CLI's ``--profileDir``, a traced benchmark window)
and a shared no-op context otherwise. A ``record_function`` opened with
nobody listening still builds its Python object and a C++ record through
the dispatcher: about 11 us a span warm, and several times that where it
follows the single-pair flow's copies of tens of MB, whose laps it would
otherwise carry.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` span while a profiler records, else a
    no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
