"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a missing
card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. Raises RuntimeError when CUDA is asked
    for (or implied) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device=\"cpu\" to run on the CPU"
        )
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read next covers it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_info(dev: torch.device) -> Tuple[str, Optional[str]]:
    """(name, power limit) of the card as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, for a measurement to
    print beside its numbers; ("cpu", None) on the CPU."""
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    name, _, power = out.stdout.strip().splitlines()[0].rpartition(",")
    return name.strip(), power.strip()
