"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a missing
card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

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
