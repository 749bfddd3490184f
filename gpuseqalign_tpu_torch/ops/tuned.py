"""The card's tuned-parameter cache: tile defaults chosen on the card by
``bench/autotune.py``.

Counterpart of gpuseqalign_tpu's ``tuned_cache`` / ``tuned_defaults``
(``ops/pallas_wavefront2.py``). The cache is ``resrc/tuned/<name>.json``,
where ``<name>`` is the CUDA device's name lower-cased with spaces turned
into ``_`` (the JAX package names its file after the TPU's device kind the
same way). Each spec (``nw_lg``, ``nw_ag``, ``sw_lg``, ``sw_ag``) has an
entry of the single-pair sparse fill's tile, ``tileBy``, ``tileBx`` and the
rate it was tuned at, ``_gcups``, and may hold a ``banded`` sub-entry for
the giant engine: ``tileBy``, ``tileBx``, ``_at_rows`` (the rows it was
tuned at) and ``_gcups``.

Only those keys are read. The TPU's register levers (``kChains``,
``packedx``, ``packedef``, ``rematHdr``, ``noBc``, ``subProw``, ``winW``)
mean nothing to the strip kernels; a cache that holds them has them
ignored. On the CPU, or with no file or no entry, the defaults are ``{}``
and callers keep their literals.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import torch

from ..utils.device import resolve_device

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "resrc", "tuned")
TILE_KEYS = ("tileBy", "tileBx", "_gcups")
BANDED_KEYS = ("tileBy", "tileBx", "_at_rows", "_gcups")

Device = Union[str, torch.device]


def cache_name(device: Device) -> str:
    """The cache's file stem for a CUDA device: its name, lower-cased,
    spaces turned into ``_`` (``nvidia_h100_80gb_hbm3``). Raises without
    a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the cache is named after a CUDA device, not {dev}")
    return torch.cuda.get_device_name(dev).lower().replace(" ", "_")


def cache_path(name: str, root: Optional[str] = None) -> str:
    return os.path.join(root or ROOT, f"{name}.json")


def read_cache(name: str, root: Optional[str] = None) -> Dict:
    """The whole cache file of ``name`` ({} when there is none)."""
    path = cache_path(name, root)
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def tuned_defaults(spec_name: str, device: Device,
                   root: Optional[str] = None) -> Dict:
    """Tuned defaults of ``spec_name`` on ``device``, reduced to the keys
    the port reads: from the card's cache on a CUDA device, ``{}`` on the
    CPU or when the cache has no entry."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ent = read_cache(cache_name(device), root).get(spec_name, {})
    out = {k: ent[k] for k in TILE_KEYS if k in ent}
    band = {k: v for k, v in ent.get("banded", {}).items()
            if k in BANDED_KEYS}
    if band:
        out["banded"] = band
    return out


def tuned_tile(spec_name: str, device: Device, default: tuple,
               banded: bool = False) -> tuple:
    """(tileBy, tileBx) from the cache, else ``default``. ``banded`` reads
    the ``banded`` sub-entry first, then the spec's own tile, as the JAX
    giant engine does."""
    ent = tuned_defaults(spec_name, device)
    band = ent.get("banded", {}) if banded else {}
    return (int(band.get("tileBy", 0) or ent.get("tileBy", default[0])),
            int(band.get("tileBx", 0) or ent.get("tileBx", default[1])))
