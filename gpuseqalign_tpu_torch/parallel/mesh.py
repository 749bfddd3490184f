"""Device lists for the batch and giant-pair engines.

Port of gpuseqalign_tpu's ``parallel/mesh.py``. There, one controller
process drives a 1-D ``jax.sharding.Mesh``: ``shard_map`` runs one band
(or one share of a batch) per device and ``lax.ppermute`` passes each
band's halo to the next device. The PyTorch counterpart is one process
that owns an ordered list of devices: the engines place each band or
share on its device and copy each halo into the next band's device (a
peer copy between cards, or a device-local copy when two bands share a
card), with CUDA events ordering the streams. A list may name one device
more than once, which runs D > 1 bands on one card or on the CPU.

``batch_sharding`` and ``replicated`` have no counterpart: they told XLA
how to split or copy an array over the mesh, and the engines here place
every tensor on its device themselves. ``distributed_init`` wraps
``torch.distributed`` for what JAX does across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from ..utils.device import resolve_device, synchronize

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "pairs"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "pairs",
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; a RuntimeError when there is none)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is present; pass devices=[\"cpu\", ...] to "
                "run on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), axis_name)


def default_mesh(device: Optional[Device]) -> Mesh:
    """The giant engines' mesh when the caller passes none: the input's own
    device alone (D = 1), even on a host with several cards. More bands
    take an explicit mesh: at D > 1 the engine runs one pass a call."""
    return Mesh((resolve_device(device),), "sp")


def synchronize_mesh(mesh: Mesh) -> None:
    """Wait for the queued work of every distinct device of the mesh."""
    for dev in dict.fromkeys(mesh.devices):
        synchronize(dev)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join a gloo group of ``num_processes`` processes
    (``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>``; gloo, because what crosses processes
    today is the multihost batch's small result block on the CPU). A no-op
    when a group is already up or when the caller runs one process
    alone."""
    import torch.distributed as dist

    if dist.is_initialized() or not num_processes or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "several processes need coordinator_address and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
