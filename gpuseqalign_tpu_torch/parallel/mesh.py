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

A mesh may also span the processes of a ``torch.distributed`` group, as a
JAX mesh spans the processes of ``jax.distributed``: each process names
its own local devices, every process the same count L, and the global
band order is rank-major, rank p holding entries [p·L, (p+1)·L). Only the
giant-pair engine (``giant2.py``) takes such a mesh; it sends the halo
across a process edge over the group and replicates the band grids to
every process.

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
    """An ordered tuple of this process's devices along one named axis;
    with ``processes`` > 1, this process's share (rank ``rank``) of a mesh
    of ``processes`` x ``len(devices)`` entries over a torch.distributed
    group."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "pairs"
    processes: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        """Entries of the whole mesh, over every process."""
        return self.processes * len(self.devices)

    @property
    def first(self) -> int:
        """The global index of this process's first entry."""
        return self.rank * len(self.devices)

    def check_group(self) -> None:
        """Raise unless the torch.distributed group this mesh spans is up
        with this process at its rank; a no-op for a one-process mesh."""
        if self.processes == 1:
            return
        dist = _group()
        if (dist.get_world_size(), dist.get_rank()) != (self.processes,
                                                        self.rank):
            raise RuntimeError(
                f"the mesh was made for rank {self.rank} of "
                f"{self.processes} processes, the group has rank "
                f"{dist.get_rank()} of {dist.get_world_size()}")

    def check_one_process(self, engine: str) -> None:
        """Raise for a mesh that spans processes: ``engine`` runs on one
        process's devices."""
        if self.processes > 1:
            raise ValueError(
                f"{engine} takes a mesh of one process's devices, not one "
                f"over {self.processes} processes")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "pairs",
              devices: Optional[Sequence[Device]] = None,
              span_processes: bool = False) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device; a RuntimeError when there is none).

    With ``span_processes`` the mesh spans every process of the
    torch.distributed group that is up (a RuntimeError when none is):
    ``devices`` are this process's entries, and every process calls this
    together, naming as many as the others (a ValueError if not)."""
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
    if not span_processes:
        return Mesh(tuple(devices), axis_name)
    dist = _group()
    counts = [torch.zeros(1, dtype=torch.int64)
              for _ in range(dist.get_world_size())]
    dist.all_gather(counts, torch.tensor([len(devices)]))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(
            f"every process must name as many devices; they name {counts}")
    return Mesh(tuple(devices), axis_name, dist.get_world_size(),
                dist.get_rank())


def _group():
    """``torch.distributed``, once a group is up; a RuntimeError before."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh that spans processes needs a torch.distributed group; "
            "call distributed_init first")
    return dist


def default_mesh(device: Optional[Device]) -> Mesh:
    """The giant engines' mesh when the caller passes none: the input's own
    device alone (D = 1), even on a host with several cards. More bands
    take an explicit mesh: at D > 1 the engine runs one pass a call."""
    return Mesh((resolve_device(device),), "sp")


def synchronize_mesh(mesh: Mesh) -> None:
    """Wait for the queued work of every distinct device of the mesh that
    this process holds."""
    for dev in dict.fromkeys(mesh.devices):
        synchronize(dev)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join a gloo group of ``num_processes`` processes
    (``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>``). What crosses processes goes through
    host memory: the multihost batch's small result block, and the giant
    pair's halo at a process edge (a few hundred KB a call, staged through
    pinned host memory on a card) and its replicated band grids. Gloo,
    not NCCL: NCCL refuses two ranks on one card, where the processes of a
    one-card machine run. A no-op when a group is already up or when the
    caller runs one process alone."""
    import torch.distributed as dist

    if dist.is_initialized() or not num_processes or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "several processes need coordinator_address and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
