"""Device meshes for the multi-device paths, on ``torch.distributed``.

Port of ``stereo_semantic_vo_tpu.parallel.mesh`` with the same names.  JAX
runs one program over a mesh of devices with named axes and inserts the
collectives itself.  PyTorch runs one process a rank and calls the
collectives by hand, so the two axes map onto it as follows:

* ``landmark`` (``LANDMARK_AXIS``), the axis the window BA shards its
  landmarks over: a ``torch.distributed`` process group, one rank a
  device (NCCL on the card, gloo on the CPU).  Each rank holds its own
  L/world landmarks; the reduced camera system is an ``all_reduce``.
  Without an initialized process group the axis is this process alone,
  and an all-reduce over it is the identity.
* ``data`` (``DATA_AXIS``), the batch axis of the data-parallel tracker and
  the replicated detector: the devices this process drives.

A ``Mesh`` holds both: ``devices`` (the data axis; its first device is
this rank's device on the landmark axis) and ``group``.  A JAX
(data x landmark) mesh of D x M devices is M processes that drive D
devices each.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

LANDMARK_AXIS = "landmark"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]  # the data axis: the devices this process drives
    axis_names: tuple[str, ...]
    group: Any = None                  # the landmark axis: a process group; None = this process alone

    @property
    def device(self) -> torch.device:
        """This rank's device on the landmark axis."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """Ranks on the landmark axis."""
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def shape(self) -> dict[str, int]:
        sizes = {DATA_AXIS: len(self.devices), LANDMARK_AXIS: self.size}
        return {a: sizes[a] for a in self.axis_names}

    def all_reduce(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Sums over the landmark axis, in one collective: the tensors are
        packed into one float32 buffer.  The identity on one rank."""
        if self.group is None:
            return list(tensors)
        buf = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(buf, group=self.group)
        return [x.view_as(t) for x, t in zip(torch.split(buf, [t.numel() for t in tensors]), tensors)]

    def all_gather(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' (n, ...) shards concatenated in rank order."""
        if self.group is None:
            return local
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str = "cuda",
) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` over
    TCP at ``coordinator_address`` ("host:port"), with NCCL for a CUDA
    ``device`` and gloo for the CPU.  Arguments left None are read from the
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  Does nothing for one process."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _local_devices(n: int | None, device: torch.device | str) -> tuple[torch.device, ...]:
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        n = count if n is None else n
        if not 1 <= n <= count:
            raise ValueError(f"asked for {n} CUDA devices, this process sees {count}")
        return tuple(torch.device("cuda", i) for i in range(n))
    return (torch.device(kind),) * (1 if n is None else n)


def _landmark_group(n: int | None):
    """The process group of the first n ranks (all by default), or None
    when no process group is initialized and one rank is asked for."""
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a landmark axis of {n} ranks needs torch.distributed (init_distributed)")
        return None
    world = dist.get_world_size()
    if n is None or n == world:
        return dist.group.WORLD
    if not 1 <= n <= world:
        raise ValueError(f"asked for {n} ranks of {world}")
    return dist.new_group(list(range(n)))


def _rank_device(device: torch.device | str) -> torch.device:
    """This rank's device: the CPU, or the card of index rank mod cards."""
    if torch.device(device).type != "cuda":
        return torch.device(torch.device(device).type)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis: str = LANDMARK_AXIS, device: torch.device | str = "cuda") -> Mesh:
    """A 1-D mesh: ``n_devices`` ranks of the landmark axis (default: every
    rank; fewer makes a new process group, which every rank must call), or
    ``n_devices`` devices of this process on the data axis (default: every
    card; one CPU)."""
    if axis == DATA_AXIS:
        return Mesh(devices=_local_devices(n_devices, device), axis_names=(DATA_AXIS,))
    if axis != LANDMARK_AXIS:
        raise ValueError(f"unknown axis {axis!r}")
    group = _landmark_group(n_devices)
    return Mesh(devices=(_rank_device(device),), axis_names=(LANDMARK_AXIS,), group=group)


def make_2d_mesh(data: int, model: int, device: torch.device | str = "cuda") -> Mesh:
    """(data x landmark) mesh: ``model`` ranks on the landmark axis, each
    driving ``data`` devices.  On the card, rank k drives cards
    k*data ... k*data + data - 1 of its node."""
    group = _landmark_group(model)
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        first = (dist.get_rank() if dist.is_initialized() else 0) * data % count
        if first + data > count:
            raise ValueError(f"a rank needs cards {first}..{first + data - 1}, this node has {count}")
        devices = tuple(torch.device("cuda", first + i) for i in range(data))
    else:
        devices = _local_devices(data, device)
    return Mesh(devices=devices, axis_names=(DATA_AXIS, LANDMARK_AXIS), group=group)


def shard_landmarks(mesh: Mesh, arr: torch.Tensor, axis_name: str = LANDMARK_AXIS, dim: int = 0) -> torch.Tensor:
    """This rank's block of a landmark-major tensor, on its device: the
    ``rank``-th of ``size`` equal slices along ``dim``."""
    if axis_name != LANDMARK_AXIS:
        raise ValueError(f"landmarks shard over {LANDMARK_AXIS!r}, not {axis_name!r}")
    L, n = arr.shape[dim], mesh.size
    if L % n:
        raise ValueError(f"{L} landmarks do not split over {n} ranks")
    return arr.narrow(dim, mesh.rank * (L // n), L // n).to(mesh.device)


def replicate(mesh: Mesh, arr: torch.Tensor) -> list[torch.Tensor]:
    """A copy of ``arr`` on every device this process drives (each rank of
    the landmark axis holds its own)."""
    return [arr.to(d) for d in mesh.devices]
