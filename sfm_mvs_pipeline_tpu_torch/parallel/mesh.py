"""The device mesh of one process, and rank helpers.

Port of sfm_mvs_pipeline_tpu/parallel/mesh.py. The port has two shapes of
parallelism where the JAX package has one SPMD program: the cards of one
host form a Mesh that one process drives (make_mesh; Shards.leading and
Shards.replicated in distributed.py are the counterparts of the JAX
package's NamedSharding(P("data")) and NamedSharding(P())), or
torchrun's ranks, one device each, split the work across processes
(world, the default process group). A sharded function gives each shard,
a card of the mesh or a rank, one contiguous block of its leading axis
(block), as PartitionSpec("data") does.

The Mesh is a small immutable tuple of torch.device, not
torch.distributed.DeviceMesh, which needs a process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh over `devices`, in shard order. A device may repeat
    ("cuda:0,cuda:0": two shards on one card)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device the mesh's results gather on."""
        return self.devices[0]


def make_mesh(devices=None) -> Mesh:
    """The mesh over `devices`: a resolve_devices spec (default: every
    visible card), or an int n, the first n of them."""
    from sfm_mvs_pipeline_tpu_torch import resolve_devices

    if isinstance(devices, Mesh):
        return devices
    if isinstance(devices, int):
        every = resolve_devices(None)
        if devices > len(every):
            raise RuntimeError(f"a mesh of {devices} devices on a machine with {len(every)}")
        return Mesh(every[:devices])
    return Mesh(resolve_devices(devices))


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def block(n: int, rank: int, size: int) -> tuple[int, int]:
    """[lo, hi) of shard `rank`'s contiguous block of n items padded to a
    multiple of size (hi may pass n: the padded tail)."""
    per = -(-n // size)
    return rank * per, (rank + 1) * per


def pad_to_multiple(x: np.ndarray, m: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths, constant_values=fill)
