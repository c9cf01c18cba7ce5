"""Rank helpers: the port's counterpart of the JAX package's device mesh.

There is no mesh object. The data axis is the default process group's
ranks; each rank owns one device (the card initialize_distributed set for
it, or the CPU), and a sharded function gives each rank one contiguous
block of its leading axis, as PartitionSpec("data") does.
"""

from __future__ import annotations

import numpy as np
import torch


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: torch.device | str | None = None) -> torch.device:
    """The device this rank computes on: `device` when given, else the card
    (the current CUDA device, which initialize_distributed set to this
    rank's; raises without a card)."""
    from sfm_mvs_pipeline_tpu_torch import resolve_device

    return resolve_device(device)


def block(n: int, rank: int, size: int) -> tuple[int, int]:
    """[lo, hi) of rank's contiguous block of n items padded to a multiple
    of size (hi may pass n: the padded tail)."""
    per = -(-n // size)
    return rank * per, (rank + 1) * per


def pad_to_multiple(x: np.ndarray, m: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % m
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, widths, constant_values=fill)
