"""Pair-sharded descriptor matching over the process group's ranks.

Port of sfm_mvs_pipeline_tpu/parallel/matching.py, the data-parallel axis
of the SfM frontend (the reference's OMP pair loop,
UnorderedFeatureMatchingStrategy.cpp:40): the pair list is padded to a
multiple of the world size with pair (0, 0) and each rank matches one
contiguous block of it with one launch of kernel K1 (K1x with `exact`);
descriptors are replicated. An all_gather brings every rank's (P, F)
outputs back to every rank, trimmed to the real pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.parallel.distributed import all_gather_cat, check_agree
from sfm_mvs_pipeline_tpu_torch.parallel.mesh import block, pad_to_multiple, rank_device, world


def match_pairs_sharded(
    descriptors,  # (S, F, D) float32, or bfloat16 +-1; tensor or array
    valid,  # (S, F) bool
    pairs,  # (P, 2)
    ratio: float = 0.7,
    distinct: bool = False,
    backend: str = "auto",
    method: str = "bf",
    with_distance: bool = False,
    exact: bool = False,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, ...]:
    """Match `pairs` across the ranks. Returns (best_idx (P, F) int32,
    mask (P, F) bool[, best L2 distance (P, F)]) on this rank's device
    (default: the card), bit-equal to ops/matching.py::match_pairs_batch on
    the same inputs and identical on every rank. The JAX package's mesh
    argument is gone (the ranks are the mesh) and so is its `chunk`: each
    rank's block is one launch."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch

    rank, size = world()
    dev = rank_device(device)
    desc = torch.as_tensor(descriptors, device=dev)
    val = torch.as_tensor(valid, device=dev).bool()
    pairs_np = np.asarray(torch.as_tensor(pairs).cpu(), np.int32).reshape(-1, 2)
    check_agree("match_pairs_sharded", desc, val, pairs_np)
    n_pairs = len(pairs_np)
    lo, hi = block(n_pairs, rank, size)
    mine = torch.as_tensor(pad_to_multiple(pairs_np, size)[lo:hi], device=dev)
    out = match_pairs_batch(desc, val, mine, ratio=ratio, distinct=distinct, backend=backend,
                            method=method, with_distance=with_distance, exact=exact)
    return tuple(all_gather_cat(o)[:n_pairs] for o in out)
