"""Pair-sharded descriptor matching over the shards this process holds.

Port of sfm_mvs_pipeline_tpu/parallel/matching.py, the data-parallel axis
of the SfM frontend (the reference's OMP pair loop,
UnorderedFeatureMatchingStrategy.cpp:40): the pair list is padded to a
multiple of the shard count with pair (0, 0) and each shard (a card of
the mesh, or a rank under torchrun) matches one contiguous block of it,
by its index, with one launch of kernel K1 (K1x with `exact`);
descriptors are replicated to each shard's device. The (P, F) outputs
are gathered in shard order, trimmed to the real pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards, check_agree


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
    device=None,
) -> tuple[torch.Tensor, ...]:
    """Match `pairs` across the shards. Returns (best_idx (P, F) int32,
    mask (P, F) bool[, best L2 distance (P, F)]), bit-equal to
    ops/matching.py::match_pairs_batch on the same inputs: on the first
    device of the mesh `device` (the JAX package's mesh: a Mesh or a
    resolve_devices spec; default every visible card; under torchrun the
    rank's device, the same result on every rank). The JAX package's
    `chunk` is gone: each shard's block is one launch."""
    from sfm_mvs_pipeline_tpu_torch.ops.matching import match_pairs_batch

    shards = Shards(device)
    pairs_np = np.asarray(torch.as_tensor(pairs).cpu(), np.int32).reshape(-1, 2)
    check_agree("match_pairs_sharded", descriptors, valid, pairs_np)
    n_pairs = len(pairs_np)

    def one(sh, desc, val, mine):
        out = match_pairs_batch(desc, val.bool(), mine, ratio=ratio, distinct=distinct,
                                backend=backend, method=method, with_distance=with_distance,
                                exact=exact)
        return tuple(sh.all_gather_cat(o)[:n_pairs] for o in out)

    return shards.run(one, shards.replicated(descriptors), shards.replicated(valid),
                      shards.leading(pairs_np))[0]
