"""View-sharded dense stereo: depth maps data-parallel over the shards.

Port of sfm_mvs_pipeline_tpu/parallel/mvs.py (SURVEY.md §2.7 item (4),
after the reference's per-view OpenMP threading inside openMVS, ref:
src/photogrammetrie/mvs/MVS.cpp:29), with the JAX package's signature: a
thin adapter over mvs/pipeline.py, whose depth_maps_by_view gives each
shard (a card of this process's mesh, each in a thread of its own, or
a rank under torchrun) a contiguous block of the reference views by its
index, computes
each with the per-view function depth_map_view that run_mvs also runs,
and gathers every view's depth (f32) and validity in view order. Images
are replicated.

Departure from the JAX package: its sharded PatchMatch runs the
warp-based form on every backend, while its one-device path runs the
rectified PatchMatch on its TPU, so its dense output depends on the device
count. Here both paths run the same per-view function (the rectified
PatchMatch with kernel K3 where a neighbour passes the geometry gate), so
depth maps do not depend on the world size.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.mvs.neighbors import fixed_neighbor_table  # noqa: F401
from sfm_mvs_pipeline_tpu_torch.mvs.pipeline import MVSConfig, depth_map_view, depth_maps_by_view
from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards, check_agree


def compute_depth_maps_sharded(
    grays: np.ndarray,  # (V, H, W) f32 undistorted grayscale
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,) pinhole (distortion zeroed)
    nbr_idx: np.ndarray,  # (V, N) int32 neighbour view indices (pad 0)
    nbr_valid: np.ndarray,  # (V, N) bool
    planes: np.ndarray,  # (V, D) per-view depth ladders
    window_radius: int = 3,
    use_sgm: bool = False,
    sgm_p1: float = 0.03,
    sgm_p2: float = 0.3,
    max_cost: float = 0.35,
    method: str = "sweep",
    pm_iterations: int = 8,
    pm_seed_rect: bool = True,
    max_disp: int = 256,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (depth (V, H, W) f32, valid (V, H, W) bool), the same on
    every rank. The JAX package's signature with its mesh as `device` (a
    Mesh or a resolve_devices spec; default every visible card; under
    torchrun each rank's device). The per-view ladder
    gives the sweep its planes and the rect and PatchMatch engines their
    depth range (its min and max); `max_disp` bounds the rect engine's
    disparities in every view (PatchMatch derives each view's own, as
    run_mvs does)."""
    V, H, W = grays.shape
    shards = Shards(device)
    check_agree("compute_depth_maps_sharded", grays, poses, intr, nbr_idx, nbr_valid, planes)
    cfg = MVSConfig(n_neighbors=nbr_idx.shape[1], n_planes=planes.shape[1],
                    window_radius=window_radius, max_cost=max_cost, use_sgm=use_sgm,
                    sgm_p1=sgm_p1, sgm_p2=sgm_p2, method=method, pm_iterations=pm_iterations,
                    pm_seed_rect=pm_seed_rect)
    poses32 = np.asarray(poses, np.float32)
    inputs = (np.asarray(grays, np.float32), poses32, np.asarray(intr, np.float32))
    planes = np.asarray(planes, np.float32)

    def one_view(i, grays_d, poses_d, intr_d):
        nbrs = [int(n) for n in nbr_idx[i][np.asarray(nbr_valid[i], bool)]]
        if not nbrs:
            return None
        depth, valid, _ = depth_map_view(
            cfg, i, nbrs, grays_d, poses32, poses_d, intr_d, float(np.asarray(intr)[0]),
            float(planes[i].min()), float(planes[i].max()), W, planes=planes[i],
            max_disp=max_disp)
        return depth, valid

    return depth_maps_by_view(V, one_view, H, W, shards, inputs)

