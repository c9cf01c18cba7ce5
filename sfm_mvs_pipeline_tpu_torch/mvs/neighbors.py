"""Neighbor-view selection for dense stereo.

Equivalent of the reference's per-view neighbor selection (5 neighbor views,
ref: src/photogrammetrie/mvs/MVS.h:58-69 `numberOfViews`, and
OpenMvsUtils::resetImageResoloution neighbor computation,
OpenMvsUtils.cpp:193-212): score each candidate by shared sparse points and
triangulation angle, prefer moderate baselines.

Copy of sfm_mvs_pipeline_tpu/mvs/neighbors.py (host numpy in both packages).
"""

from __future__ import annotations

import numpy as np


def select_neighbors(
    scene,
    n_neighbors: int = 5,
    min_angle_deg: float = 3.0,
    max_angle_deg: float = 60.0,
) -> dict[int, list[int]]:
    """For each recovered shot, the best neighbor shots for stereo.

    Score = (#shared points) * angle_weight, where angle_weight peaks inside
    [min_angle, max_angle] of median triangulation angle (the standard
    view-selection heuristic openMVS uses internally).
    """
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    rec = np.nonzero(scene.recovered)[0]
    # host numpy: a device op per shot would cost more in dispatch than
    # its microseconds of math
    centers = {}
    for s in rec:
        R = aa_to_rotmat_np(scene.poses[s][:3])
        centers[int(s)] = -R.T @ scene.poses[s][3:]

    # points seen per shot (live observations only)
    live = scene.obs_w > 0
    seen: dict[int, set] = {int(s): set() for s in rec}
    for p, s in zip(scene.obs_point[live], scene.obs_shot[live]):
        if int(s) in seen:
            seen[int(s)].add(int(p))

    out: dict[int, list[int]] = {}
    for r in rec:
        r = int(r)
        scores = []
        for n in rec:
            n = int(n)
            if n == r:
                continue
            shared = seen[r] & seen[n]
            if len(shared) < 10:
                continue
            pts = scene.points[np.asarray(sorted(shared), dtype=np.int64)]
            v1 = pts - centers[r]
            v2 = pts - centers[n]
            cosang = (v1 * v2).sum(1) / (
                np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1) + 1e-12
            )
            ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
            med = float(np.median(ang))
            if med < min_angle_deg:
                w = med / min_angle_deg
            elif med > max_angle_deg:
                w = max(0.0, 1.0 - (med - max_angle_deg) / max_angle_deg)
            else:
                w = 1.0
            scores.append((len(shared) * w, n))
        scores.sort(reverse=True)
        out[r] = [n for _, n in scores[:n_neighbors]]
    return out


def depth_range(scene, shot: int, pad: float = 0.25) -> tuple[float, float]:
    """Depth search range for a view from its sparse points (the standard
    seed openMVS takes from the sparse cloud)."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np

    live = (scene.obs_w > 0) & (scene.obs_shot == shot)
    pids = np.unique(scene.obs_point[live])
    if len(pids) == 0:
        return 0.1, 100.0
    R = aa_to_rotmat_np(scene.poses[shot][:3])
    pc = scene.points[pids] @ R.T + scene.poses[shot][3:]
    z = pc[:, 2]
    z = z[z > 0]
    if len(z) == 0:
        return 0.1, 100.0
    lo = float(np.percentile(z, 2))
    hi = float(np.percentile(z, 98))
    span = hi - lo
    return max(lo - pad * span, 1e-3), hi + pad * span


def fixed_neighbor_table(
    neighbors: dict, rec: list, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-capacity neighbour table over LOCAL view indices (a copy of
    sfm_mvs_pipeline_tpu/parallel/mvs.py::fixed_neighbor_table).

    neighbors: {shot_id: [shot_id, ...]} from select_neighbors; rec:
    recovered shot ids in local order. Returns (idx (V, N), valid (V, N)).
    """
    idx_of = {s: i for i, s in enumerate(rec)}
    V = len(rec)
    idx = np.zeros((V, capacity), np.int32)
    valid = np.zeros((V, capacity), bool)
    for i, s in enumerate(rec):
        loc = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of][:capacity]
        idx[i, : len(loc)] = loc
        valid[i, : len(loc)] = True
    return idx, valid
