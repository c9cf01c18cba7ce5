"""Point-sharded bundle adjustment: each shard holds a block of the points,
the reduced camera system is summed over the shards.

Port of sfm_mvs_pipeline_tpu/parallel/ba.py (the multi-chip DENSE_SCHUR
replacement), over the shards this process holds (a card of the mesh,
or a rank under torchrun; parallel/distributed.py::Shards; the CLI
shards it over the ranks only, sfm/incremental.py::_SHARDED_BA_MIN_OBS):
  * points are split into contiguous blocks balanced by observation count,
    one per shard, each with its points' observations (shard_scene_by_points)
  * each shard builds its block's partial system with the one-device build
    functions of sfm/ba.py, and one sum per LM build adds the undamped
    terms (Hcc, g, S_corr, rhs_corr, cost) before damping: in a mesh in
    card order on the first card, under torchrun by an all-reduce
  * every shard solves the summed system, the same bits on each, with the
    one-device solver (BAConfig.solver) and back-substitutes its own points
  * the trial cost is summed before the accept test, so every shard takes
    the same branch and the same stop test
  * the points are gathered and scattered back by point_ids at the end,
    and shard 0's poses and intrinsics broadcast, so every rank returns
    the same bits

The JAX package's fused dense LM (one shard_map program, its
parallel/ba.py:148-238) is a compile-time device of XLA; the port runs the
same numbers through the one-device LM loop (sfm/ba.py::lm_solve). On one
shard the result is bit-equal to run_bundle_adjustment; on more the sums
run in another order (the tests state the tolerance), and two runs over
one mesh give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards, check_agree
from sfm_mvs_pipeline_tpu_torch.sfm.ba import (
    DENSE_GRID_MAX_SLOTS,
    BAConfig,
    build_track_table,
    lm_solve,
    pack_dense_obs,
)


def shard_scene_by_points(
    n_dev: int,
    points: np.ndarray,
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    n_shots: int | None = None,
) -> dict:
    """Partition points into n_dev contiguous shards balanced by live
    observation count.

    Returns a dict of stacked per-shard arrays: points (n_dev, P_loc, 3),
    point_ids (n_dev, P_loc) (-1 = pad), obs_* (n_dev, O_loc, ...) with LOCAL
    point indices, and table_kind with its tables: "dense", the (P_loc, S)
    grids uv_ps / w_ps, when n_shots is given, n_dev * P_loc * n_shots <=
    DENSE_GRID_MAX_SLOTS and no (point, shot) has two live observations;
    else "track", track_tab (n_dev, P_loc, L) of local observation indices.
    The JAX package's third layout, a (P, S) shot table, is not ported (the
    port's one-rank BA has none). Departure: a shard's observations keep
    their input order, where the JAX package sorts them by point; the
    tables index them either way, and the input order keeps one shard
    bit-equal to the one-rank BA."""
    n_pts = len(points)
    counts = np.bincount(obs_point[(obs_w > 0)], minlength=n_pts)

    # balanced contiguous split of point ids by cumulative obs count
    cum = np.cumsum(counts)
    total = cum[-1] if len(cum) else 0
    bounds = [0]
    for d in range(1, n_dev):
        bounds.append(int(np.searchsorted(cum, total * d / n_dev)))
    bounds.append(n_pts)

    P_loc = max(max(bounds[d + 1] - bounds[d] for d in range(n_dev)), 1)
    shards = {
        "points": np.zeros((n_dev, P_loc, 3), points.dtype),
        "point_ids": np.full((n_dev, P_loc), -1, np.int64),
    }
    obs_by_shard = []
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        shards["points"][d, : hi - lo] = points[lo:hi]
        shards["point_ids"][d, : hi - lo] = np.arange(lo, hi)
        obs_by_shard.append(np.nonzero((obs_point >= lo) & (obs_point < hi))[0])
    O_loc = max(max(len(s) for s in obs_by_shard), 1)

    op = np.zeros((n_dev, O_loc), np.int32)
    osr = np.zeros((n_dev, O_loc), np.int32)
    ouv = np.zeros((n_dev, O_loc, 2), obs_uv.dtype)
    ow = np.zeros((n_dev, O_loc), obs_w.dtype)
    for d in range(n_dev):
        sel = obs_by_shard[d]
        n = len(sel)
        op[d, :n] = obs_point[sel] - bounds[d]  # local point index
        osr[d, :n] = obs_shot[sel]
        ouv[d, :n] = obs_uv[sel]
        ow[d, :n] = obs_w[sel]
    shards.update({"obs_point": op, "obs_shot": osr, "obs_uv": ouv, "obs_w": ow,
                   "n_obs": np.array([len(s) for s in obs_by_shard])})

    if n_shots is not None and n_dev * P_loc * n_shots <= DENSE_GRID_MAX_SLOTS:
        packs = [pack_dense_obs(op[d], osr[d], ouv[d], ow[d], P_loc, n_shots)
                 for d in range(n_dev)]
        if all(p is not None for p in packs):
            shards.update({"uv_ps": np.stack([p[0] for p in packs]),
                           "w_ps": np.stack([p[1] for p in packs]), "table_kind": "dense"})
            return shards
    tabs = [build_track_table(op[d], ow[d], P_loc) for d in range(n_dev)]
    L = max(t.shape[1] for t in tabs)
    tab = np.full((n_dev, P_loc, L), -1, np.int32)
    for d in range(n_dev):
        tab[d, :, : tabs[d].shape[1]] = tabs[d]
    shards.update({"track_tab": tab, "table_kind": "track"})
    return shards


def run_bundle_adjustment_sharded(
    points: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    cam_of_shot: np.ndarray,
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    intr_mask: np.ndarray,
    pose_free: np.ndarray | None = None,
    config: BAConfig | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> dict:
    """Distributed LM bundle adjustment over the shards, with
    run_bundle_adjustment's arguments and result dict. Work runs in `dtype`
    on each shard's device: each device of the mesh `device` (the JAX
    package's mesh: a Mesh or a resolve_devices spec; default every
    visible card; under torchrun the rank's device)."""
    shards = Shards(device)
    check_agree("run_bundle_adjustment_sharded", points, poses, intr, cam_of_shot, obs_point,
                obs_shot, obs_uv, obs_w, intr_mask, pose_free)
    n_shots = poses.shape[0]
    sh = shard_scene_by_points(shards.count, points, obs_point, obs_shot, obs_uv, obs_w,
                               n_shots=n_shots)
    P_loc = sh["points"].shape[1]

    def one(shard):
        d, dev = shard.index, shard.device
        n_loc = int((sh["point_ids"][d] >= 0).sum())
        n_obs = int(sh["n_obs"][d])
        if sh["table_kind"] == "dense":
            grid, tab = (sh["uv_ps"][d][:n_loc], sh["w_ps"][d][:n_loc]), None
        else:
            grid, tab = None, sh["track_tab"][d][:n_loc]
        pts, pos, K, cost, it, conv, lam, table_kind = lm_solve(
            sh["points"][d][:n_loc], poses, intr, cam_of_shot, sh["obs_point"][d][:n_obs],
            sh["obs_shot"][d][:n_obs], sh["obs_uv"][d][:n_obs], sh["obs_w"][d][:n_obs],
            intr_mask, pose_free, grid, tab, config, dtype, dev, reduce=shard.all_reduce_sum)
        block = torch.zeros((P_loc, 3), dtype=pts.dtype, device=dev)
        block[:n_loc] = pts
        return (shard.all_gather_cat(block).cpu().numpy(), shard.broadcast(pos).cpu().numpy(),
                shard.broadcast(K).cpu().numpy(), float(cost), it, bool(conv), float(lam),
                table_kind)

    gathered, pos, K, cost, it, conv, lam, table_kind = shards.run(one)[0]
    # scatter every shard's points back to global order
    gathered = gathered.reshape(shards.count, P_loc, 3)
    out_points = np.array(points, copy=True)
    for d in range(shards.count):
        ids = sh["point_ids"][d]
        out_points[ids[ids >= 0]] = gathered[d][ids >= 0]
    return {
        "points": out_points,
        "poses": pos.astype(poses.dtype),
        "intrinsics": K.astype(intr.dtype),
        "cost": cost,
        "iterations": it,
        "converged": conv,
        "lambda": lam,
        "table_kind": table_kind,
    }
