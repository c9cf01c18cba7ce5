"""Incremental SfM driver: a host-side state machine over batched tensor ops.

Port of sfm_mvs_pipeline_tpu/sfm/incremental.py, after SfM::reconstructScene
(ref: SfM.cpp:143-381):

  match pairs (kernel K1, or K1x in exact mode) -> homography ratios -> baseline pair ->
  loop: pick the shot with most 3D-2D links -> PnP -> triangulate the
  adjoining pairs -> merge into tracks -> bundle adjust -> repeat

Unlike the JAX package, a start (baseline pair and loop) whose bundle
adjustment leaves bogus intrinsics is undone and started again with new
RANSAC draws (_BASELINE_ATTEMPTS).

The driver is Python; every inner computation is one batched call on the
device, with the pair axis written out where the JAX package uses vmap.
Results come back to the host once per stage (`.cpu()`), and track
bookkeeping is host numpy (models/scene.py).

In a process group of more than one rank (torchrun) every rank runs
reconstruct on the same inputs; matching runs pair-sharded and bundle
adjustment point-sharded over the ranks (parallel/), each returning the
same bits to every rank, so the ranks stay in step. In one process's mesh
of several devices matching runs pair-sharded over them and bundle
adjustment on the first.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import CAMERA_MODELS, undistort_points
from sfm_mvs_pipeline_tpu_torch.models.scene import Scene
from sfm_mvs_pipeline_tpu_torch.ops import matching as M
from sfm_mvs_pipeline_tpu_torch.ops.epipolar import (
    find_essential_ransac,
    recover_pose,
    recover_pose_from_homography,
    two_view_model_scores,
)
from sfm_mvs_pipeline_tpu_torch.ops.homography import (
    find_homography_ransac,
    homography_inlier_ratio,
)
from sfm_mvs_pipeline_tpu_torch.ops.pnp import solve_pnp_ransac
from sfm_mvs_pipeline_tpu_torch.ops.ransac import resolve_threshold, take
from sfm_mvs_pipeline_tpu_torch.ops.triangulate import triangulate_pair
from sfm_mvs_pipeline_tpu_torch.parallel.ba import run_bundle_adjustment_sharded
from sfm_mvs_pipeline_tpu_torch.parallel.matching import match_pairs_sharded
from sfm_mvs_pipeline_tpu_torch.sfm.ba import BAConfig, run_bundle_adjustment
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import count, stage


@dataclasses.dataclass
class SfMConfig:
    """Thresholds mirroring the reference defaults (SfM.h:47-58); the same
    fields and defaults as the JAX package's SfMConfig."""

    min_match_count: int = 20
    baseline_min_matches: int = 100
    ransac_matching_threshold: float = -3.0  # sign convention: <0 => abs px
    ransac_baseline_threshold: float = -1.0
    ransac_pose_threshold: float = -8.0
    min_homography_inlier_ratio: float = 0.4
    min_pose_inlier_ratio: float = 0.4
    max_reprojection_error: float = 10.0
    point_merge_distance: float = 0.01
    feature_merge_distance: float = 20.0
    lowe_ratio: float = 0.7
    distinct_matches: bool = False
    matcher_backend: str = "auto"
    matcher_method: str = "bf"
    # -Pmatch-precision=exact: the bf16x3 split of kernel K1x (dot within
    # 4.6e-5 (|q|^2 + |t|^2) of exact, 3x the tensor-core work)
    exact_match: bool = False
    # descriptors are a +-1 binary (ORB/Hamming) expansion at D = 256: K1
    # matches them in fp32, where every dot product is an integer and exact
    # (the JAX package's bf16 path is exact for the same reason), so they go
    # to K1 whatever exact_match says, as bf16 ones do in the JAX package
    binary_descriptors: bool = False
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    ba_every_view: bool = True  # the reference runs BA after every added view
    seed: int = 0


# A camera whose focal length leaves [0.1, 10] x the image's larger side, or
# any of whose distortion coefficients exceeds 1 in magnitude, is bogus
# (COLMAP's IncrementalMapper min/max_focal_length_ratio and max_extra_param).
_FOCAL_RATIO_RANGE = (0.1, 10.0)
_MAX_DISTORTION = 1.0
# starts of the reconstruction: a start whose bundle adjustment over at least
# _GUARD_MIN_VIEWS views leaves bogus intrinsics, or that triangulates no
# baseline pair, is undone and started again with the generator's next
# draws; a baseline pair that failed _TRIES_PER_PAIR starts is skipped; the
# _BASELINE_ATTEMPTS-th start skips none, is not held to the check and
# stands. The two-view adjustment is not held to it either: focal length and
# distortion are barely observable from two views, and the next adjustments
# pull a sound start back.
_BASELINE_ATTEMPTS = 6
_TRIES_PER_PAIR = 3
_GUARD_MIN_VIEWS = 3
# the Scene fields a start grows (what an abandoned start resets)
_GROWN = ("intrinsics", "poses", "recovered", "points", "point_valid", "colors", "obs_point",
          "obs_shot", "obs_feat", "obs_uv", "obs_w", "point_of_feat", "point_alias")


def bogus_intrinsics(intrinsics: np.ndarray, max_dim: float) -> np.ndarray:
    """(C,) bool: which rows of the (C, 7) intrinsics are bogus."""
    ratio = intrinsics[:, 0] / max_dim
    return ((ratio < _FOCAL_RATIO_RANGE[0]) | (ratio > _FOCAL_RATIO_RANGE[1])
            | (np.abs(intrinsics[:, 3:]) > _MAX_DISTORTION).any(axis=1))


class _BogusStart(Exception):
    """A bundle adjustment of a guarded start left bogus intrinsics."""


# bundle adjustment runs point-sharded in a process group of N > 1 ranks
# from N times this many live observations (the JAX package's threshold),
# one shard a rank on the rank's card. The cards of a one-process mesh do
# not shard it: their shards are threads that take turns at the
# interpreter lock and the jacfwd lock and meet at a barrier for every
# sum, and on four H100s that made the ORB render's SfM 2.2x slower than
# one card (PERF.md, Findings). The JAX package shards it over its whole
# mesh; parallel/ba.py::run_bundle_adjustment_sharded still takes a mesh.
_SHARDED_BA_MIN_OBS = 2048

# homography-ratio pairs per batched RANSAC call (bounds the (chunk, K, F)
# residual tensors, like the JAX package's lax.map batch of 8)
_RATIO_CHUNK = 8


def _dual_model_pose(gen, xy1, xy2, mask, thresh_norm):
    """Relative pose by E-vs-H model selection, batched over pairs.

    The 8-point essential solver is degenerate for coplanar scenes, so both
    an essential matrix and a calibrated homography are fitted and scored
    as image-to-image models (two_view_model_scores); the homography's
    Faugeras decomposition wins when S_H / (S_H + S_E) > 0.45.
    Returns (pose (B, 6), inlier mask (B, F))."""
    E, em, _ = find_essential_ransac(gen, xy1, xy2, mask, thresh_norm)
    pose_e, em2 = recover_pose(E, xy1, xy2, em)
    H, hm, _ = find_homography_ransac(gen, xy1, xy2, mask, thresh_norm)
    pose_h, hm2 = recover_pose_from_homography(H, xy1, xy2, hm, mask, thresh_norm)
    se, sh = two_view_model_scores(E, H, xy1, xy2, mask, thresh_norm)
    use_h = sh / torch.clamp(sh + se, min=1e-18) > 0.45
    return (
        torch.where(use_h[:, None], pose_h, pose_e),
        torch.where(use_h[:, None], hm2, em2),
    )


def reconstruct(
    scene: Scene,
    pairs: np.ndarray,
    config: SfMConfig | None = None,
    log=lambda *a: None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    devices=None,
) -> dict:
    """Run incremental SfM on a scene with extracted features.

    pairs: (P, 2) candidate pairs from a pair policy. The SfM state runs in
    `dtype` on the first device of the mesh `devices`, or `device` (give
    one: a Mesh or a resolve_devices spec; default every visible card;
    raises without one; under torchrun the rank's card). Matching shards
    over the mesh's devices, or over the ranks, past the JAX package's
    gate; BA shards over torchrun's ranks past its gate, and runs on the
    first device in a mesh (see _SHARDED_BA_MIN_OBS). Mutates `scene` in place; returns a
    stats dict."""
    from sfm_mvs_pipeline_tpu_torch.parallel.distributed import Shards, process_count

    cfg = config or SfMConfig()
    shards = Shards.of_entry(device, devices)
    dev = shards.first
    S, F = scene.feat_valid.shape
    w_img, h_img = scene.image_size
    max_dim = float(max(w_img, h_img))
    thr_match = resolve_threshold(cfg.ransac_matching_threshold, max_dim)
    thr_base = resolve_threshold(cfg.ransac_baseline_threshold, max_dim)
    thr_pose = resolve_threshold(cfg.ransac_pose_threshold, max_dim)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)

    # ---- 1. match all candidate pairs (one K1 launch)
    log(f"matching {len(pairs)} pairs")
    pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
    pairs_d = torch.as_tensor(pairs, device=dev)
    match = M.match_pairs_batch
    n_shards, n_ranks = shards.count, process_count()
    if n_shards > 1 and len(pairs) >= n_shards:
        log(f"pair-sharded matching over {n_shards} {shards.kind}")
        match = functools.partial(match_pairs_sharded, device=shards.devices)
    with stage("match"):
        # +-1 descriptors go as bf16, which holds them exactly, to K1's
        # tensor-core route (the JAX package's bf16 cast for its MXU)
        desc_d = torch.as_tensor(scene.descriptors, device=dev,
                                 dtype=torch.bfloat16 if cfg.binary_descriptors else torch.float32)
        midx, mmask, mdist = match(
            desc_d,
            torch.as_tensor(scene.feat_valid, device=dev),
            pairs_d,
            ratio=cfg.lowe_ratio,
            distinct=cfg.distinct_matches,
            backend=cfg.matcher_backend,
            method=cfg.matcher_method,
            with_distance=True,
            exact=cfg.exact_match and not cfg.binary_descriptors,
        )
        del desc_d
        midx_d, mmask_d = midx, mmask
        midx = midx.cpu().numpy()
        mmask = mmask.cpu().numpy()
        mdist = mdist.cpu().numpy()
    counts = mmask.sum(axis=1)
    live = counts >= cfg.min_match_count  # ref min-match filter (SfM.cpp:566-570)
    log(f"pairs with >= {cfg.min_match_count} matches: {int(live.sum())}")

    # ---- 2. homography inlier ratios (pair ordering metric), on the
    # float32 keypoints like the JAX package
    with stage("pair ratios"):
        kp32 = torch.as_tensor(scene.keypoints, dtype=torch.float32, device=dev)
        ratio_l = []
        for c in range(0, len(pairs), _RATIO_CHUNK):
            pc = pairs_d[c : c + _RATIO_CHUNK].long()
            uv1 = kp32[pc[:, 0]]
            uv2 = take(kp32[pc[:, 1]], midx_d[c : c + _RATIO_CHUNK].long()[..., None])[..., 0, :]
            ratio_l.append(
                homography_inlier_ratio(gen, uv1, uv2, mmask_d[c : c + _RATIO_CHUNK], thr_match)
            )
        ratios = torch.cat(ratio_l).cpu().numpy() if ratio_l else np.zeros(0)
    ratios = np.where(live, ratios, -1.0)

    intr_d = torch.as_tensor(scene.intrinsics, dtype=dtype, device=dev)
    kp_d = torch.as_tensor(scene.keypoints, dtype=dtype, device=dev)

    pair_matches = {}  # (a, b) -> (idx_a, idx_b, match distance), compact
    for k_, (a, b) in enumerate(pairs):
        if live[k_]:
            q = np.nonzero(mmask[k_])[0]
            pair_matches[(int(a), int(b))] = (q.astype(np.int32), midx[k_][q], mdist[k_][q])

    stats = {"baseline": None, "ba_runs": 0, "views": 0}
    guard = False  # run_ba raises _BogusStart on bogus intrinsics while set

    @stage("ba")
    def adjust() -> dict:
        """One bundle adjustment of the scene as it stands, logged."""
        model = CAMERA_MODELS[scene.camera_model]
        imask = np.zeros((len(scene.intrinsics), 7))
        imask[:, list(model.opt_mask)] = 1.0
        n_live = max(int((scene.obs_w > 0).sum()), 1)
        # point-sharded over torchrun's ranks above the JAX package's
        # threshold of 2048 live observations a rank (see _SHARDED_BA_MIN_OBS)
        sharded = shards.ranks and n_live >= _SHARDED_BA_MIN_OBS * n_ranks
        out = (run_bundle_adjustment_sharded if sharded else run_bundle_adjustment)(
            scene.points.astype(np.float64),
            scene.poses,
            scene.intrinsics,
            scene.cam_of_shot,
            scene.obs_point,
            scene.obs_shot,
            scene.obs_uv.astype(np.float64),
            scene.obs_w.astype(np.float64),
            imask,
            pose_free=scene.recovered.astype(np.float64),
            config=cfg.ba,
            dtype=dtype,
            device=dev,
        )
        stats["ba_runs"] += 1
        stats["table_kind"] = out["table_kind"]
        log(  # an abandoned start's adjustments are logged too
            f"BA #{stats['ba_runs']}: cost {out['cost']:.3g} "
            f"({out['iterations']} iters, rms "
            f"{np.sqrt(2 * out['cost'] / n_live):.3f} px, table {out['table_kind']})"
            + (f", point-sharded over {n_ranks} ranks" if sharded else "")
        )
        return out

    def run_ba():
        nonlocal intr_d
        out = adjust()  # the guard raises after the "ba" span has ended
        if (guard and scene.recovered.sum() >= _GUARD_MIN_VIEWS
                and bogus_intrinsics(out["intrinsics"], max_dim).any()):
            raise _BogusStart(np.round(out["intrinsics"][:, :5], 3).tolist())
        scene.points = out["points"]
        scene.poses = out["poses"]
        scene.intrinsics = out["intrinsics"]
        # later PnP / pair poses / triangulations must see the intrinsics
        # the points were just optimised under
        intr_d = torch.as_tensor(scene.intrinsics, dtype=dtype, device=dev)

    def _full_idx(a, b):
        ia, ib, _ = pair_matches[(a, b)]
        idx = np.zeros(F, np.int32)
        idx[ia] = ib
        return idx

    def _full_mask(a, b):
        ia, _, _ = pair_matches[(a, b)]
        mask = np.zeros(F, bool)
        mask[ia] = True
        return mask

    def _full_dist(a, b):
        ia, _, dd = pair_matches[(a, b)]
        dist = np.full(F, np.inf, np.float64)
        dist[ia] = dd
        return dist

    @stage("pair pose")
    def pairs_fused(pair_list, use_rel, thresh):
        """E-vs-H pose + triangulation for a set of pairs in one batched
        call. Returns host (pose_rel, em, pts, keep, n_inl, masks)."""
        A = np.asarray([p[0] for p in pair_list])
        B = np.asarray([p[1] for p in pair_list])
        idxs = torch.as_tensor(np.stack([_full_idx(a, b) for a, b in pair_list]), device=dev)
        masks = np.stack([_full_mask(a, b) for a, b in pair_list])
        mask_d = torch.as_tensor(masks, device=dev)
        A_d = torch.as_tensor(A, device=dev)
        B_d = torch.as_tensor(B, device=dev)
        cam_d = torch.as_tensor(scene.cam_of_shot, device=dev).long()
        intr_a = intr_d[cam_d[A_d]]
        intr_b = intr_d[cam_d[B_d]]
        uv1 = kp_d[A_d]
        uv2 = take(kp_d[B_d], idxs.long()[..., None])[..., 0, :]
        xy1 = undistort_points(intr_a, uv1)
        xy2 = undistort_points(intr_b, uv2)
        pose_rel, em = _dual_model_pose(gen, xy1, xy2, mask_d, thresh / intr_a[:, 0])
        if use_rel:
            pa = torch.zeros_like(pose_rel)
            pb = pose_rel
        else:
            pa = torch.as_tensor(scene.poses[A], dtype=dtype, device=dev)
            pb = torch.as_tensor(scene.poses[B], dtype=dtype, device=dev)
        pts, keep, _ = triangulate_pair(
            pa, pb, intr_a, intr_b, uv1, uv2, valid=em,
            max_reprojection_error=cfg.max_reprojection_error,
        )
        return (
            pose_rel.cpu().numpy().astype(np.float64), em.cpu().numpy(),
            pts.cpu().numpy().astype(np.float64), keep.cpu().numpy(),
            em.sum(dim=1).cpu().numpy(), masks,
        )

    @stage("tracks")
    def merge_pair_points(a, b, pts, keep):
        """Host-side track bookkeeping for one pair's triangulated points
        (the reference's mergePointcloudElement3d2d; Scene.cpp:470-561)."""
        idx_b = _full_idx(a, b)
        i_all = np.nonzero(keep)[0]
        j_all = idx_b[i_all]
        pa = scene.point_of_feat[a, i_all]
        pb = scene.point_of_feat[b, j_all]

        # extend the track on the untracked side
        ext_a = (pb >= 0) & (pa < 0)
        ext_b = (pa >= 0) & (pb < 0)
        if ext_a.any():
            scene.add_observations(
                pb[ext_a], np.full(ext_a.sum(), a), i_all[ext_a],
                scene.keypoints[a, i_all[ext_a]],
            )
        if ext_b.any():
            scene.add_observations(
                pa[ext_b], np.full(ext_b.sum(), b), j_all[ext_b],
                scene.keypoints[b, j_all[ext_b]],
            )

        # brand-new tracks
        new = (pa < 0) & (pb < 0)
        i_new = i_all[new]
        j_new = j_all[new]
        n_new = len(i_new)
        if n_new:
            pids = np.arange(scene.n_points, scene.n_points + n_new, dtype=np.int32)
            scene.points = np.concatenate([scene.points, pts[i_new]])
            scene.point_valid = np.concatenate([scene.point_valid, np.ones(n_new, bool)])
            scene.colors = np.concatenate([scene.colors, np.zeros((n_new, 4), np.uint8)])
            scene.obs_point = np.concatenate([scene.obs_point, pids, pids])
            scene.obs_shot = np.concatenate(
                [scene.obs_shot, np.full(n_new, a, np.int32), np.full(n_new, b, np.int32)]
            )
            scene.obs_feat = np.concatenate([scene.obs_feat, i_new, j_new])
            scene.obs_uv = np.concatenate(
                [scene.obs_uv, scene.keypoints[a, i_new], scene.keypoints[b, j_new]]
            )
            scene.obs_w = np.concatenate([scene.obs_w, np.ones(2 * n_new, np.float32)])
            scene.point_of_feat[a, i_new] = pids
            scene.point_of_feat[b, j_new] = pids

        # track fusion: a match linking two existing tracks merges them when
        # the 3D distance <= point_merge_distance AND the linking match's
        # descriptor distance <= feature_merge_distance (Scene.cpp:483, :532)
        n_fused = 0
        both = (pa >= 0) & (pb >= 0) & (pa != pb)
        if both.any() and cfg.point_merge_distance > 0:
            dist_full = _full_dist(a, b)
            for ii in np.nonzero(both)[0]:
                p, q = int(pa[ii]), int(pb[ii])
                while not scene.point_valid[p] and scene.point_alias.get(p) is not None:
                    p = scene.point_alias[p]
                while not scene.point_valid[q] and scene.point_alias.get(q) is not None:
                    q = scene.point_alias[q]
                if p == q or not (scene.point_valid[p] and scene.point_valid[q]):
                    continue
                if dist_full[i_all[ii]] > cfg.feature_merge_distance:
                    continue
                if np.linalg.norm(scene.points[p] - scene.points[q]) > cfg.point_merge_distance:
                    continue
                if q < p:  # the older point survives
                    p, q = q, p
                sel = np.nonzero((scene.obs_point == q) & (scene.obs_w > 0))[0]
                scene.obs_point[sel] = p
                for o in sel:
                    scene.point_of_feat[scene.obs_shot[o], scene.obs_feat[o]] = p
                scene.point_valid[q] = False
                scene.point_alias[q] = p
                n_fused += 1
        return n_new, int(ext_a.sum() + ext_b.sum()) + n_fused

    def grow(skip: set) -> bool:
        """One start: the baseline pair (pairs in `skip` excluded), then the
        incremental loop. False when no baseline pair triangulates."""
        # ---- 3. baseline pair (ref: SfM.cpp:176-245)
        order = [
            k_
            for k_ in np.argsort(ratios, kind="stable")
            if live[k_]
            and tuple(int(v) for v in pairs[k_]) not in skip
            and ratios[k_] >= cfg.min_homography_inlier_ratio
            and counts[k_] >= cfg.baseline_min_matches
        ]
        if not order:  # fall back: any live pair ordered by ratio
            order = [k_ for k_ in np.argsort(ratios, kind="stable") if live[k_] and ratios[k_] >= 0
                     and tuple(int(v) for v in pairs[k_]) not in skip]
        baseline_found = False
        # speculative batch: pose + triangulation for up to 8 candidates in one
        # call; the host walks the results in order
        for start in range(0, len(order), 8):
            chunk = order[start : start + 8]
            cand_pairs = [(int(pairs[k_][0]), int(pairs[k_][1])) for k_ in chunk]
            pose_rel_c, _, pts_c, keep_c, n_inl_c, masks_c = pairs_fused(
                cand_pairs, use_rel=True, thresh=thr_base
            )
            for j, (k_, (a, b)) in enumerate(zip(chunk, cand_pairs)):
                log(f"trying baseline pair ({a}, {b}) ratio={ratios[k_]:.3f}")
                pose_ratio = n_inl_c[j] / max(masks_c[j].sum(), 1)
                if pose_ratio < cfg.min_pose_inlier_ratio:
                    log(f"pose inlier ratio too low: {pose_ratio:.3f}")
                    continue
                scene.poses[a] = 0.0
                scene.poses[b] = pose_rel_c[j]
                scene.recovered[a] = True
                scene.recovered[b] = True
                n_new, _ = merge_pair_points(a, b, pts_c[j], keep_c[j])
                log(f"baseline ({a}, {b}): {n_new} points")
                queue.discard((a, b))
                done_pairs.append((a, b))
                stats["baseline"] = (a, b)
                stats["views"] = 2
                baseline_found = True
                break
            if baseline_found:
                break
        if not baseline_found:
            log("no baseline pair could be triangulated")
            return False
        run_ba()

        # ---- 4. incremental loop (ref: SfM.cpp:247-375)
        while queue:
            remaining_shots = sorted({s for p in queue for s in p if not scene.recovered[s]})
            if not remaining_shots:
                break
            best_shot, best_n, best_corr = -1, -1, None
            with stage("tracks"):
                for s in remaining_shots:
                    pids, fids, uv = scene.find_2d3d(s, pair_matches)
                    if len(pids) > best_n:
                        best_shot, best_n, best_corr = s, len(pids), (pids, fids, uv)
            if best_n <= 0:
                break
            s = best_shot
            pids, fids, uv = best_corr
            log(f"registering shot {s} with {best_n} 3D-2D correspondences")

            # PnP (ref: findCameraPoseFrom3d2dMatch, SfM.cpp:478)
            X = torch.as_tensor(scene.points[pids], dtype=dtype, device=dev)
            U = torch.as_tensor(uv, dtype=dtype, device=dev)
            V = torch.ones(len(pids), dtype=torch.bool, device=dev)
            intr_s = intr_d[int(scene.cam_of_shot[s])]
            with stage("pnp"):
                try:
                    pose, inl, ratio = solve_pnp_ransac(gen, X, U, intr_s, V, thr_pose, k_hyp=256)
                    ratio = float(ratio)
                except torch.linalg.LinAlgError as e:
                    log(f"PnP failed: {e}")
                    ratio = -1.0
            if ratio < cfg.min_pose_inlier_ratio:
                log(f"pose inlier ratio too low ({ratio:.3f}); dropping shot {s}")
                for p in [p for p in queue if s in p]:
                    queue.discard(p)
                    failed_pairs.append(p)
                continue
            scene.poses[s] = pose.cpu().numpy().astype(np.float64)
            scene.recovered[s] = True
            stats["views"] += 1

            # register the PnP inlier correspondences as observations of the new
            # view (one per feature, untracked feature, live point), so BA
            # constrains the new pose even when adjoining pairs contribute little
            sel = np.nonzero(inl.cpu().numpy())[0]
            with stage("tracks"):
                if len(sel):
                    p_sel = np.asarray(pids)[sel]
                    f_sel = np.asarray(fids)[sel]
                    f_sel, first = np.unique(f_sel, return_index=True)
                    p_sel = p_sel[first]
                    ok = scene.point_valid[p_sel] & (scene.point_of_feat[s, f_sel] < 0)
                    if ok.any():
                        scene.add_observations(
                            p_sel[ok], np.full(int(ok.sum()), s), f_sel[ok],
                            scene.keypoints[s, f_sel[ok]],
                        )

            # adjoining recovered pairs (ref: SfM.cpp:333-371), in one call
            adjoining = [
                p for p in sorted(queue)
                if s in p and scene.recovered[p[0]] and scene.recovered[p[1]]
            ]
            if adjoining:
                _, _, pts_c, keep_c, _, _ = pairs_fused(adjoining, use_rel=False, thresh=thr_base)
                for j, (a, b) in enumerate(adjoining):
                    n_new, n_ext = merge_pair_points(a, b, pts_c[j], keep_c[j])
                    log(f"pair ({a}, {b}): +{n_new} points, +{n_ext} track extensions")
                    queue.discard((a, b))
                    done_pairs.append((a, b))
            # collapse unlinked duplicate tracks by 3D distance
            # (mergePointcloudElement, Scene.cpp:435-468)
            with stage("tracks"):
                n_spatial = scene.merge_close_points(cfg.point_merge_distance)
            if n_spatial:
                log(f"spatial merge: {n_spatial} duplicate tracks collapsed")
            if cfg.ba_every_view:
                run_ba()
        if not cfg.ba_every_view:
            run_ba()

        return True

    # a wrong two-view start (the twin of a planar scene's homography
    # decomposition, a reversed baseline), which bundle adjustment fits by
    # bending the lens model, is undone and started again (COLMAP's
    # bogus-camera check and retried initialisation)
    fresh = {k: copy.deepcopy(getattr(scene, k)) for k in _GROWN}
    failed_starts = collections.Counter()
    attempt = 0
    while True:
        attempt += 1
        count("sfm starts")
        guard = attempt < _BASELINE_ATTEMPTS
        skip = {p for p, n in failed_starts.items() if n >= _TRIES_PER_PAIR} if guard else set()
        for k, v in fresh.items():
            setattr(scene, k, copy.deepcopy(v))
        intr_d = torch.as_tensor(scene.intrinsics, dtype=dtype, device=dev)
        stats.update(baseline=None, ba_runs=0, views=0, attempts=attempt)
        queue = {(int(a), int(b)) for k_, (a, b) in enumerate(pairs) if live[k_]}
        done_pairs, failed_pairs = [], []
        try:
            if grow(skip):
                break
            if not guard:
                return stats
            log("no baseline pair triangulated; starting again with new draws")
        except _BogusStart as e:
            log(f"start from baseline {stats['baseline']} abandoned: bundle adjustment left "
                f"bogus intrinsics {e}")
            failed_starts[stats["baseline"]] += 1

    stats["points"] = scene.n_points
    stats["observations"] = scene.n_obs
    stats["recovered"] = int(scene.recovered.sum())
    stats["done_pairs"] = len(done_pairs)
    stats["failed_pairs"] = len(failed_pairs)
    return stats
