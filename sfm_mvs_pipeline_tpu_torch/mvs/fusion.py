"""Depth-map fusion: multi-view consistency filtering -> dense point cloud.

Port of sfm_mvs_pipeline_tpu/mvs/fusion.py (openMVS's depth-map fusion,
ref: src/photogrammetrie/mvs/MVS.cpp:112-127, with the reference's 3-view
fusion-inlier requirement, MVS.h:62).

Per reference view: unproject valid depths to world points, reproject into
every other view, count views whose own depth map agrees within a relative
tolerance; keep points with >= min_views agreement; consume the agreeing
pixels so later views don't re-emit duplicates. Normals from depth-map
gradients, colors from the images. The back-projection and projection run
on the device; the loop and the bookkeeping stay host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat


def unproject_depth(
    depth: torch.Tensor,  # (H, W)
    valid: torch.Tensor,  # (H, W), unused (the JAX signature)
    pose: torch.Tensor,  # (6,)
    intr: torch.Tensor,  # (7,)
):
    """Depth map -> world points (H, W, 3) + world normals (H, W, 3). The
    normals come from the cross product of the depth surface's tangents,
    `torch.gradient` (central differences inside, one-sided at the edges,
    the rule of jnp.gradient)."""
    h, w = depth.shape
    K = intrinsics_to_K(intr)
    Kinv = torch.linalg.inv(K)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    rays = pix @ Kinv.T
    pts_cam = rays * depth[..., None]

    R = aa_to_rotmat(pose[:3])
    t = pose[3:]
    C = -R.T @ t
    pts_world = pts_cam @ R + C  # R^T x + C per row

    dx = torch.gradient(pts_cam, dim=1)[0]
    dy = torch.gradient(pts_cam, dim=0)[0]
    n_cam = torch.linalg.cross(dy, dx, dim=-1)
    n_cam = n_cam / (torch.linalg.norm(n_cam, dim=-1, keepdim=True) + 1e-12)
    # orient towards the camera (negative z in camera frame)
    flip = torch.where(n_cam[..., 2:3] > 0, -1.0, 1.0)
    n_cam = n_cam * flip
    return pts_world, n_cam @ R


def project_points_depth(
    pts_world: torch.Tensor,  # (N, 3)
    pose: torch.Tensor,
    intr: torch.Tensor,
):
    """World points -> (u, v, z) in a view (pinhole: images are undistorted
    before densification, OpenMvsUtils.cpp:136-150)."""
    R = aa_to_rotmat(pose[:3])
    t = pose[3:]
    pc = pts_world @ R.T + t
    z = pc[:, 2]
    K = intrinsics_to_K(intr)
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    return u, v, z


def fuse_depth_maps(
    depth_maps: np.ndarray,  # (V, H, W)
    valids: np.ndarray,  # (V, H, W) bool
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,)
    images_rgb: np.ndarray | None = None,  # (V, H, W, 3) uint8
    min_views: int = 3,
    rel_tolerance: float = 0.01,
    log=lambda *a: None,
    device=None,
) -> dict:
    """Fuse per-view depth maps into one consistent dense cloud.

    min_views counts the reference view itself (reference default: 3-view
    fusion inliers, MVS.h:62). The (un)projections run on `device`
    (default: the card; raises without one). Returns dict(points, normals,
    colors).
    """
    from sfm_mvs_pipeline_tpu_torch import resolve_device

    dev = resolve_device(device)
    V, H, W = depth_maps.shape
    consumed = np.zeros((V, H, W), bool)
    out_pts, out_nrm, out_col = [], [], []

    d_dev = torch.as_tensor(depth_maps, dtype=torch.float32, device=dev)
    poses_dev = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    intr_dev = torch.as_tensor(intr, dtype=torch.float32, device=dev)

    for r in range(V):
        vmask = valids[r] & ~consumed[r]
        if not vmask.any():
            continue
        pts_w, nrm_w = unproject_depth(d_dev[r], None, poses_dev[r], intr_dev)
        ys, xs = np.nonzero(vmask)
        sel = torch.as_tensor(ys * W + xs, device=dev)
        P_dev = pts_w.reshape(-1, 3)[sel]
        P = P_dev.cpu().numpy()  # (N, 3)
        Nrm = nrm_w.reshape(-1, 3)[sel].cpu().numpy()

        agree = np.ones(len(P), np.int32)  # self
        agree_px: list[tuple[int, np.ndarray, np.ndarray, np.ndarray]] = []
        for n in range(V):
            if n == r:
                continue
            u, v, z = (x.cpu().numpy() for x in project_points_depth(P_dev, poses_dev[n], intr_dev))
            ui = np.round(u).astype(np.int64)
            vi = np.round(v).astype(np.int64)
            inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
            uis = np.clip(ui, 0, W - 1)
            vis = np.clip(vi, 0, H - 1)
            zn = depth_maps[n][vis, uis]
            ok = (
                inb
                & valids[n][vis, uis]
                & (np.abs(zn - z) <= rel_tolerance * np.maximum(z, 1e-9))
            )
            agree += ok.astype(np.int32)
            agree_px.append((n, ok, vis, uis))

        keep = agree >= min_views
        if not keep.any():
            continue
        out_pts.append(P[keep])
        out_nrm.append(Nrm[keep])
        if images_rgb is not None:
            out_col.append(images_rgb[r][ys[keep], xs[keep]])
        # consume agreeing pixels in other views (dedup)
        for n, ok, vis, uis in agree_px:
            s = ok & keep
            consumed[n][vis[s], uis[s]] = True
        log(f"view {r}: fused {int(keep.sum())}/{len(P)} pixels")

    if not out_pts:
        return {
            "points": np.zeros((0, 3)),
            "normals": np.zeros((0, 3)),
            "colors": np.zeros((0, 3), np.uint8),
        }
    return {
        "points": np.concatenate(out_pts),
        "normals": np.concatenate(out_nrm),
        "colors": (
            np.concatenate(out_col)
            if out_col
            else np.zeros((sum(len(p) for p in out_pts), 3), np.uint8)
        ),
    }
