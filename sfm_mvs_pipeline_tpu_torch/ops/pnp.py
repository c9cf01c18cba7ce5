"""Batched RANSAC PnP (3D->2D pose) + Gauss-Newton polish.

Port of sfm_mvs_pipeline_tpu/ops/pnp.py, the stand-in for
cv::solvePnPRansac (ref: SfM.cpp:453-489). Half the hypotheses come from
the 6-point DLT (rotation projected onto SO(3)), half from a 4-point
plane-homography solver that stays exact on coplanar maps (two sign
branches each). Scoring is the full-distortion reprojection error in
pixels; the winner is polished by Gauss-Newton on its inliers, on a CUDA
card one graph replay a step (utils/step_graph.py).
"""

from __future__ import annotations

import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import project_points, undistort_points
from sfm_mvs_pipeline_tpu_torch.ops.homography import _dlt_h
from sfm_mvs_pipeline_tpu_torch.ops.pose import rotmat_to_aa
from sfm_mvs_pipeline_tpu_torch.ops.ransac import (
    eigh_min_vector,
    safe_svd,
    sample_valid_indices,
    select_best,
    take,
)
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import count
from sfm_mvs_pipeline_tpu_torch.utils.step_graph import StepGraph


def _so3_project(M: torch.Tensor):
    """Nearest rotation U diag(1, 1, det) Vt of (..., 3, 3); returns (R, s, det)."""
    U, s, Vt = safe_svd(M)
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (U * d[..., None, :]) @ Vt, s, det


def _dlt_pnp(X: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """6+ point DLT for P = [R|t] from world points X (..., M, 3) and
    normalized image coords xy (..., M, 2). Returns poses (..., 6)."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -x * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -y * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    p = eigh_min_vector(A.transpose(-1, -2) @ A)
    p = p.reshape(p.shape[:-1] + (3, 4))
    # sign: points in front of the camera for the majority
    depths = torch.sum(Xh * p[..., None, 2, :], dim=-1)
    p = p * torch.sign(torch.sum(torch.sign(depths), dim=-1) + 0.5)[..., None, None]
    R, s, det = _so3_project(p[..., :3])
    scale = torch.sum(s, dim=-1) / 3.0
    t = p[..., 3] / torch.clamp(scale, min=1e-12)[..., None] * det[..., None]
    return torch.cat([rotmat_to_aa(R), t], dim=-1)


def _planar_pnp(X: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """4-point plane-homography pose, both sign branches: the sample in an
    in-plane frame, the plane->image homography H ~ [R b1, R b2, R c + t],
    pose read off its columns and orthonormalised. X (..., M, 3),
    xy (..., M, 2) -> (..., 2, 6)."""
    c = torch.mean(X, dim=-2)
    A = X - c[..., None, :]
    _, _, Vt = safe_svd(A, full_matrices=True)
    b1, b2 = Vt[..., 0, :], Vt[..., 1, :]
    n = torch.linalg.cross(b1, b2)
    En = torch.stack([b1, b2, n], dim=-1)  # (..., 3, 3) plane frame
    uv = A @ En[..., :, :2]
    H = _dlt_h(uv, xy)
    s = 2.0 / torch.clamp(
        torch.linalg.norm(H[..., :, 0], dim=-1) + torch.linalg.norm(H[..., :, 1], dim=-1), min=1e-12
    )

    def pose_from(Hs):
        r1, r2 = Hs[..., :, 0], Hs[..., :, 1]
        M = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
        R0, _, _ = _so3_project(M)
        R = R0 @ En.transpose(-1, -2)
        t = Hs[..., :, 2] - (R @ c[..., None])[..., 0]
        return torch.cat([rotmat_to_aa(R), t], dim=-1)

    sH = s[..., None, None] * H
    return torch.stack([pose_from(sH), pose_from(-sH)], dim=-2)


def _reproj_residuals_px(pose, intr, X, uv):
    """Pixel reprojection errors; points behind the camera get inf."""
    uv_hat, z = project_points(pose, intr, X)
    r = torch.linalg.norm(uv_hat - uv, dim=-1)
    return torch.where(z > 0, r, torch.full_like(r, float("inf")))


def _gn_polish(pose, X, uv, intr, w, gn_iters: int) -> None:
    """Gauss-Newton polish of `pose` (6,) in place on the points weighted
    by `w` (the inliers): `gn_iters` steps of 6 dof, each accepted only if
    the cost decreases. A step is one in-place update of `pose` with no
    host read; where _graph_engages it is captured once as a CUDA graph
    and replayed for every step, elsewhere called eagerly, with the same
    launches and so the same bits."""

    def residual_vec(p):
        uv_hat, _ = project_points(p, intr, X)
        return ((uv_hat - uv) * w[:, None]).reshape(-1)

    eye = torch.eye(6, dtype=X.dtype, device=X.device)

    def step():
        J = torch.func.jacfwd(residual_vec)(pose).to(X.dtype)  # (2N, 6)
        r = residual_vec(pose)
        H = J.T @ J + 1e-6 * eye
        dp = torch.linalg.solve_ex(H, J.T @ r)[0]
        p_new = pose - dp
        better = torch.sum(residual_vec(p_new) ** 2) < torch.sum(r**2)
        pose.copy_(torch.where(better, p_new, pose))

    graph = StepGraph(step, X.device, _warm_solve) if _graph_engages(X.device, gn_iters) else None
    run = step if graph is None else graph
    try:
        for _ in range(gn_iters):
            run()
    finally:
        if graph is not None:
            graph.close()
    count("pnp gn steps", gn_iters)
    if graph is not None:
        count("pnp graph steps", gn_iters)


def _graph_engages(dev: torch.device, gn_iters: int) -> bool:
    """Whether the polish replays its step as a CUDA graph: on a CUDA
    device, with a step to take."""
    return dev.type == "cuda" and gn_iters > 0


def _warm_solve() -> None:
    """The cuBLAS and cuSOLVER handles and workspaces of the step's
    matmuls and solve_ex, made eagerly on the current stream."""
    eye = torch.eye(6, device=torch.cuda.current_device())
    torch.linalg.solve_ex(eye @ eye, eye[:, 0])


def solve_pnp_ransac(
    rng,
    X: torch.Tensor,  # (N, 3) world points
    uv: torch.Tensor,  # (N, 2) pixel observations
    intr: torch.Tensor,  # (7,)
    valid: torch.Tensor,  # (N,) bool
    thresh_px,
    k_hyp: int = 256,
    gn_iters: int = 10,
):
    """Batched-hypothesis RANSAC PnP. Returns (pose6, inlier mask, inlier
    ratio = inliers / valid count, the quantity compared against
    -Ppose-inlier-ratio-threshold; SfM.cpp:481-484).

    `rng`: a torch.Generator, or the pair of uniform draws
    ((k_hyp // 2, 6) for the DLT family, ((k_hyp - k_hyp // 2) // 2, 4)
    for the planar family).

    The polish's `gn_iters` Gauss-Newton steps go to the "pnp gn steps"
    counter, and where they were replayed from a CUDA graph also to "pnp
    graph steps"; each call adds one to "pnp solves" (utils/stage_timer.py)."""
    count("pnp solves")
    xy = undistort_points(intr, uv)
    k_dlt = k_hyp // 2
    k_pl = (k_hyp - k_dlt) // 2  # planar samples emit 2 poses each
    rng_d, rng_p = rng if isinstance(rng, (tuple, list)) else (rng, rng)
    idx = sample_valid_indices(rng_d, valid, k_dlt, 6)
    poses_dlt = _dlt_pnp(take(X, idx), take(xy, idx))
    idx4 = sample_valid_indices(rng_p, valid, k_pl, 4)
    poses_pl = _planar_pnp(take(X, idx4), take(xy, idx4))
    poses = torch.cat([poses_dlt, poses_pl.reshape(-1, 6)])
    res = _reproj_residuals_px(poses, intr, X, uv)  # (K, N)
    pose, mask, _ = select_best(poses, res, valid, thresh_px)

    pose = pose.clone()  # the polish's state, updated in place
    _gn_polish(pose, X, uv, intr, mask.to(X.dtype), gn_iters)

    res_final = _reproj_residuals_px(pose, intr, X, uv)
    mask = (res_final <= thresh_px) & valid & torch.isfinite(res_final)
    ratio = torch.sum(mask).to(X.dtype) / torch.clamp(torch.sum(valid), min=1).to(X.dtype)
    return pose, mask, ratio
