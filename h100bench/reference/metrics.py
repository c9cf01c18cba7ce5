# Frozen copy of sfm_mvs_pipeline_tpu_torch/utils/metrics.py at commit
# c39858ae74ef4e5e9718c7b51256d4a817b4f69c (identical to
# sfm_mvs_pipeline_tpu/utils/metrics.py there): the sim(3) alignment and the
# trajectory comparison that judge the recovered poses. Do not edit.
"""Evaluation metrics: similarity alignment + absolute trajectory error.

SfM reconstructions are defined up to a global similarity (gauge); comparing
two camera trajectories therefore first solves the Umeyama sim(3) alignment
and then reports RMS camera-center error — the ATE metric named in
BASELINE.md. The reference exposes trajectories via cameras_recovered.ply
(src/cli/PhotogrammetrieCli.cpp:119); we compare center sets directly.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform s*R @ src + t ~= dst.

    src, dst: (N, 3). Returns (R, t, s).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(
    est_centers: np.ndarray, ref_centers: np.ndarray, with_scale: bool = True
) -> float:
    """RMS absolute trajectory error after sim(3) alignment. (N, 3) inputs."""
    if len(est_centers) < 3:
        raise ValueError("need >= 3 camera centers for alignment")
    R, t, s = umeyama_alignment(est_centers, ref_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - ref_centers) ** 2).sum(axis=1).mean()))


def trajectory_compare(
    est_centers: np.ndarray,
    est_rotations: np.ndarray,
    ref_centers: np.ndarray,
    ref_rotations: np.ndarray,
) -> dict:
    """Trajectory comparison: center-ATE after sim(3) + relative rotations.

    With few cameras (the insel configs have 3, nearly collinear)
    center-ATE alone is weak: the Umeyama rotation is unconstrained about
    the line of centers, so absolute orientation comparison through that
    alignment is meaningless. Relative rotations R_i R_j^T are GAUGE-FREE —
    they need no alignment at all — so the angular check compares every
    camera pair's relative rotation between the two reconstructions:
    angle( (R_i^est R_j^est^T) (R_i^ref R_j^ref^T)^T ).

    est_rotations/ref_rotations: (N, 3, 3) world-to-camera rotations.
    Returns ate_rmse, per-camera center errors, mean/max relative-rotation
    angle (degrees), and the alignment scale.
    """
    R, t, s = umeyama_alignment(est_centers, ref_centers)
    aligned = (s * (R @ est_centers.T)).T + t
    errs = np.linalg.norm(aligned - ref_centers, axis=1)
    angs = []
    n = len(est_rotations)
    for i in range(n):
        for j in range(i + 1, n):
            rel_e = est_rotations[i] @ est_rotations[j].T
            rel_r = ref_rotations[i] @ ref_rotations[j].T
            d = rel_e @ rel_r.T
            c = np.clip((np.trace(d) - 1.0) / 2.0, -1.0, 1.0)
            angs.append(np.degrees(np.arccos(c)))
    angs = np.asarray(angs) if angs else np.zeros(1)
    return {
        "ate_rmse": float(np.sqrt((errs**2).mean())),
        "center_errors": errs,
        "mean_rel_rot_deg": float(angs.mean()),
        "max_rel_rot_deg": float(angs.max()),
        "scale": s,
    }
