"""Bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of sfm_mvs_pipeline_tpu/sfm/ba.py, the stand-in for the reference's
Ceres setup (AutoDiff residual per observation over point[3] / pose[6] /
intrinsics blocks, LM + DENSE_SCHUR; ref: BundleAdjustment.cpp:50-93).

Residuals r = project(pose[shot], intr[cam], X[point]) - uv, weighted.
The normal equations eliminate the points (block-diagonal 3x3 Hpp) and the
reduced camera system (D = 6 S + 7 C) is solved by an equilibrated
Cholesky on the device. One LM iteration is one step function that updates
the solver's device state in place, accept/reject included, and the loop
reads one flag, the stop test, on the host after each. On one CUDA card
with the device solver the step is captured once per solve as a CUDA graph
and each iteration is one replay of it plus that read; on the CPU, with the
host solver and on the point-sharded route (parallel/ba.py) the loop calls
the step eagerly (lm_solve).

Two observation layouts, chosen per call and reported as `table_kind`:
  * "dense": a (P, S) visibility grid, Jacobians laid out point-minor —
    needs at most one live observation per (point, shot) and a bounded
    grid (DENSE_GRID_MAX_SLOTS);
  * "track": a (P, L) table of each point's observation indices — the
    general layout, taken when a point has two observations in one shot
    (possible after PnP-inlier registration, sfm/incremental.py) or the
    grid is too large.
Jacobians come from torch.func.jacfwd, as the JAX package uses jax.jacfwd.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch.func import jacfwd as _jacfwd
from torch.func import vmap

from sfm_mvs_pipeline_tpu_torch.models.cameras import (
    distort_normalized,
    normalized_to_pixels,
    project_points,
    reprojection_residuals,
)
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import count
from sfm_mvs_pipeline_tpu_torch.utils.step_graph import StepGraph

# torch's forward-mode AD levels are process-wide, not per thread: the
# shard threads of a mesh (parallel/ba.py) take their Jacobians one at a
# time
_JACFWD_LOCK = threading.Lock()


def jacfwd(fn):
    """torch.func.jacfwd(fn), one call at a time across threads."""
    jac = _jacfwd(fn)

    def locked(*args):
        with _JACFWD_LOCK:
            return jac(*args)

    return locked

# Dense (P, S) grid bound, re-derived for an 80 GB card. Each grid slot
# holds about 150 live floats during a build: the (2, 16) Jacobian and
# residual, the per-point camera row U (3 x 6 per shot) and the forward-mode
# tangents of the projection (10 seeds through ~10 intermediates). At
# 32M slots that is ~19 GB in f32 (~38 GB in f64), under half the card —
# twice the JAX package's 16M, which was sized for a 16 GB chip.
DENSE_GRID_MAX_SLOTS = 32 * 1024 * 1024


@dataclasses.dataclass
class BAConfig:
    max_iterations: int = 50
    # relative cost-decrease stop, the moral analogue of Ceres eta/func-tol
    function_tolerance: float = 1e-6
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    # "device": equilibrated Cholesky of the reduced camera system on the
    # device; "host": numpy float64 solve of it (the oracle)
    solver: str = "device"


# --------------------------------------------------------------- host tables
def build_track_table(
    obs_point: np.ndarray, obs_weight: np.ndarray, n_points: int, cap: int = 64
) -> np.ndarray:
    """(P, L) table of live observation indices per point (pad = -1);
    L = the longest live track rounded up to a power of two, capped."""
    counts = np.zeros(n_points, dtype=np.int64)
    live = obs_weight > 0
    np.add.at(counts, obs_point[live], 1)
    need = int(counts.max()) if len(counts) else 0
    L = 4
    while L < min(need, cap):
        L *= 2
    L = int(min(L, cap))
    table = np.full((n_points, L), -1, dtype=np.int32)
    live_idx = np.nonzero(live)[0]
    pts = obs_point[live_idx]
    order = np.argsort(pts, kind="stable")
    pts_sorted = pts[order]
    idx_sorted = live_idx[order]
    group_start = np.searchsorted(pts_sorted, pts_sorted, side="left")
    rank = np.arange(len(pts_sorted)) - group_start
    keep = rank < L
    table[pts_sorted[keep], rank[keep]] = idx_sorted[keep]
    return table


def pack_dense_obs(
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    n_points: int,
    n_shots: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """The observation list as a dense (P, S) grid: uv_ps (P, S, 2) and
    w_ps (P, S) (0 = not observed), or None when some (point, shot) has
    more than one live observation."""
    live = np.nonzero(obs_w > 0)[0]
    key = obs_point[live].astype(np.int64) * n_shots + obs_shot[live]
    uniq, first = np.unique(key, return_index=True)
    if len(uniq) != len(key):
        return None
    uv_ps = np.zeros((n_points, n_shots, 2), obs_uv.dtype)
    w_ps = np.zeros((n_points, n_shots), obs_w.dtype)
    rows = uniq // n_shots
    cols = uniq % n_shots
    uv_ps[rows, cols] = obs_uv[live[first]]
    w_ps[rows, cols] = obs_w[live[first]]
    return uv_ps, w_ps


# ----------------------------------------------------------- shared helpers
def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det) of (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)], -2
    )
    return adj / det[..., None, None]


def _camera_blocks(Hcc_pose, Hcc_cross, Hcc_intr, cam_of_shot, n_shots, n_cams):
    """Dense (D, D) camera Hessian from its per-shot / per-camera blocks."""
    dt, dev = Hcc_pose.dtype, Hcc_pose.device
    s_idx = torch.arange(n_shots, device=dev)
    c_idx = torch.arange(n_cams, device=dev)
    pp = torch.zeros((n_shots, 6, n_shots, 6), dtype=dt, device=dev)
    pp[s_idx, :, s_idx, :] = Hcc_pose
    ii = torch.zeros((n_cams, 7, n_cams, 7), dtype=dt, device=dev)
    ii[c_idx, :, c_idx, :] = Hcc_intr
    pi = torch.zeros((n_shots, 6, n_cams, 7), dtype=dt, device=dev)
    pi[s_idx, :, cam_of_shot, :] = Hcc_cross
    pp = pp.reshape(6 * n_shots, 6 * n_shots)
    ii = ii.reshape(7 * n_cams, 7 * n_cams)
    pi = pi.reshape(6 * n_shots, 7 * n_cams)
    return torch.cat([torch.cat([pp, pi], 1), torch.cat([pi.T, ii], 1)], 0)


def _damp(Hcc: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    diagH = torch.diagonal(Hcc)
    return Hcc + torch.diag(lam * torch.clamp(diagH, min=1e-8))


def _reduced_system(Hcc, g_full, S_corr, rhs_corr, cost, lam, reduce):
    """The damped reduced camera system (S_red, rhs, cost) from its terms.

    `reduce` (None on one rank) sums one flat buffer of the five undamped
    terms over the ranks first, as the JAX package psums them: damping a
    rank's partial Hcc would give another system."""
    if reduce is not None:
        D = g_full.shape[0]
        flat = reduce(torch.cat([Hcc.reshape(-1), g_full, S_corr.reshape(-1), rhs_corr,
                                 cost.reshape(1)]))
        Hcc, g_full, S_corr, rhs_corr, cost = torch.split(flat, [D * D, D, D * D, D, 1])
        Hcc, S_corr, cost = Hcc.reshape(D, D), S_corr.reshape(D, D), cost[0]
    return _damp(Hcc, lam) - S_corr, -g_full + rhs_corr, cost


def equilibrated_cholesky_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve S x = rhs on the device in working precision: Jacobi
    equilibration, Cholesky, one refinement step. Rows with a ~0 diagonal
    (frozen parameters) are identity-pinned. A system that is not positive
    definite yields NaNs, which the LM loop treats as a rejected step."""
    dt = S.dtype
    diag = torch.diagonal(S)
    dead = diag <= 1e-12
    d = torch.where(dead, torch.ones_like(diag), torch.rsqrt(torch.clamp(diag, min=1e-20)))
    Ss = S * d[:, None] * d[None, :]
    live2 = (~dead)[:, None] & (~dead)[None, :]
    Ss = torch.where(live2, Ss, torch.zeros_like(Ss)) + torch.diag(dead.to(dt))
    b = torch.where(dead, torch.zeros_like(rhs), rhs * d)
    L, info = torch.linalg.cholesky_ex(Ss)

    def solve(v):
        y = torch.linalg.solve_triangular(L, v[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    x = solve(b)
    x = x + solve(b - Ss @ x)  # one refinement step in the equilibrated frame
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return x * d


def _host_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The "host" solver: numpy float64 solve with frozen rows pinned."""
    S_np = S.double().cpu().numpy()
    rhs_np = rhs.double().cpu().numpy()
    diag0 = np.abs(np.diag(S_np)) < 1e-12
    S_np[diag0, :] = 0.0
    S_np[:, diag0] = 0.0
    S_np[diag0, diag0] = 1.0
    rhs_np[diag0] = 0.0
    try:
        dcam = np.linalg.solve(S_np, rhs_np)
    except np.linalg.LinAlgError:
        dcam = np.linalg.lstsq(S_np, rhs_np, rcond=None)[0]
    return torch.as_tensor(dcam, dtype=S.dtype, device=S.device)


# ------------------------------------------------- observation-list (track)
def compute_residuals(points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w):
    """Weighted residuals (O, 2) and total cost 0.5 * sum r^2."""
    X = points[obs_point]
    pose = poses[obs_shot]
    K = intr[cam_of_shot[obs_shot]]
    r = reprojection_residuals(pose, K, X[:, None], obs_uv[:, None])[:, 0]
    r = r * obs_w[:, None]
    return r, 0.5 * torch.sum(r * r)


def _obs_jacobians(points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w):
    """Per-observation Jacobians over the packed 16-vector (point | pose |
    intr): Jp (O,2,3), Jc (O,2,6), Ji (O,2,7), r (O,2)."""

    def packed(z, uv, w):
        return reprojection_residuals(z[3:9], z[9:16], z[None, :3], uv[None])[0] * w

    z = torch.cat([points[obs_point], poses[obs_shot], intr[cam_of_shot[obs_shot]]], dim=1)
    r = vmap(packed)(z, obs_uv, obs_w)
    J = vmap(jacfwd(packed))(z, obs_uv, obs_w).to(z.dtype)  # (O, 2, 16)
    return J[:, :, :3], J[:, :, 3:9], J[:, :, 9:16], r


def ba_build_track(points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv,
                   obs_w, track_tab, lam, intr_mask, pose_free, n_shots, n_cams, reduce=None):
    """Schur-reduced camera system on the (P, L) track table. Returns
    (S_red (D, D), rhs (D,), back-substitution closure dcam -> (dX, dpose,
    dintr), cost); `reduce` as in _reduced_system."""
    dt, dev = points.dtype, points.device
    P = points.shape[0]
    D = 6 * n_shots + 7 * n_cams
    Jp, Jc, Ji, r = _obs_jacobians(
        points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w
    )
    obs_cam = cam_of_shot[obs_shot]
    Ji = Ji * intr_mask[obs_cam][:, None, :]
    Jc = Jc * pose_free[obs_shot][:, None, None]
    cost = 0.5 * torch.sum(r * r)

    O = obs_shot.shape[0]
    oh_s = (obs_shot[:, None] == torch.arange(n_shots, device=dev)[None, :]).to(dt)
    oh_c = (obs_cam[:, None] == torch.arange(n_cams, device=dev)[None, :]).to(dt)
    flat_s = torch.cat(
        [
            torch.einsum("oai,oaj->oij", Jc, Jc).reshape(O, 36),
            torch.einsum("oai,oaj->oij", Jc, Ji).reshape(O, 42),
            torch.einsum("oai,oa->oi", Jc, r),
        ],
        dim=1,
    )
    red_s = torch.einsum("os,ok->sk", oh_s, flat_s)
    flat_c = torch.cat(
        [torch.einsum("oai,oaj->oij", Ji, Ji).reshape(O, 49), torch.einsum("oai,oa->oi", Ji, r)],
        dim=1,
    )
    red_c = torch.einsum("oc,ok->ck", oh_c, flat_c)
    Hcc = _camera_blocks(
        red_s[:, :36].reshape(n_shots, 6, 6), red_s[:, 36:78].reshape(n_shots, 6, 7),
        red_c[:, :49].reshape(n_cams, 7, 7), cam_of_shot, n_shots, n_cams,
    )
    g_full = torch.cat([red_s[:, 78:84].reshape(-1), red_c[:, 49:56].reshape(-1)])

    Wc = torch.einsum("oai,oaj->oij", Jp, Jc)  # (O, 3, 6)
    Wi = torch.einsum("oai,oaj->oij", Jp, Ji)  # (O, 3, 7)
    slots = track_tab.shape[1]
    budget = 32 * 1024 * 1024
    per_point = max(slots * 27, 6 * D)
    ch = 1024
    while ch * 2 <= P and (ch * 2) * per_point <= budget:
        ch *= 2
    S_corr = torch.zeros((D, D), dtype=dt, device=dev)
    rhs_corr = torch.zeros((D,), dtype=dt, device=dev)
    Bp_l, gp_l = [], []
    for c0 in range(0, P, ch):
        tab_c = track_tab[c0 : c0 + ch]
        validL = tab_c >= 0
        safe = torch.where(validL, tab_c, torch.zeros_like(tab_c))
        wL = validL.to(dt)
        Jp_t = Jp[safe] * wL[..., None, None]
        r_t = r[safe] * wL[..., None]
        Hpp_c = torch.einsum("plai,plaj->pij", Jp_t, Jp_t)
        gp_c = torch.einsum("plai,pla->pi", Jp_t, r_t)
        diag3 = torch.clamp(torch.diagonal(Hpp_c, dim1=-2, dim2=-1), min=1e-8)
        Bp_c = _inv3x3(Hpp_c + lam * torch.diag_embed(diag3))
        Wc_t = Wc[safe] * wL[..., None, None]
        Wi_t = Wi[safe] * wL[..., None, None]
        oh_s2 = torch.nn.functional.one_hot(obs_shot[safe].long(), n_shots).to(dt)
        oh_c2 = torch.nn.functional.one_hot(obs_cam[safe].long(), n_cams).to(dt)
        U_pose = torch.einsum("plij,pls->pisj", Wc_t, oh_s2).reshape(-1, 3, n_shots * 6)
        U_intr = torch.einsum("plij,plc->picj", Wi_t, oh_c2).reshape(-1, 3, n_cams * 7)
        U = torch.cat([U_pose, U_intr], dim=-1)  # (CH, 3, D)
        BU = torch.einsum("pab,pbd->pad", Bp_c, U)
        S_corr = S_corr + torch.einsum("pad,pae->de", U, BU)
        rhs_corr = rhs_corr + torch.einsum(
            "pad,pa->d", U, torch.einsum("pab,pb->pa", Bp_c, gp_c)
        )
        Bp_l.append(Bp_c)
        gp_l.append(gp_c)
    Bp = torch.cat(Bp_l)
    gp = torch.cat(gp_l)
    S_red, rhs_red, cost = _reduced_system(Hcc, g_full, S_corr, rhs_corr, cost, lam, reduce)

    def backsub(dcam):
        dpose = dcam[: 6 * n_shots].reshape(n_shots, 6)
        dintr = dcam[6 * n_shots :].reshape(n_cams, 7)
        validL = track_tab >= 0
        safe = torch.where(validL, track_tab, torch.zeros_like(track_tab))
        contrib = (
            torch.einsum("plij,plj->pli", Wc[safe], dpose[obs_shot[safe]])
            + torch.einsum("plij,plj->pli", Wi[safe], dintr[obs_cam[safe]])
        ) * validL.to(dt)[..., None]
        dX = -torch.einsum("pab,pb->pa", Bp, gp + torch.sum(contrib, dim=1))
        return dX, dpose, dintr

    return S_red, rhs_red, backsub, cost


# ------------------------------------------------------------ dense (P, S)
def compute_residuals_dense(points, poses, intr, cam_of_shot, uv_ps, w_ps):
    """Residuals on the dense grid: r (P, S, 2) weighted, and the cost."""
    uv, _ = project_points(poses, intr[cam_of_shot], points[None])  # (S, P, 2)
    r = (uv.transpose(0, 1) - uv_ps) * w_ps[..., None]
    return r, 0.5 * torch.sum(r * r)


def _res_cam(v, uv, w):
    """Weighted pixel residual of one camera-frame point v = [xc(3) | intr(7)]."""
    xc, k = v[:3], v[3:]
    z = torch.where(xc[2] == 0, torch.full_like(xc[2], 1e-12), xc[2])
    xy_d = distort_normalized(k, xc[:2] / z)
    return (normalized_to_pixels(k, xy_d) - uv) * w


def _dense_jacobians(points, poses, intr, cam_of_shot, uv_ps, w_ps):
    """Per-slot Jacobians on the (P, S) grid, point-minor: Jp (2,3,S,P),
    Jc (2,6,S,P), Ji (2,7,S,P), r (2,S,P).

    Short chain rule: the rotation is per shot, so dXc/daa = (dR/daa) X is
    formed per shot and the per-slot forward-mode Jacobian covers only the
    camera-frame projection over 10 inputs (Xc 3 | intr 7):
    dres/dX = dres/dXc R_s, dres/dt = dres/dXc, dres/daa = dres/dXc dXc/daa."""
    P, S = w_ps.shape
    K_s = intr[cam_of_shot]  # (S, 7)
    R_s = aa_to_rotmat(poses[:, :3])  # (S, 3, 3)
    # (forward-mode AD of 0-dim intermediates can promote to float64: cast back)
    dR = vmap(jacfwd(aa_to_rotmat))(poses[:, :3]).to(poses.dtype)  # (S, 3, 3, 3)
    X_T = points.T  # (3, P)
    Xc = sum(R_s[:, :, b].T[:, :, None] * X_T[b][None, None] for b in range(3)) \
        + poses[:, 3:].T[:, :, None]  # (3, S, P)
    dXc_daa = sum(
        dR[:, :, b, :].permute(1, 2, 0)[:, :, :, None] * X_T[b][None, None, None]
        for b in range(3)
    )  # (3 cam-coord, 3 aa, S, P)

    v = torch.cat([Xc, K_s.T[:, :, None].expand(7, S, P)], dim=0).reshape(10, S * P)
    uv_f = uv_ps.permute(2, 1, 0).reshape(2, S * P)
    w_f = w_ps.T.reshape(S * P)
    # dead slots (w == 0) may hold points at z ~ 0 whose Jacobian overflows;
    # evaluate them at a benign input — their weighted rows are zero anyway
    # (fill_, not a set from a host scalar: a CUDA graph captures no host copy)
    benign = torch.zeros((10, 1), dtype=v.dtype, device=v.device)
    benign[2:4].fill_(1.0)
    v = torch.where((w_f > 0)[None, :], v, benign)
    r = vmap(_res_cam, in_dims=(1, 1, 0), out_dims=1)(v, uv_f, w_f)  # (2, S*P)
    Jv = vmap(jacfwd(_res_cam), in_dims=(1, 1, 0), out_dims=2)(v, uv_f, w_f).to(v.dtype)
    J_xc = Jv[:, :3].reshape(2, 3, S, P)
    Ji = Jv[:, 3:].reshape(2, 7, S, P)
    Jp = sum(J_xc[:, b, None] * R_s[:, b, :].T[None, :, :, None] for b in range(3))
    Jc_rot = sum(J_xc[:, b, None] * dXc_daa[b][None] for b in range(3))
    Jc = torch.cat([Jc_rot, J_xc], dim=1)  # (2, 6, S, P)
    return Jp, Jc, Ji, r.reshape(2, S, P)


def _inv3x3_pm(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse of point-minor (3, 3, P) stacks."""
    return _inv3x3(M.permute(2, 0, 1)).permute(1, 2, 0)


def ba_build_dense(points, poses, intr, cam_of_shot, uv_ps, w_ps, lam, intr_mask,
                   pose_free, n_shots, n_cams, reduce=None):
    """Schur-reduced camera system on the dense (P, S) grid. Returns
    (S_red, rhs, back-substitution closure, cost); `reduce` as in
    _reduced_system."""
    dt = points.dtype
    Jp, Jc, Ji, r = _dense_jacobians(points, poses, intr, cam_of_shot, uv_ps, w_ps)
    Ji = Ji * intr_mask[cam_of_shot].T[None, :, :, None]
    Jc = Jc * pose_free[None, None, :, None]
    cost = 0.5 * torch.sum(r * r)

    Hcc_pose = torch.einsum("lisp,ljsp->sij", Jc, Jc)
    Hcc_cross = torch.einsum("lisp,ljsp->sij", Jc, Ji)
    gc = torch.einsum("lisp,lsp->si", Jc, r)
    oh_cam = torch.nn.functional.one_hot(cam_of_shot.long(), n_cams).to(dt)
    Hcc_intr = torch.einsum("lisp,ljsp,sc->cij", Ji, Ji, oh_cam)
    gi = torch.einsum("lisp,lsp,sc->ci", Ji, r, oh_cam)
    Hcc = _camera_blocks(Hcc_pose, Hcc_cross, Hcc_intr, cam_of_shot, n_shots, n_cams)
    g_full = torch.cat([gc.reshape(-1), gi.reshape(-1)])

    hpp = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a, 3):
            hpp[a][b] = torch.sum(Jp[:, a] * Jp[:, b], dim=(0, 1))
            hpp[b][a] = hpp[a][b]
    Hpp = torch.stack([torch.stack(row) for row in hpp])  # (3, 3, P)
    gp = torch.stack([torch.sum(Jp[:, a] * r, dim=(0, 1)) for a in range(3)])  # (3, P)
    diag3 = torch.clamp(torch.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]]), min=1e-8)
    eye3 = torch.eye(3, dtype=dt, device=points.device)
    Bp = _inv3x3_pm(Hpp + lam * torch.einsum("ab,bp->abp", eye3, diag3))

    UP = sum(Jp[l][:, None] * Jc[l][None] for l in range(2))  # (3, 6, S, P)
    U_pose = UP.permute(0, 2, 1, 3).reshape(3, n_shots * 6, -1)
    UI = sum(Jp[l][:, None] * Ji[l][None] for l in range(2))  # (3, 7, S, P)
    if n_cams == 1:
        U_intr = torch.sum(UI, dim=2).reshape(3, 7, -1)
    else:
        U_intr = torch.einsum("ajsp,sc->acjp", UI, oh_cam).reshape(3, n_cams * 7, -1)
    U = torch.cat([U_pose, U_intr], dim=1)  # (3, D, P)
    BU = torch.einsum("abp,bdp->adp", Bp, U)
    S_corr = torch.einsum("adp,aep->de", U, BU)
    rhs_corr = torch.einsum("adp,ap->d", U, torch.einsum("abp,bp->ap", Bp, gp))
    S_red, rhs_red, cost = _reduced_system(Hcc, g_full, S_corr, rhs_corr, cost, lam, reduce)

    def backsub(dcam):
        dpose = dcam[: 6 * n_shots].reshape(n_shots, 6)
        dintr = dcam[6 * n_shots :].reshape(n_cams, 7)
        hpc_dc = torch.einsum("adp,d->ap", U, dcam)
        dX = -torch.einsum("abp,bp->ap", Bp, gp + hpc_dc)
        return dX.T, dpose, dintr

    return S_red, rhs_red, backsub, cost


# --------------------------------------------------------------- LM driver
def run_bundle_adjustment(
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
    device: torch.device | str | None = None,
) -> dict:
    """LM bundle adjustment. Inputs are host numpy arrays; the work runs in
    `dtype` on `device` (default: the card; raises without one). Optimises every
    point, every pose with pose_free = 1 and the unmasked intrinsics, like
    BundleAdjustment::doBundleAdjustment. Returns the updated arrays (in
    the input dtypes) and cost, iterations, converged, lambda, table_kind."""
    from sfm_mvs_pipeline_tpu_torch import resolve_device

    dev = resolve_device(device)
    n_shots = poses.shape[0]
    P = points.shape[0]
    grid = None
    if P * n_shots <= DENSE_GRID_MAX_SLOTS:
        grid = pack_dense_obs(obs_point, obs_shot, obs_uv, obs_w, P, n_shots)
    tab = build_track_table(obs_point, obs_w, P) if grid is None else None
    pts, pos, K, cost, it, conv, lam, table_kind = lm_solve(
        points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w, intr_mask,
        pose_free, grid, tab, config, dtype, dev)
    return {
        "points": pts.cpu().numpy().astype(points.dtype),
        "poses": pos.cpu().numpy().astype(poses.dtype),
        "intrinsics": K.cpu().numpy().astype(intr.dtype),
        "cost": float(cost),
        "iterations": it,
        "converged": bool(conv),
        "lambda": float(lam),
        "table_kind": table_kind,
    }


def lm_solve(points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w, intr_mask,
             pose_free, grid, track_tab, config, dtype, dev, reduce=None):
    """The LM loop of run_bundle_adjustment on host arrays: the dense layout
    when `grid` = pack_dense_obs(...) is given, else the track layout on
    `track_tab`. `reduce` (None on one rank) sums a tensor over the ranks:
    the sharded path passes it so every build and every cost sums the ranks'
    point shards before damping and before the accept test (parallel/ba.py).

    Each iteration is one call of a step that updates the device state
    (points, poses, intrinsics, cost, lambda, converged, done) in place,
    then one host read of `done`. Where _graph_engages (a CUDA device, no
    `reduce`, the device solver) the step is captured as one CUDA graph at
    the first iteration and every iteration replays it; elsewhere the loop
    calls it eagerly. Returns device tensors (points, poses, intrinsics,
    cost), iterations, converged, lambda and the table kind; the iterations
    also go to the "lm iterations" counter and, on the graph route, to
    "ba graph iterations" (utils/stage_timer.py)."""
    cfg = config or BAConfig()
    if cfg.solver not in ("device", "host"):
        raise ValueError(f"unknown BA solver {cfg.solver!r} (expected device|host)")
    n_shots = poses.shape[0]
    n_cams = intr.shape[0]
    table_kind = "dense" if grid is not None else "track"

    def T(x, d=dtype):  # a copy: the state is updated in place
        return torch.tensor(np.asarray(x), dtype=d, device=dev)

    pts = T(points)
    pos = T(poses)
    K = T(intr)
    cams = T(cam_of_shot, torch.int64)
    imask = T(intr_mask)
    pfree = T(pose_free if pose_free is not None else np.ones(n_shots))
    if grid is not None:
        uv_ps, w_ps = T(grid[0]), T(grid[1])

        def local_cost(p, q, k):
            return compute_residuals_dense(p, q, k, cams, uv_ps, w_ps)[1]

        def build(p, q, k, lam):
            return ba_build_dense(p, q, k, cams, uv_ps, w_ps, lam, imask, pfree, n_shots, n_cams,
                                  reduce)
    else:
        op, os_ = T(obs_point, torch.int64), T(obs_shot, torch.int64)
        ouv, ow = T(obs_uv), T(obs_w)
        tab = T(track_tab, torch.int64)

        def local_cost(p, q, k):
            return compute_residuals(p, q, k, cams, op, os_, ouv, ow)[1]

        def build(p, q, k, lam):
            return ba_build_track(
                p, q, k, cams, op, os_, ouv, ow, tab, lam, imask, pfree, n_shots, n_cams, reduce
            )

    def residual_cost(p, q, k):
        c = local_cost(p, q, k)
        return c if reduce is None else reduce(c.reshape(1))[0]

    solve = equilibrated_cholesky_solve if cfg.solver == "device" else _host_solve

    cost = residual_cost(pts, pos, K)
    lam = torch.as_tensor(cfg.init_lambda, dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        """One LM iteration, in place on (pts, pos, K, cost, lam, conv, done)."""
        S_red, rhs, backsub, _ = build(pts, pos, K, lam)
        dX, dpose, dintr = backsub(solve(S_red, rhs))
        new_pts = pts + dX
        new_pos = pos + dpose * pfree[:, None]
        new_K = K + dintr * imask
        new_cost = residual_cost(new_pts, new_pos, new_K)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-30)
        step_conv = accept & (rel < cfg.function_tolerance)
        new_lam = torch.where(
            accept, torch.clamp(lam * cfg.lambda_down, min=cfg.min_lambda), lam * cfg.lambda_up
        )
        done.copy_(step_conv | (~accept & (new_lam > cfg.max_lambda)))
        for old, new in ((pts, new_pts), (pos, new_pos), (K, new_K), (cost, new_cost)):
            old.copy_(torch.where(accept, new, old))
        lam.copy_(new_lam)
        conv.bitwise_or_(step_conv)

    graph = StepGraph(step, dev, _warm_cholesky) if _graph_engages(dev, reduce, cfg) else None
    run = step if graph is None else graph
    it = 0
    try:
        while it < cfg.max_iterations:
            run()
            it += 1
            if bool(done):  # the loop's one host read: the stop test
                break
    finally:
        if graph is not None:
            graph.close()
    count("lm iterations", it)
    if graph is not None:
        count("ba graph iterations", it)
    return pts, pos, K, cost, it, conv, lam, table_kind


# ------------------------------------------------------ the step as a graph
def _graph_engages(dev, reduce, cfg: BAConfig) -> bool:
    """Whether lm_solve replays its step as a CUDA graph: on a CUDA device,
    on one rank (the sharded route's `reduce` stays eager) and with the
    device solver (the host solver reads the host by design)."""
    return torch.device(dev).type == "cuda" and reduce is None and cfg.solver == "device"


def _warm_cholesky() -> None:
    """The cuBLAS and cuSOLVER handles and workspaces of the device solver
    (equilibrated_cholesky_solve), made eagerly on the current stream."""
    eye = torch.eye(2, device=torch.cuda.current_device())
    torch.linalg.solve_triangular(torch.linalg.cholesky_ex(eye)[0], eye @ eye, upper=False)
