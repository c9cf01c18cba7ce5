"""Rectified pairwise disparity sweep: the default `rect` dense engine.

Port of sfm_mvs_pipeline_tpu/mvs/rectified.py. After rotating both cameras
of a pair onto the baseline (Fusiello rectification, world frame):
  e1 = (C_n - C_r)/b          new x-axis: the baseline
  e2 = normalize(r3 x e1)     r3 = ref optical axis (3rd row of R_r)
  e3 = e1 x e2
  R_R = [e1; e2; e3]          world -> rectified axes (shared orientation)
every depth hypothesis is a constant-disparity shift (u_n = u_r - f*b/z).
Per disparity level the neighbour image is shifted (integer part) and lerped
(fractional part) and scored with ZNCC over a box window, as in the plane
sweep; the per-pair WTA result is warped back to the reference frame and
the neighbours vote in `consensus_fuse`.

Degenerate pairs (baseline within ~18 deg of the optical axis, or near
zero) are masked out (cost 1, invalid), like the JAX package.

--sgm aggregates the rectified disparity volume (mvs/sgm.py): below
STAGED_SGM_MIN_PIXELS through `sgm_aggregate` (kernel K2a), at or above it
through the memory-staged route `sgm_staged_hwd` (kernel K2b), which rounds
the cost to bf16 and lets the WTA read the unnormalised 4-path sum, then
divide by 4. The JAX package takes the staged route only on its TPU backend
(a 16 GB-HBM workaround); the port takes it on every device above the same
size, so it computes what the JAX package computes on its accelerator.

Layout: the level volume is (D, H, W) as in the JAX package; the level
sweep runs in chunks of levels (plane_sweep.level_chunks). On the staged
route its storage is (H, W, D), so the sweep's writes lay out the volume
that K2b reads and no transposing copy sits between them.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_mvs_pipeline_tpu_torch.models.cameras import intrinsics_to_K
from sfm_mvs_pipeline_tpu_torch.mvs.plane_sweep import (
    _bilinear_hw,
    dehomogenize,
    level_chunks,
    pixel_grid,
    refine_inverse,
    window_stats,
    zncc_cost,
)
from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat
from sfm_mvs_pipeline_tpu_torch.utils.stage_timer import stage

# image size (H * W) from which --sgm takes the staged route (kernel K2b);
# a 1920x1080 image (2,073,600 px) is above it
STAGED_SGM_MIN_PIXELS = 2_000_000


def _homography_warp(img: torch.Tensor, Hinv: torch.Tensor):
    """Inverse-warp img through homography H (dst->src = Hinv): returns
    (warped (H, W), inside (H, W))."""
    h, w = img.shape
    sx, sy = dehomogenize(Hinv @ pixel_grid(h, w, img.dtype, img.device), h, w)
    return _bilinear_hw(img, sx, sy)


def rect_frame(ref_img, nbr_img, pose_r, pose_n, intr) -> dict:
    """Shared Fusiello rectification setup for one (ref, nbr) pair: the
    rectified images + masks and the frame geometry."""
    dt = ref_img.dtype
    K = intrinsics_to_K(intr).to(dt)
    Kinv = torch.linalg.inv(K)

    R_r = aa_to_rotmat(pose_r[:3]).to(dt)
    R_n = aa_to_rotmat(pose_n[:3]).to(dt)
    C_r = -R_r.T @ pose_r[3:].to(dt)
    C_n = -R_n.T @ pose_n[3:].to(dt)
    base = C_n - C_r
    b = torch.linalg.norm(base)
    ok_b = b > 1e-9
    e1 = base / torch.clamp(b, min=1e-12)
    r3 = R_r[2]  # ref optical axis in world
    # degenerate when baseline ~ parallel to the optical axis
    c2 = torch.linalg.cross(r3, e1)
    n2 = torch.linalg.norm(c2)
    ok_geom = ok_b & (n2 > 0.3)  # sin of axis/baseline angle > ~17 deg
    e2 = c2 / torch.clamp(n2, min=1e-12)
    e3 = torch.linalg.cross(e1, e2)
    R_R = torch.stack([e1, e2, e3])  # world -> rectified axes

    # homographies pixel_ref -> pixel_rect and pixel_nbr -> pixel_rect
    H_ref = K @ R_R @ R_r.T @ Kinv
    H_nbr = K @ R_R @ R_n.T @ Kinv
    ref_rect, in_r = _homography_warp(ref_img, torch.linalg.inv(H_ref))
    nbr_rect, in_n = _homography_warp(nbr_img, torch.linalg.inv(H_nbr))
    return {
        "K": K, "Kinv": Kinv, "R_r": R_r, "R_R": R_R, "b": b,
        "ok_geom": ok_geom, "H_ref": H_ref,
        "ref_rect": ref_rect, "in_r": in_r,
        "nbr_rect": nbr_rect, "in_n": in_n,
    }


def rect_back_to_ref(iz_rect, cmin, val_rect, H_ref, Kinv, R_r, R_R, ok_geom, h, w):
    """Warp a rectified-frame inverse-depth result back to the REFERENCE
    frame. For ref pixel p its rect pixel is q = H_ref p; the 3D point is
    X1 = z_rect K^-1 q, and the ref-frame depth is the 3rd coord of
    R_r R_R^T X1. Returns (z_ref (H, W), cost_ref, valid)."""
    dt = iz_rect.dtype
    qx, qy = dehomogenize(H_ref @ pixel_grid(h, w, dt, iz_rect.device), h, w)
    iz_ref, q_in = _bilinear_hw(iz_rect, qx, qy)
    vmap_f, _ = _bilinear_hw(val_rect.to(dt), qx, qy)
    cost_ref, _ = _bilinear_hw(cmin, qx, qy)

    z_rect = 1.0 / torch.clamp(iz_ref, min=1e-9)
    qn = torch.stack([qx, qy, torch.ones_like(qx)], 0).reshape(3, -1)
    X1 = (Kinv @ qn) * z_rect.reshape(-1)[None]
    z_ref = ((R_r @ R_R.T) @ X1)[2].reshape(h, w)

    valid = q_in & (vmap_f > 0.999) & (z_ref > 1e-6) & ok_geom
    return z_ref, cost_ref, valid


def _shift_x(pad: torch.Tensor, shift_int: torch.Tensor, maxd: int, w: int) -> torch.Tensor:
    """out[k, y, x] = img[y, x - shift_int[k]] from the pre-padded
    (H, maxd + W) buffer, for a batch of integer shifts (k,). The slice
    start is clamped into [0, maxd] like the JAX package's dynamic_slice."""
    start = (maxd - shift_int).clamp(0, maxd)
    cols = start[:, None] + torch.arange(w, device=pad.device)[None]  # (k, W)
    return pad[:, cols].permute(1, 0, 2)  # (k, H, W)


def _linspace(start: torch.Tensor, stop: torch.Tensor, n: int) -> torch.Tensor:
    """jnp.linspace's float arithmetic: start*(1-t) + stop*t, exact ends."""
    if n == 1:
        return start.reshape(1)
    t = torch.arange(n - 1, dtype=start.dtype, device=start.device) / (n - 1)
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def rectified_pair_depth(
    ref_img: torch.Tensor,  # (H, W) grayscale f32
    nbr_img: torch.Tensor,  # (H, W)
    pose_r: torch.Tensor,  # (6,) world->cam angle-axis|t
    pose_n: torch.Tensor,
    intr: torch.Tensor,  # (7,) pinhole intrinsics at this resolution
    z_min: float,
    z_max: float,
    n_levels: int = 96,
    window_radius: int = 3,
    max_cost: float = 0.4,
    max_disp: int = 256,
    use_sgm: bool = False,
    sgm_p1: float = 0.03,
    sgm_p2: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-pair rectified disparity sweep.

    Returns (depth (H, W), cost (H, W), valid (H, W)) in the REFERENCE
    view's frame (depth along the ref optical axis), the contract of
    plane_sweep.wta_depth. max_disp bounds the shift buffer; level
    disparities are clipped into it.
    """
    h, w = ref_img.shape
    dt = ref_img.dtype
    dev = ref_img.device
    with stage("rect sweep"):
        fr = rect_frame(ref_img, nbr_img, pose_r, pose_n, intr)
        ref_rect, in_r = fr["ref_rect"], fr["in_r"]
        nbr_rect, in_n = fr["nbr_rect"], fr["in_n"]

        f = intr[0].to(dt)
        iz = _linspace(1.0 / torch.as_tensor(z_max, dtype=dt, device=dev),
                       1.0 / torch.as_tensor(z_min, dtype=dt, device=dev), n_levels)
        disps = torch.clamp(f * fr["b"] * iz, 0.0, float(max_disp))

        r_mean, r_var = window_stats(ref_rect, window_radius)
        nbr_val = torch.where(in_n, nbr_rect, torch.zeros_like(nbr_rect))
        pad_img = torch.nn.functional.pad(nbr_val, (max_disp, 0))
        pad_in = torch.nn.functional.pad(in_n.to(dt), (max_disp, 0))

        staged = use_sgm and h * w >= STAGED_SGM_MIN_PIXELS
        if staged:  # (H, W, D) storage, as K2b reads it; cv is its (D, H, W) view
            cv = torch.empty((h, w, n_levels), dtype=dt, device=dev).permute(2, 0, 1)
        else:
            cv = torch.empty((n_levels, h, w), dtype=dt, device=dev)  # RECTIFIED frame
        for sl in level_chunks(n_levels, h, w):
            d = disps[sl]
            di = torch.floor(d).long()
            frac = (d - di.to(dt))[:, None, None]
            s0 = _shift_x(pad_img, di, max_disp, w)
            s1 = _shift_x(pad_img, di + 1, max_disp, w)
            m0 = _shift_x(pad_in, di, max_disp, w)
            m1 = _shift_x(pad_in, di + 1, max_disp, w)
            warped = (1 - frac) * s0 + frac * s1
            inside = (m0 * m1) > 0.5
            cost = zncc_cost(ref_rect, warped, r_mean, r_var, window_radius)
            cv[sl] = torch.where(inside & in_r, cost, torch.ones_like(cost))

    dim = 0
    scale = 1.0
    if staged:
        from sfm_mvs_pipeline_tpu_torch.ops.kernels.sgm_kernel import sgm_staged_hwd

        with stage("sgm"):
            # unnormalised 4-path sum (H, W, D); /4 applied after each read
            cv = sgm_staged_hwd(cv.permute(1, 2, 0), sgm_p1, sgm_p2)
        dim, scale = -1, 4.0
    elif use_sgm:
        from sfm_mvs_pipeline_tpu_torch.mvs.sgm import sgm_aggregate

        with stage("sgm"):
            cv = sgm_aggregate(cv, sgm_p1, sgm_p2)

    with stage("rect sweep"):
        # WTA + parabola refinement over inverse depth (as wta_depth)
        d_idx = torch.argmin(cv, dim=dim)
        cmin = cv.min(dim=dim).values
        if scale != 1.0:
            cmin = cmin / scale
        iz_rect, interior = refine_inverse(cmin, d_idx, cv, iz, dim=dim, scale=scale)
        val_rect = (cmin <= max_cost) & interior & fr["ok_geom"]
        return rect_back_to_ref(iz_rect, cmin, val_rect, fr["H_ref"], fr["Kinv"], fr["R_r"],
                                fr["R_R"], fr["ok_geom"], h, w)


def derive_max_disp(
    pose_r,  # (6,) numpy
    poses_n,  # (N, 6) numpy
    focal: float,
    z_min: float,
    width: int,
    floor: int = 256,
) -> int:
    """Host-side static disparity bound for rectified_pair_depth: the
    largest disparity any level can need, f * max-baseline / z_min, with 5%
    headroom, rounded up to a power of two from `floor`, capped at the image
    width rounded up to 128."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np as _aa

    pose_r = np.asarray(pose_r, np.float64)
    poses_n = np.atleast_2d(np.asarray(poses_n, np.float64))
    R_r = _aa(pose_r[:3])
    C_r = -R_r.T @ pose_r[3:]
    b_max = 0.0
    for pn in poses_n:
        R_n = _aa(pn[:3])
        C_n = -R_n.T @ pn[3:]
        b_max = max(b_max, float(np.linalg.norm(C_n - C_r)))
    need = 1.05 * float(focal) * b_max / max(float(z_min), 1e-9)
    cap = int(np.ceil(width / 128.0) * 128)
    d = floor
    while d < min(need, cap):
        d *= 2
    return int(min(d, cap))


def rect_geometry_ok(
    pose_r,  # (6,) numpy angle-axis|t
    poses_n,  # (N, 6) numpy
    min_sin: float = 0.31,
):
    """Host-side replica of rectified_pair_depth's degeneracy gate: True for
    neighbours whose baseline is usable for rectification (non-zero and at
    least ~18 deg off the ref optical axis). The threshold is stricter
    (0.31) than the in-engine f32 gate (0.3), so host-pass implies
    device-pass."""
    from sfm_mvs_pipeline_tpu_torch.ops.pose import aa_to_rotmat_np as _aa

    pose_r = np.asarray(pose_r, np.float64)
    poses_n = np.atleast_2d(np.asarray(poses_n, np.float64))
    R_r = _aa(pose_r[:3])
    C_r = -R_r.T @ pose_r[3:]
    ok = np.zeros(len(poses_n), bool)
    for i, pn in enumerate(poses_n):
        R_n = _aa(pn[:3])
        C_n = -R_n.T @ pn[3:]
        base = C_n - C_r
        b = np.linalg.norm(base)
        if b <= 1e-9:
            continue
        sin_ang = np.linalg.norm(np.cross(R_r[2], base / b))
        ok[i] = sin_ang > min_sin
    return ok


def consensus_fuse(
    depths: torch.Tensor,  # (N, H, W) per-neighbor ref-frame depths
    costs: torch.Tensor,  # (N, H, W)
    valids: torch.Tensor,  # (N, H, W) bool
    rel_tol: float = 0.02,
    min_support: int = 2,
    max_cost: float = 0.4,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-neighbour consensus: per pixel pick the depth supported by the
    most neighbours (within rel_tol), averaging the supporters. Returns
    (depth, cost, valid)."""
    n = depths.shape[0]
    big = torch.tensor(1e30, dtype=depths.dtype, device=depths.device)
    d = torch.where(valids, depths, big)
    # one candidate row at a time keeps the peak at (N, H, W)
    support = torch.stack(
        [
            ((torch.abs(d - d[i][None]) <= rel_tol * d[i][None]) & valids
             & valids[i][None]).sum(dim=0)
            for i in range(n)
        ]
    )  # (N, H, W)
    # prefer max support, tie-break on cost
    score = support.to(depths.dtype) * 1e3 - costs
    best = torch.argmax(torch.where(valids, score, -big), dim=0)[None]  # (1, H, W)

    d_best = torch.gather(d, 0, best)[0]  # the winner's depth
    valid_b = torch.gather(valids, 0, best)[0]
    # supporters of the winner (the winner's own row of `close`)
    close_b = (torch.abs(d - d_best[None]) <= rel_tol * d_best[None]) & valids & valid_b[None]
    wsum = torch.where(close_b, depths, torch.zeros_like(depths)).sum(dim=0)
    wcnt = close_b.sum(dim=0)
    depth = wsum / torch.clamp(wcnt, min=1)
    cost = torch.gather(costs, 0, best)[0]
    n_valid = valids.any(dim=0)
    need = torch.clamp(valids.sum(dim=0), min=1).clamp(max=min_support)
    valid = n_valid & (wcnt >= need) & (cost <= max_cost)
    return depth, cost, valid


def rectified_depth(
    ref_img: torch.Tensor,  # (H, W)
    nbr_imgs: torch.Tensor,  # (N, H, W)
    pose_r: torch.Tensor,
    poses_n: torch.Tensor,  # (N, 6)
    intr: torch.Tensor,
    z_min: float,
    z_max: float,
    n_levels: int = 96,
    window_radius: int = 3,
    max_cost: float = 0.4,
    max_disp: int = 256,
    nbr_valid=None,  # (N,) bool, host array or list
    use_sgm: bool = False,
    sgm_p1: float = 0.03,
    sgm_p2: float = 0.3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-neighbour rectified depth for one reference view: per-pair
    rectified sweeps + cross-neighbour consensus (depth, cost, valid in the
    ref frame).

    Padded neighbour slots (nbr_valid False) are not computed: the JAX
    package computes them for fixed shapes and then masks them to cost 1
    and invalid, which leaves them no influence on the consensus; here they
    are filled with exactly those values."""
    n = nbr_imgs.shape[0]
    ok = [True] * n if nbr_valid is None else [bool(x) for x in np.asarray(nbr_valid)]
    h, w = ref_img.shape
    depths, costs, valids = [], [], []
    for j in range(n):
        if not ok[j]:
            depths.append(torch.zeros((h, w), dtype=ref_img.dtype, device=ref_img.device))
            costs.append(torch.ones_like(depths[-1]))
            valids.append(torch.zeros((h, w), dtype=torch.bool, device=ref_img.device))
            continue
        d, c, v = rectified_pair_depth(
            ref_img, nbr_imgs[j], pose_r, poses_n[j], intr, z_min, z_max,
            n_levels=n_levels, window_radius=window_radius,
            max_cost=max_cost, max_disp=max_disp,
            use_sgm=use_sgm, sgm_p1=sgm_p1, sgm_p2=sgm_p2,
        )
        depths.append(d)
        costs.append(c)
        valids.append(v)
    with stage("consensus"):
        return consensus_fuse(torch.stack(depths), torch.stack(costs), torch.stack(valids),
                              max_cost=max_cost, min_support=2)
